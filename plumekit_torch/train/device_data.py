"""The whole training set resident in the card's memory
(``plumekit/train/device_data.py``): tiles are drawn and augmented on the
device, and a step reads nothing from the host but its index.

The draw mirrors ``data._draw_tile``: a uniform granule; with probability
0.5, when the granule has plume pixels, an origin centred on a uniform
plume pixel and jittered by ±8 px; else a uniform origin; clipped to the
granule's valid extent. Its random values come from a ``torch.Generator``
seeded by (seed, step) (:func:`plumekit_torch.train.step.step_generator`),
so the schedule is counter-based and resume-stable, as in the JAX package,
but it is a different sequence from the JAX package's ``jax.random`` draws
and from the host iterator's numpy draws. The draw is split into
:func:`draw_values` (the random values) and :func:`tiles_from_draws` (the
clip-and-slice rule), so the rule can be checked with given values.
With ``quantized`` the set is stored as uint16 channels (int16 bits) with
per-granule ``lo``/``scale`` and uint8 masks, and each drawn tile is
dequantized on the device after the gather, so only the live tiles are
ever float32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from plumekit_torch.ops.quant import dequantize, quantize_uint16, uint16_bits
from plumekit_torch.train.step import make_train_step, step_generator


class DeviceDataset(NamedTuple):
    """The resident training set. Granules are edge-padded to at least one
    tile, as ``_prep_samples`` pads them, then zero-padded to a common
    (H, W); ``heights`` / ``widths`` keep each granule's valid extent."""

    #: (N, H, W, C) float32, or int16 holding uint16 codes (see ``lo``)
    channels: torch.Tensor
    #: (N, H, W) float32 in [0, 1], or uint8 (1 is 255) when quantized
    masks: torch.Tensor
    #: (N, P) plume-pixel coordinates (padded with 0) and (N,) valid counts
    plume_rows: torch.Tensor
    plume_cols: torch.Tensor
    plume_count: torch.Tensor
    #: (N,) valid (edge-padded) extents per granule
    heights: torch.Tensor
    widths: torch.Tensor
    #: (N, C) affine decode parameters of quantized channels, else None
    lo: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None


class Draws(NamedTuple):
    """One batch's random values, each (B,) on the dataset's device:
    granule index, whether to centre on a plume pixel, and uniforms in
    [0, 1) for the plume pixel and the two uniform origin coordinates, plus
    the jitters in [-8, 8]."""

    granule: torch.Tensor
    plume: torch.Tensor
    u_pixel: torch.Tensor
    jy: torch.Tensor
    jx: torch.Tensor
    u_y: torch.Tensor
    u_x: torch.Tensor


def build_device_dataset(samples: List, tile: int, device,
                         quantized: bool = False) -> DeviceDataset:
    """Assemble GranuleSamples into one stack on ``device``; ``quantized``
    stores it in the uint16/uint8 codes of ``ops/quant`` (a third of the
    bytes; channel error at most range/131070, masks exact)."""
    if not samples:
        raise ValueError("build_device_dataset got an empty sample list")
    padded = []
    for s in samples:
        ch, mask = s.channels, np.asarray(s.mask, np.float32)
        h, w = ch.shape[:2]
        if h < tile or w < tile:
            ph, pw = max(0, tile - h), max(0, tile - w)
            ch = np.pad(ch, ((0, ph), (0, pw), (0, 0)), mode="edge")
            mask = np.pad(mask, ((0, ph), (0, pw)))
        padded.append((ch.astype(np.float32), mask))
    hs = np.array([c.shape[0] for c, _ in padded], np.int64)
    ws = np.array([c.shape[1] for c, _ in padded], np.int64)
    H, W = int(hs.max()), int(ws.max())
    C = padded[0][0].shape[-1]
    n = len(padded)

    chan = np.zeros((n, H, W, C), np.float32)
    msk = np.zeros((n, H, W), np.float32)
    rows, cols = [], []
    for i, (c, m) in enumerate(padded):
        chan[i, :c.shape[0], :c.shape[1]] = c
        msk[i, :m.shape[0], :m.shape[1]] = m
        ys, xs = np.nonzero(m > 0.5)
        rows.append(ys)
        cols.append(xs)
    pmax = max(1, max(len(r) for r in rows))
    prow = np.zeros((n, pmax), np.int64)
    pcol = np.zeros((n, pmax), np.int64)
    pcnt = np.zeros((n,), np.int64)
    for i, (r, c) in enumerate(zip(rows, cols)):
        prow[i, :len(r)] = r
        pcol[i, :len(c)] = c
        pcnt[i] = len(r)

    lo = scale = None
    if quantized:
        q = np.empty((n, H, W, C), np.uint16)
        lo = np.empty((n, C), np.float32)
        scale = np.empty((n, C), np.float32)
        for i in range(n):
            q[i], lo[i], scale[i] = quantize_uint16(chan[i])
        chan = uint16_bits(q)
        msk = np.rint(np.clip(msk, 0.0, 1.0) * 255.0).astype(np.uint8)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return DeviceDataset(channels=put(chan), masks=put(msk),
                         plume_rows=put(prow), plume_cols=put(pcol),
                         plume_count=put(pcnt), heights=put(hs),
                         widths=put(ws), lo=put(lo), scale=put(scale))


def draw_values(ds: DeviceDataset, generator: torch.Generator,
                batch_size: int) -> Draws:
    """The random values of one batch, drawn on the generator's device."""
    dev = generator.device
    n = ds.channels.shape[0]

    def uniform():
        return torch.rand(batch_size, generator=generator, device=dev,
                          dtype=torch.float64)

    def jitter():
        return torch.randint(-8, 9, (batch_size,), generator=generator,
                             device=dev)

    return Draws(
        granule=torch.randint(0, n, (batch_size,), generator=generator,
                              device=dev),
        plume=uniform() < 0.5, u_pixel=uniform(), jy=jitter(), jx=jitter(),
        u_y=uniform(), u_x=uniform())


def _uniform_int(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """floor(u·n) in [0, n) for u in [0, 1) and integers n >= 1."""
    return torch.minimum((u * n).long(), n - 1)


def draw_origins(ds: DeviceDataset, draws: Draws, tile: int):
    """The clip rule of ``draw_tile_batch``: (granule, cy, cx), each (B,)."""
    i = draws.granule
    h, w = ds.heights[i], ds.widths[i]
    cnt = ds.plume_count[i]
    use_plume = draws.plume & (cnt > 0)
    p = _uniform_int(draws.u_pixel, torch.clamp_min(cnt, 1))
    cy_p = torch.clamp(ds.plume_rows[i, p] - tile // 2 + draws.jy,
                       torch.zeros_like(h), h - tile)
    cx_p = torch.clamp(ds.plume_cols[i, p] - tile // 2 + draws.jx,
                       torch.zeros_like(w), w - tile)
    cy_u = _uniform_int(draws.u_y, h - tile + 1)
    cx_u = _uniform_int(draws.u_x, w - tile + 1)
    return (i, torch.where(use_plume, cy_p, cy_u),
            torch.where(use_plume, cx_p, cx_u))


def tiles_from_draws(ds: DeviceDataset, draws: Draws, tile: int):
    """``draws`` → (xs (B, t, t, C), ys (B, t, t, 1)) float32, gathered on
    the device with no value read back to the host (and dequantized there
    when the set is quantized)."""
    i, cy, cx = draw_origins(ds, draws, tile)
    offs = torch.arange(tile, device=cy.device)
    rows = (cy[:, None] + offs)[:, :, None]        # (B, t, 1)
    cols = (cx[:, None] + offs)[:, None, :]        # (B, 1, t)
    g = i[:, None, None]
    xs, ys = ds.channels[g, rows, cols], ds.masks[g, rows, cols][..., None]
    if ds.lo is not None:
        xs = dequantize(xs, ds.lo[i][:, None, None, :],
                        ds.scale[i][:, None, None, :])
        ys = ys.to(torch.float32) * (1.0 / 255.0)
    return xs, ys


def draw_tile_batch(ds: DeviceDataset, generator: torch.Generator,
                    batch_size: int, tile: int):
    """One plume-biased batch: :func:`draw_values` then
    :func:`tiles_from_draws`."""
    return tiles_from_draws(ds, draw_values(ds, generator, batch_size), tile)


def make_device_multi_step(dice_weight: float = 0.5, augment: bool = True,
                           label_smooth: float = 0.0, seed: int = 0,
                           tile: int = 512, batch_size: int = 16,
                           group=None):
    """Returns ``multi(state, data, steps) -> (state, last_metrics)``: one
    optimizer step per global step index in ``steps``, each drawing and
    augmenting its batch on the device from :func:`step_generator` of
    (seed, step): the draws first, then the augmentation codes. With
    ``group`` (data parallelism, ``data`` replicated on every rank) each
    rank draws the values of the global batch of ``batch_size`` and
    gathers the tiles of its own part."""
    step = make_train_step(dice_weight, augment, label_smooth, group=group)
    part = slice(None)
    if group is not None:
        from plumekit_torch.parallel.data_parallel import rank_slice

        part = rank_slice(batch_size, group)

    def multi(state, data: DeviceDataset, steps):
        metrics = None
        for s in steps:
            generator = step_generator(seed, int(s), data.channels.device)
            draws = draw_values(data, generator, batch_size)
            xs, ys = tiles_from_draws(
                data, Draws(*(v[part] for v in draws)), tile)
            state, metrics = step(state, xs, ys, generator)
        return state, metrics

    return multi


__all__ = ["DeviceDataset", "Draws", "build_device_dataset", "draw_origins",
           "draw_tile_batch", "draw_values", "make_device_multi_step",
           "tiles_from_draws"]
