"""Training data of ``plumekit/train/data.py`` (numpy and scipy, as there):
granules → (AOD, fire density) channels with ground-truth or weak labels,
and the plume-biased tile stream.

The functions draw the same numpy sequences as the JAX package's, so the
same ``np.random.Generator`` gives the same tiles bit for bit. The weak
labeller is the port's ``rg.identify`` on the training device (on the card
it launches the CCL and label-count kernels). ``quantize_samples`` and
``tile_batches_quant`` are the quantized training transfers: granules
encoded once (uint16 channels with per-granule ``lo``/``scale``, uint8
masks), tiles drawn by the same sequence as ``tile_batches``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
from scipy import ndimage

from plumekit_torch.config.train import DataConfig
from plumekit_torch.io.granule import NULL_VALUE
from plumekit_torch.io.synthetic import SyntheticSceneConfig, make_scene


@dataclass
class GranuleSample:
    """One scene ready for tiling: channels (H, W, C) float32, label mask
    (H, W) float32 in [0, 1]."""

    channels: np.ndarray
    mask: np.ndarray


def fire_channel(shape, rows, cols, sigma: float = 2.0) -> np.ndarray:
    """Rasterised fire detections smoothed to a density field, max 1."""
    grid = np.zeros(shape, dtype=np.float32)
    if len(rows):
        grid[np.asarray(rows), np.asarray(cols)] = 1.0
        grid = ndimage.gaussian_filter(grid, sigma).astype(np.float32)
        m = grid.max()
        if m > 0:
            grid /= m
    return grid


def assemble_channels(aod: np.ndarray, rows, cols) -> np.ndarray:
    """(H, W, 2) float32 of [AOD with nulls zeroed, normalised fire
    density]: what the U-Net reads."""
    aod = aod.copy()
    aod[aod == NULL_VALUE] = 0.0
    fire = fire_channel(aod.shape, rows, cols)
    return np.stack([aod, fire], axis=-1).astype(np.float32)


def scene_to_sample(scene) -> GranuleSample:
    """Synthetic scene → (AOD, fire) channels + ground-truth mask; each fire
    is placed at its nearest grid cell."""
    lat, lon = scene.granule.lat, scene.granule.lon
    rows, cols = [], []
    for f_lat, f_lon in zip(scene.fires["latitude"].tolist(),
                            scene.fires["longitude"].tolist()):
        d2 = (lat - f_lat) ** 2 + (lon - f_lon) ** 2
        idx = np.unravel_index(np.argmin(d2), lat.shape)
        rows.append(idx[0])
        cols.append(idx[1])
    channels = assemble_channels(scene.granule.first_layer(), rows, cols)
    return GranuleSample(channels=channels,
                         mask=scene.gt_mask.astype(np.float32))


def make_synthetic_dataset(cfg: DataConfig, train: bool = True
                           ) -> List[GranuleSample]:
    n = cfg.n_train_granules if train else cfg.n_eval_granules
    base = cfg.seed if train else cfg.seed + 10_000
    samples = []
    for i in range(n):
        scene = make_scene(SyntheticSceneConfig(
            size=cfg.granule_size, n_plumes=4, seed=base + i,
            background_level=0.15, background_noise=0.04,
            plume_amplitude=(0.5, 0.9), plume_sigma_major=(10.0, 22.0),
            plume_sigma_minor=(2.0, 4.0), null_blobs=1))
        samples.append(scene_to_sample(scene))
    return samples


def weak_label_scene(i: int, cfg: DataConfig, train: bool = True):
    """The ``i``-th synthetic scene of :func:`make_weak_label_dataset`."""
    base = cfg.seed if train else cfg.seed + 10_000
    return make_scene(SyntheticSceneConfig(
        # 3 plumes per 256^2: denser scenes merge plumes past the rg area
        # gate and the labeller accepts nothing
        size=cfg.granule_size, n_plumes=3, seed=base + i,
        background_level=0.2, background_noise=0.05,
        plume_amplitude=(0.6, 0.9), plume_sigma_major=(9.0, 16.0),
        plume_sigma_minor=(1.8, 2.8), fires_per_plume=(5, 8)))


def weak_label_mask(scene, identify_cfg=None, device="cuda") -> np.ndarray:
    """The union of the rg detector's accepted plume masks on ``scene``,
    (H, W) float32."""
    from plumekit_torch.config.identify import RGIdentifyConfig
    from plumekit_torch.identify import rg as rg_mod

    identify_cfg = identify_cfg or RGIdentifyConfig(max_fires=32)
    g = scene.granule
    _, _, out = rg_mod.identify(g.first_layer(), g.lat, g.lon,
                                scene.fires["date_time"][0], scene.fires,
                                identify_cfg, device=device)
    weak = np.zeros(g.shape, np.float32)
    for f in np.nonzero(out["accepted"])[0]:
        weak[out["mask"][f]] = 1.0
    return weak


def make_weak_label_dataset(cfg: DataConfig, train: bool = True,
                            identify_cfg=None, device="cuda"
                            ) -> List[GranuleSample]:
    """The classical identify pipeline as the weak labeller: synthetic
    granules, each labelled with the union of the rg detector's accepted
    plume masks (run on ``device``)."""
    n = cfg.n_train_granules if train else cfg.n_eval_granules
    samples = []
    for i in range(n):
        scene = weak_label_scene(i, cfg, train)
        sample = scene_to_sample(scene)
        samples.append(GranuleSample(
            channels=sample.channels,
            mask=weak_label_mask(scene, identify_cfg, device)))
    return samples


def _prep_samples(samples: List[GranuleSample], tile: int):
    """Pad sub-tile granules up to one tile (channels replicate, masks
    zero-fill; quantized samples keep their ``lo``/``scale``) and index each
    sample's plume pixels (mask above half, in the mask's own code: 127.5
    for uint8) once."""
    prepped = []
    for s in samples:
        h, w = s.channels.shape[:2]
        if h < tile or w < tile:
            ph, pw = max(0, tile - h), max(0, tile - w)
            padded = GranuleSample(
                channels=np.pad(s.channels, ((0, ph), (0, pw), (0, 0)),
                                mode="edge"),
                mask=np.pad(s.mask, ((0, ph), (0, pw))))
            if hasattr(s, "lo"):
                padded.lo, padded.scale = s.lo, s.scale
            s = padded
        half = 127.5 if s.mask.dtype == np.uint8 else 0.5
        prepped.append((s, np.nonzero(s.mask > half)))
    return prepped


def _draw_tile(prepped, tile: int, rng: np.random.Generator):
    """One plume-biased tile draw: (sample, cy, cx). Half the tiles are
    centred near mask pixels (±8 px), the rest uniform. The float and the
    quantized iterators both draw through it, so one seed gives the same
    tiles in either mode."""
    s, (pys, pxs) = prepped[rng.integers(len(prepped))]
    h, w = s.channels.shape[:2]
    if rng.random() < 0.5 and len(pys):
        k = rng.integers(len(pys))
        cy = int(np.clip(pys[k] - tile // 2 + rng.integers(-8, 9),
                         0, h - tile))
        cx = int(np.clip(pxs[k] - tile // 2 + rng.integers(-8, 9),
                         0, w - tile))
    else:
        cy = int(rng.integers(0, h - tile + 1))
        cx = int(rng.integers(0, w - tile + 1))
    return s, cy, cx


def tile_batches(samples: List[GranuleSample], tile: int, batch_size: int,
                 rng: np.random.Generator, steps: Optional[int] = None,
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite (or ``steps``-bounded) iterator of random tile batches:
    (B, tile, tile, C) channels and (B, tile, tile, 1) masks."""
    if not samples:
        raise ValueError("tile_batches got an empty sample list")
    prepped = _prep_samples(samples, tile)
    count = 0
    while steps is None or count < steps:
        xs = np.empty((batch_size, tile, tile,
                       prepped[0][0].channels.shape[-1]), np.float32)
        ys = np.empty((batch_size, tile, tile, 1), np.float32)
        for b in range(batch_size):
            s, cy, cx = _draw_tile(prepped, tile, rng)
            xs[b] = s.channels[cy:cy + tile, cx:cx + tile]
            ys[b, ..., 0] = s.mask[cy:cy + tile, cx:cx + tile]
        yield xs, ys
        count += 1


def quantize_samples(samples: List[GranuleSample]) -> List[GranuleSample]:
    """Granules encoded once for the quantized transfers: uint16 channels
    (:func:`plumekit_torch.ops.quant.quantize_uint16`, per granule) with
    ``lo``/``scale`` sidecar attributes, and masks as
    ``rint(clip(m, 0, 1) · 255)`` uint8 (exact for {0, 1} labels), by
    :func:`plumekit_torch.native.quantize_mask_uint8`."""
    from plumekit_torch import native
    from plumekit_torch.ops.quant import quantize_uint16

    out = []
    for s in samples:
        q, lo, scale = quantize_uint16(s.channels)
        m8 = native.quantize_mask_uint8(s.mask)
        qs = GranuleSample(channels=q, mask=m8)
        qs.lo, qs.scale = lo, scale
        out.append(qs)
    return out


def tile_batches_quant(samples: List[GranuleSample], tile: int,
                       batch_size: int, rng: np.random.Generator,
                       steps: Optional[int] = None,
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]:
    """The quantized twin of :func:`tile_batches` over
    :func:`quantize_samples` output: yields ``(q (B, t, t, C) uint16,
    lo (B, C), scale (B, C) float32, y8 (B, t, t, 1) uint8)``, the same
    tiles as the float iterator for the same ``rng``."""
    if not samples:
        raise ValueError("tile_batches_quant got an empty sample list")
    if not hasattr(samples[0], "lo"):
        raise ValueError(
            "samples lack (lo, scale) sidecars; pass quantize_samples(...) "
            "output, not raw GranuleSamples")
    prepped = _prep_samples(samples, tile)
    c = prepped[0][0].channels.shape[-1]
    count = 0
    while steps is None or count < steps:
        q = np.empty((batch_size, tile, tile, c), np.uint16)
        lo = np.empty((batch_size, c), np.float32)
        scale = np.empty((batch_size, c), np.float32)
        y8 = np.empty((batch_size, tile, tile, 1), np.uint8)
        for b in range(batch_size):
            s, cy, cx = _draw_tile(prepped, tile, rng)
            q[b] = s.channels[cy:cy + tile, cx:cx + tile]
            y8[b, ..., 0] = s.mask[cy:cy + tile, cx:cx + tile]
            lo[b], scale[b] = s.lo, s.scale
        yield q, lo, scale, y8
        count += 1
