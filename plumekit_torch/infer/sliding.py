"""Full-granule sliding-window inference with overlap-blend stitching
(``plumekit/infer/sliding.py``).

Tile the granule with overlapping windows, run the U-Net on batches of
tiles, weight each tile with a separable linear taper over the overlap and
divide the accumulated canvas by the accumulated weights. The geometry
(tile grid, batch size, edge-replicated padding of the last tile row and
column, parity-class assembly) is the JAX package's, so the two agree tile
for tile. JAX's ``lax.scan`` over tile batches is a Python loop here, and
its ``vmap`` over granules is a leading granule dimension folded into each
tile batch.

With the recorder on (``utils/timers``), a call records the span
``sliding.infer`` and inside it ``sliding.pad`` (edge padding, tile grid and
weights), one ``sliding.forward`` per tile batch (the tile gather and the
forward, with its ``tiles``) and ``sliding.stitch`` (the canvas and the
output), the last two with their device time; and the counters
``sliding.forwards`` and ``sliding.tiles``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch.config.train import InferConfig
from plumekit_torch.ops.quant import quantize_probs_uint8
from plumekit_torch.utils import timers


def _taper(tile: int, overlap: int) -> np.ndarray:
    """1-D weight: linear ramp over the overlap, flat 1 in the core. Ramp
    endpoints are strictly positive; deep overlaps (> tile/2) combine the
    two ramps with ``minimum`` so the profile stays monotone up-then-down."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1, dtype=np.float32)) / (overlap + 1)
        w[:overlap] = np.minimum(w[:overlap], ramp)
        w[-overlap:] = np.minimum(w[-overlap:], ramp[::-1])
    return w


def _effective_batch(batch_tiles: int, n: int) -> int:
    """Per-forward batch for an ``n``-tile grid: the size in
    [batch_tiles/2, batch_tiles] that minimises duplicate batch-fill tiles
    (ties to the largest batch)."""
    hi = max(1, min(batch_tiles, n))
    best, best_pad = hi, (-n) % hi
    for eff in range(hi - 1, max(0, hi // 2 - 1), -1):
        p = (-n) % eff
        if p < best_pad:
            best, best_pad = eff, p
            if p == 0:
                break
    return best


def tile_grid(size: int, tile: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, size) with the last tile clamped flush."""
    if size <= tile:
        return np.zeros((1,), np.int32)
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return np.asarray(starts, np.int32)


def _edge_pad(images, h2: int, w2: int):
    """Edge-replicate (G, H, W, C) images up to (G, h2, w2, C)."""
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    rows = torch.arange(h2, device=dev).clamp_(max=h - 1)
    cols = torch.arange(w2, device=dev).clamp_(max=w - 1)
    return images.index_select(1, rows).index_select(2, cols)


def make_multi_granule_infer(
    apply_fn: Callable,
    cfg: InferConfig = InferConfig(),
    channels: int = 2,
):
    """Build ``infer(variables, images (G, H, W, C)) -> (probs (G, H, W),
    masks)``. ``apply_fn(variables, batch (N, t, t, C))`` returns
    (N, t, t, 1) logits; each forward carries G granules' tiles.

    Stitching has two paths, as in the JAX package. When overlap ≤ stride
    and the image is at least one tile, the image is edge-padded onto the
    stride lattice and the canvas is assembled from the four tile parity
    classes (tiles of one class are disjoint); overlap 0 is one
    transpose-reshape. Deep overlaps (> stride) add tile by tile in grid
    order into a canvas of the true image size, counting the duplicate
    batch-fill tiles. Sub-tile images are edge-padded up to one tile."""
    tile = cfg.tile_size
    stride = tile - cfg.overlap
    if cfg.emit not in ("float", "uint8"):
        raise ValueError(f"emit must be 'float' or 'uint8', got {cfg.emit!r}")
    emit_u8 = cfg.emit == "uint8"
    thresh_u8 = int(np.floor(cfg.threshold * 255.0))
    if stride < 1:
        raise ValueError(
            f"overlap ({cfg.overlap}) must be smaller than tile_size "
            f"({tile}): the sliding stride would be {stride}")
    if cfg.overlap < 0:
        raise ValueError(
            f"overlap must be >= 0, got {cfg.overlap}: a negative overlap "
            "leaves gap stripes between tiles that would be silently "
            "scored 0")
    taper_np = _taper(tile, cfg.overlap)
    weight2d_np = taper_np[:, None] * taper_np[None, :]

    def grid_and_weights(h, w, count_padding: bool, device):
        """Origins (batch-padded), the batch size, and the inverse weight
        canvas as an outer product of the per-axis taper sums (plus one
        rank-1 term for the batch-fill duplicates when they are counted)."""
        ys, xs = tile_grid(h, tile, stride), tile_grid(w, tile, stride)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        origins = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)
        n = origins.shape[0]
        eff = _effective_batch(cfg.batch_tiles, n)
        pad = (-n) % eff
        padded = np.concatenate([origins, np.tile(origins[-1:], (pad, 1))])

        def axis_weight(starts, size):
            acc = np.zeros(size, np.float32)
            for s in starts:
                acc[s:s + tile] += taper_np
            return acc

        def t(a):
            return torch.from_numpy(a).to(device)

        canvas = torch.outer(t(axis_weight(ys, h)), t(axis_weight(xs, w)))
        if count_padding and pad:
            ty = np.zeros(h, np.float32)
            ty[ys[-1]:ys[-1] + tile] = taper_np
            tx = np.zeros(w, np.float32)
            tx[xs[-1]:xs[-1] + tile] = taper_np
            canvas = canvas + pad * torch.outer(t(ty), t(tx))
        inv_weight = 1.0 / torch.clamp(canvas, min=1e-8)
        return len(ys), len(xs), n, eff, padded.tolist(), inv_weight

    def finish(probs):
        if emit_u8:
            p8 = quantize_probs_uint8(probs)
            return p8, p8 > thresh_u8
        return probs, probs > cfg.threshold

    def forward_batch(variables, images, batch_origins, as_u8=False):
        g = images.shape[0]
        n = g * len(batch_origins)
        timers.count("sliding.forwards")
        timers.count("sliding.tiles", n)
        with timers.span("sliding.forward", device=images.device, tiles=n):
            tiles = torch.stack([images[:, oy:oy + tile, ox:ox + tile,
                                        :channels]
                                 for oy, ox in batch_origins], dim=1)
            logits = apply_fn(variables,
                              tiles.reshape(-1, tile, tile, channels))
            probs = torch.sigmoid(logits[..., 0].float())
            probs = probs.reshape(g, len(batch_origins), tile, tile)
            return quantize_probs_uint8(probs) if as_u8 else probs

    @torch.no_grad()
    def infer(variables, images):
        with timers.span("sliding.infer", granules=images.shape[0]):
            return stitched(variables, images)

    def stitched(variables, images):
        g, h, w = images.shape[0], images.shape[1], images.shape[2]
        dev = images.device
        ph, pw = max(0, tile - h), max(0, tile - w)
        if ph or pw:
            with timers.span("sliding.pad"):
                padded = _edge_pad(images, h + ph, w + pw)
            probs, mask = stitched(variables, padded)
            return probs[:, :h, :w], mask[:, :h, :w]

        if tile <= 2 * stride:
            # regular-grid fast path: every tile on the stride lattice of
            # the edge-padded image, the canvas built per parity class
            with timers.span("sliding.pad"):
                h2 = tile + -(-(h - tile) // stride) * stride
                w2 = tile + -(-(w - tile) // stride) * stride
                ny, nx, n, eff, origins, inv_weight = grid_and_weights(
                    h2, w2, count_padding=False, device=dev)
                img = _edge_pad(images, h2, w2)
            fast_u8 = emit_u8 and cfg.overlap == 0
            parts = [forward_batch(variables, img, origins[i:i + eff],
                                   fast_u8)
                     for i in range(0, len(origins), eff)]
            with timers.span("sliding.stitch", device=dev):
                probs_all = torch.cat(parts, dim=1)[:, :n]
                del parts           # the batches' memory, free for the canvas
                if cfg.overlap == 0:
                    # stride == tile: the taper is 1 and tiles are disjoint
                    canvas = probs_all.reshape(g, ny, nx, tile, tile) \
                        .permute(0, 1, 3, 2, 4) \
                        .reshape(g, ny * tile, nx * tile)
                    probs = canvas[:, :h, :w]
                    if fast_u8:
                        return probs, probs > thresh_u8
                    return probs, probs > cfg.threshold
                weight2d = torch.from_numpy(weight2d_np).to(dev)
                probs_all = probs_all.reshape(g, ny, nx, tile, tile) \
                    * weight2d
                pitch = 2 * stride
                canvas = torch.zeros((g, h2 + pitch, w2 + pitch),
                                     dtype=torch.float32, device=dev)
                for pr in (0, 1):
                    for pc in (0, 1):
                        if pr >= ny or pc >= nx:
                            continue
                        cls = probs_all[:, pr::2, pc::2]
                        gy, gx = cls.shape[1], cls.shape[2]
                        cls = F.pad(cls, (0, pitch - tile, 0, pitch - tile))
                        sheet = cls.permute(0, 1, 3, 2, 4).reshape(
                            g, gy * pitch, gx * pitch)
                        oy, ox = pr * stride, pc * stride
                        canvas[:, oy:oy + gy * pitch,
                               ox:ox + gx * pitch] += sheet
                return finish(canvas[:, :h, :w] * inv_weight[:h, :w])

        # general path: deep overlap, tile by tile in grid order
        with timers.span("sliding.pad"):
            _, _, _, eff, origins, inv_weight = grid_and_weights(
                h, w, count_padding=True, device=dev)
            weight2d = torch.from_numpy(weight2d_np).to(dev)
            canvas = torch.zeros((g, h, w), dtype=torch.float32, device=dev)
        for i in range(0, len(origins), eff):
            batch_origins = origins[i:i + eff]
            probs = forward_batch(variables, images, batch_origins)
            with timers.span("sliding.stitch", device=dev):
                for k, (oy, ox) in enumerate(batch_origins):
                    canvas[:, oy:oy + tile, ox:ox + tile] += \
                        probs[:, k] * weight2d
        with timers.span("sliding.stitch", device=dev):
            return finish(canvas * inv_weight)

    return infer


def make_sliding_infer(
    apply_fn: Callable,
    cfg: InferConfig = InferConfig(),
    channels: int = 2,
):
    """Build ``infer(variables, image (H, W, C)) -> (probs (H, W), mask)``:
    :func:`make_multi_granule_infer` on one granule."""
    batched = make_multi_granule_infer(apply_fn, cfg, channels)

    def infer(variables, image):
        probs, mask = batched(variables, image[None])
        return probs[0], mask[0]

    return infer


def make_batch_infer_sharded(
    apply_fn: Callable,
    mesh,
    cfg: InferConfig = InferConfig(),
    channels: int = 2,
    axis: str = "data",
):
    """Build ``infer(replicas, images (D·G, H, W, C)) -> (probs, masks)``:
    the granule group split D ways over the mesh's ``axis``, each device
    running :func:`make_multi_granule_infer` on its G granules with its own
    replica of the variables (``replicas[i]`` on the axis's i-th device,
    every tensor the forward reads, packed weights included, on that
    device). Granules are independent, so no device reads another's data.

    ``images`` is a tensor whose leading dim divides by D (split straight
    onto the devices, :func:`plumekit_torch.parallel.mesh.shard`) or the D
    per-device parts themselves, as the stream stages them. Each device's
    share runs on a host thread of its own
    (:func:`plumekit_torch.parallel.mesh.run_per_device`): the sliding
    program reads its geometry from the host partway, so one thread would
    hold the other devices idle. The outputs are gathered, in slot order,
    on the first device."""
    from plumekit_torch.parallel.mesh import gather, run_per_device, shard

    devices = mesh.axis_devices(axis)
    local = make_multi_granule_infer(apply_fn, cfg, channels)

    def infer(replicas, images):
        if len(replicas) != len(devices):
            raise ValueError(f"{len(replicas)} replicas for {len(devices)} "
                             f"devices on {axis!r}")
        parts = (list(images) if isinstance(images, (list, tuple))
                 else shard(images, devices))
        for part, device in zip(parts, devices):
            if part.device != torch.device(device):
                raise ValueError(f"a part on {part.device} for a slot on "
                                 f"{device}")
        outs = run_per_device(local, devices, replicas, parts)
        return (gather([p for p, _ in outs], devices[0]),
                gather([m for _, m in outs], devices[0]))

    infer.devices = devices
    return infer


def pad_to_multiple(image: np.ndarray, multiple: int
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pad H/W up to a multiple (the U-Net needs 2**depth
    divisibility); returns (padded, original (H, W))."""
    h, w = image.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw)) + ((0, 0),) * (image.ndim - 2),
                       mode="edge")
    return image, (h, w)
