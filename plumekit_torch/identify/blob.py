"""Blob-detector baseline, LoG / DoG / DoH (``plumekit/identify/blob.py``),
in plain PyTorch: separable Gaussian blurs with symmetric (scipy
"reflect") boundaries, finite differences over edge-replicated neighbours,
3-D local maxima over the scale stack, then host-side packing and overlap
pruning. Radii follow the reference's ``r = sigma * sqrt(2)``
(``plume_indetifier_blob.py:43,46``). No fire table and no kernel; no
command-line path runs it.

The blurs are float32 convolutions; TF32 is switched off around them, as
the JAX blurs ask for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch.config.identify import BlobIdentifyConfig
from plumekit_torch.device import resolve_device


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    r = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_pad(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``np.pad(..., mode="symmetric")`` by ``r`` along ``dim`` (the edge
    pixel is repeated; a pad wider than the image reflects again)."""
    idx = np.pad(np.arange(img.shape[dim]), r, mode="symmetric")
    return img.index_select(dim, torch.from_numpy(idx).to(img.device))


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable blur with symmetric boundaries, rows then columns."""
    k = torch.from_numpy(_gaussian_kernel(sigma)).to(img.device)
    r = k.shape[0] // 2
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        img = F.conv2d(_symmetric_pad(img, r, 0)[None, None],
                       k[None, None, :, None])[0, 0]
        img = F.conv2d(_symmetric_pad(img, r, 1)[None, None],
                       k[None, None, None, :])[0, 0]
    return img


def _shift(img: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """``img[clip(i + dr), clip(j + dc)]``: the neighbour view with the
    edge replicated (a roll would wrap and invent derivatives at the
    opposite border)."""
    h, w = img.shape
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return pad[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]


def _local_max_3d(stack: torch.Tensor, threshold: float) -> torch.Tensor:
    """(S, H, W) scale-space local maxima above ``threshold`` (26
    neighbours; ties count as maxima)."""
    s, h, w = stack.shape
    pad = F.pad(stack, (1, 1, 1, 1, 1, 1), value=-torch.inf)
    is_max = torch.ones_like(stack, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == dr == dc == 0:
                    continue
                is_max &= stack >= pad[1 + ds:1 + ds + s, 1 + dr:1 + dr + h,
                                       1 + dc:1 + dc + w]
    return is_max & (stack > threshold)


def _disc_overlap(y1, x1, r1, y2, x2, r2) -> float:
    """Intersection area of two discs over the SMALLER disc's area (the
    published pruning criterion; same formula as the scipy oracle, derived
    independently from the two-circular-segment geometry)."""
    d = float(np.hypot(y1 - y2, x1 - x2))
    if d >= r1 + r2:
        return 0.0
    small, big = sorted((r1, r2))
    if d <= big - small:
        return 1.0
    a1 = np.arccos(np.clip((d * d + r1 * r1 - r2 * r2) / (2 * d * r1),
                           -1, 1))
    a2 = np.arccos(np.clip((d * d + r2 * r2 - r1 * r1) / (2 * d * r2),
                           -1, 1))
    lens = (r1 * r1 * (a1 - np.sin(2 * a1) / 2)
            + r2 * r2 * (a2 - np.sin(2 * a2) / 2))
    return float(lens / (np.pi * small * small))


def _prune_overlapping(blobs: np.ndarray, overlap: float,
                       radius_scale: float) -> np.ndarray:
    """Host-side post-pass: drop the smaller-sigma member of every disc
    pair overlapping by more than ``overlap`` (big sigmas scanned first so
    they win). O(N²) on the ≤max_blobs survivors — off the device path.

    Chained-overlap convention: the scan is ALIVE-ordered — a blob killed
    earlier no longer kills others — whereas skimage's ``_prune_blobs``
    zeroes sigmas pairwise with no aliveness order, so a chain A→B→C can
    differ (docs/parity.md blob entry; the clean-room oracle encodes this
    same alive-order convention)."""
    if len(blobs) < 2 or overlap >= 1.0:
        return blobs
    alive = np.ones(len(blobs), bool)
    order = np.argsort(-blobs[:, 2])
    for ii, i in enumerate(order):
        if not alive[i]:
            continue
        for j in order[ii + 1:]:
            if alive[j] and _disc_overlap(
                    blobs[i, 0], blobs[i, 1], blobs[i, 2] * radius_scale,
                    blobs[j, 0], blobs[j, 1],
                    blobs[j, 2] * radius_scale) > overlap:
                alive[j] = False
    return blobs[alive]


def _extract(maxima, sigmas, max_blobs: int, stack=None):
    """Pack scale-space maxima into (N, 3) [row, col, sigma] host-side.

    When the budget binds, the STRONGEST responses are kept (ordering by
    scale index alone let >max_blobs small-sigma speckle maxima crowd out
    genuine large-scale blobs)."""
    m = maxima.cpu().numpy()
    ss, ys, xs = np.nonzero(m)
    if stack is not None and len(ss) > max_blobs:
        resp = stack.cpu().numpy()[ss, ys, xs]
        order = np.argsort(-resp)[:max_blobs]
    else:
        order = np.argsort(ss)[:max_blobs]
    return np.column_stack(
        [ys[order], xs[order], np.asarray(sigmas)[ss[order]]]
    ).astype(np.float32)


def _image(image, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(image, np.float32)) \
        .to(resolve_device(device))


def _linear_sigmas(cfg: BlobIdentifyConfig):
    return tuple(float(s) for s in np.linspace(cfg.min_sigma, cfg.max_sigma,
                                               cfg.num_sigma))


def blob_log(image, cfg: BlobIdentifyConfig = BlobIdentifyConfig(),
             max_blobs: int = 256, device="cuda") -> np.ndarray:
    """(N, 3) [row, col, radius] bright blobs by the scale-normalised
    negative Laplacian of Gaussian."""
    img = _image(image, device)
    sigmas = _linear_sigmas(cfg)
    outs = []
    with torch.inference_mode():
        for s in sigmas:
            b = _gaussian_blur(img, s)
            lap = (4.0 * b - _shift(b, 1, 0) - _shift(b, -1, 0)
                   - _shift(b, 0, 1) - _shift(b, 0, -1))
            outs.append(lap * s**2)
        stack = torch.stack(outs)
        maxima = _local_max_3d(stack, cfg.threshold_log)
    blobs = _extract(maxima, sigmas, max_blobs, stack=stack)
    blobs = _prune_overlapping(blobs, cfg.overlap, np.sqrt(2.0))
    blobs[:, 2] *= np.sqrt(2.0)
    return blobs


def blob_dog(image, cfg: BlobIdentifyConfig = BlobIdentifyConfig(),
             sigma_ratio: float = 1.6, max_blobs: int = 256,
             device="cuda") -> np.ndarray:
    """(N, 3) [row, col, radius] by differences of Gaussians, scaled by
    ``1 / (sigma_ratio - 1)`` as the published detector."""
    img = _image(image, device)
    k = int(np.log(cfg.max_sigma / cfg.min_sigma) / np.log(sigma_ratio)) + 1
    sigmas = [cfg.min_sigma * sigma_ratio**i for i in range(k + 1)]
    with torch.inference_mode():
        blurred = [_gaussian_blur(img, s) for s in sigmas]
        dogs = torch.stack([(blurred[i] - blurred[i + 1])
                            / (sigma_ratio - 1.0) for i in range(k)])
        maxima = _local_max_3d(dogs, cfg.threshold_dog)
    blobs = _extract(maxima, tuple(sigmas[:k]), max_blobs, stack=dogs)
    blobs = _prune_overlapping(blobs, cfg.overlap, np.sqrt(2.0))
    blobs[:, 2] *= np.sqrt(2.0)
    return blobs


def blob_doh(image, cfg: BlobIdentifyConfig = BlobIdentifyConfig(),
             max_blobs: int = 256, device="cuda") -> np.ndarray:
    """(N, 3) [row, col, sigma] by the determinant of the Hessian."""
    img = _image(image, device)
    sigmas = _linear_sigmas(cfg)
    outs = []
    with torch.inference_mode():
        for s in sigmas:
            b = _gaussian_blur(img, s)
            dyy = _shift(b, 1, 0) + _shift(b, -1, 0) - 2 * b
            dxx = _shift(b, 0, 1) + _shift(b, 0, -1) - 2 * b
            dxy = 0.25 * (_shift(b, 1, 1) + _shift(b, -1, -1)
                          - _shift(b, 1, -1) - _shift(b, -1, 1))
            outs.append((dxx * dyy - dxy**2) * s**4)
        hstack = torch.stack(outs)
        maxima = _local_max_3d(hstack, cfg.threshold_doh)
    blobs = _extract(maxima, sigmas, max_blobs, stack=hstack)
    return _prune_overlapping(blobs, cfg.overlap, 1.0)
