"""Region statistics over boolean masks (``plumekit/ops/segment.py``):
``regionprops``-style bbox, centroid and coordinate covariance, and the
nearest-label window lookup of the rg detector.

Every function reduces over the last two axes, so a leading axis of fire
candidates is one call (the JAX package vmaps instead).
"""

from __future__ import annotations

import numpy as np
import torch

from plumekit_torch.ops.ccl import BACKGROUND


def _iota_grids(h: int, w: int, device):
    rr = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return rr, cc


def masked_bbox(mask: torch.Tensor):
    """Half-open bbox (min_r, min_c, max_r, max_c) as int32 — regionprops
    ``bbox`` semantics. An empty mask gives (H, W, 0, 0)."""
    h, w = mask.shape[-2:]
    rows = mask.any(-1)                  # (..., H)
    cols = mask.any(-2)                  # (..., W)
    rr = torch.arange(h, dtype=torch.int32, device=mask.device)
    cc = torch.arange(w, dtype=torch.int32, device=mask.device)
    return (
        torch.where(rows, rr, h).amin(-1).to(torch.int32),
        torch.where(cols, cc, w).amin(-1).to(torch.int32),
        (torch.where(rows, rr, -1).amax(-1) + 1).to(torch.int32),
        (torch.where(cols, cc, -1).amax(-1) + 1).to(torch.int32),
    )


def masked_centroid(mask: torch.Tensor):
    """(row, col) float32 centroid; an empty mask gives 0. Integer sums are
    int64 here (the JAX package's int32 sums wrap beyond 2^31)."""
    h, w = mask.shape[-2:]
    rr = torch.arange(h, dtype=torch.int64, device=mask.device)
    cc = torch.arange(w, dtype=torch.int64, device=mask.device)
    n = torch.clamp(mask.sum((-2, -1)), min=1)
    r = (mask.sum(-1) * rr).sum(-1) / n
    c = (mask.sum(-2) * cc).sum(-1) / n
    return r.to(torch.float32), c.to(torch.float32)


def masked_moments_cov(mask: torch.Tensor):
    """Sample covariance (ddof=1) of the (row, col) coordinates of mask
    pixels, ``np.cov(np.where(mask))`` as the reference computes plume axes
    (``plume_identifier_rg.py:285-286``), in float32 as the JAX package.
    Returns (cov_rr, cov_rc, cov_cc, n); n <= 1 gives zero covariances."""
    h, w = mask.shape[-2:]
    rr, cc = _iota_grids(h, w, mask.device)
    m = mask.to(torch.float32)
    n = m.sum((-2, -1))
    safe_n = torch.clamp(n, min=1.0)
    mr = (rr * m).sum((-2, -1)) / safe_n
    mc = (cc * m).sum((-2, -1)) / safe_n
    dr = (rr - mr[..., None, None]) * m
    dc = (cc - mc[..., None, None]) * m
    denom = torch.clamp(n - 1.0, min=1.0)
    c_rr = (dr * dr).sum((-2, -1)) / denom
    c_rc = (dr * dc).sum((-2, -1)) / denom
    c_cc = (dc * dc).sum((-2, -1)) / denom
    return c_rr, c_rc, c_cc, n


def window_distance_matrix(win_half: int) -> np.ndarray:
    """Euclidean pixel-distance matrix of a (2w+1)² window, float32: the
    reference's precomputed ``DISTANCE_MATRIX``
    (``plume_identifier_rg.py:28-32``)."""
    x = np.arange(-win_half, win_half + 1)
    dx, dy = np.meshgrid(x, x)
    return np.sqrt(dx**2 + dy**2).astype(np.float32)


def window_starts(r: torch.Tensor, c: torch.Tensor, h: int, w: int,
                  win_half: int):
    """Top-left corners of the (2w+1)² windows around (r, c), clamped so
    that every window lies inside the (h, w) image."""
    size = 2 * win_half + 1
    return (torch.clamp(r - win_half, 0, h - size),
            torch.clamp(c - win_half, 0, w - size))


def window_label_from(win: torch.Tensor, r, c, start_r, start_c):
    """Nearest non-background label to (r, c) in pre-extracted windows
    ``win`` (..., size, size) whose corners are (start_r, start_c) — the
    lookup half of :func:`label_window_nearest`. Ties go to the first
    minimum in row-major window order (``np.argmin``, as the reference's
    ``extract_label``, ``plume_identifier_rg.py:152-170``). Returns
    ``(label, found)``; ``found`` is False when the window holds only
    background."""
    size = win.shape[-1]
    ar = torch.arange(size, dtype=torch.float32, device=win.device)
    rr = ar[:, None] - (r - start_r).to(torch.float32)[..., None, None]
    cc = ar[None, :] - (c - start_c).to(torch.float32)[..., None, None]
    dist = torch.sqrt(rr * rr + cc * cc)
    fg = win != BACKGROUND
    masked = torch.where(fg, dist, torch.inf).flatten(-2)
    idx = torch.argmin(masked, dim=-1, keepdim=True)
    label = torch.gather(win.flatten(-2), -1, idx)[..., 0]
    return label, fg.flatten(-2).any(-1)


def gather_windows(labels: torch.Tensor, start_r, start_c, size: int):
    """(..., F, size, size) windows of ``labels`` (..., H, W) at the F
    corners (start_r, start_c)."""
    ar = torch.arange(size, device=labels.device)
    rows = (start_r.long()[:, None] + ar)[:, :, None]      # (F, size, 1)
    cols = (start_c.long()[:, None] + ar)[:, None, :]      # (F, 1, size)
    return labels[..., rows, cols]


def label_window_nearest(labels: torch.Tensor, r, c, win_half: int):
    """Nearest non-background label of an (H, W) label image within the
    (2w+1)² window around each (r, c) (1-D tensors of fire locations).
    The window is clamped at the image edges; distances are measured from
    the fire's own offset inside it."""
    h, w = labels.shape
    sr, sc = window_starts(r, c, h, w, win_half)
    win = gather_windows(labels, sr, sc, 2 * win_half + 1)
    return window_label_from(win, r, c, sr, sc)
