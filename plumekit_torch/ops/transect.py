"""Transect sampling, Savitzky–Golay smoothing and peak counting
(``plumekit/ops/transect.py``), batched over a leading axis of candidates.

The reference samples AOD along a plume's minor axis with bilinear
``map_coordinates``, smooths with ``savgol_filter(., 17, 3)`` and accepts
at most one ``find_peaks`` peak (``plume_identifier_rg.py:319-354``). Its
kept samples are one contiguous run of the fixed-length line, so the
masked fixed-length form here is exact. Everything runs in float32; the
edge projections amplify low-precision matmul error about 100×, so the
small products are elementwise sums, never TF32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def savgol_coefficients(window: int, polyorder: int):
    """(interior kernel, left-edge matrix, right-edge matrix) as float32
    numpy constants: ``scipy.signal.savgol_coeffs`` and scipy's default
    ``mode='interp'`` polynomial-fit edges."""
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    a_fit = np.vander(x, polyorder + 1, increasing=True)
    kernel = np.linalg.pinv(a_fit)[0]
    pos = np.arange(window, dtype=np.float64)
    proj_pos = np.linalg.pinv(np.vander(pos, polyorder + 1, increasing=True))
    left = np.vander(pos[:half], polyorder + 1, increasing=True) @ proj_pos
    right = np.vander(pos[half + 1:], polyorder + 1, increasing=True) @ proj_pos
    return (kernel.astype(np.float32), left.astype(np.float32),
            right.astype(np.float32))


def _roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-row ``torch.roll(x[i], shift[i])`` of an (N, n) tensor."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device) - shift[:, None]) % n
    return torch.gather(x, -1, idx)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, k) = (e, k) matrix times each (N, k) row, as elementwise sums
    in float32."""
    return (m[None, :, :] * v[:, None, :]).sum(-1)


def savgol_smooth(values: torch.Tensor, valid: torch.Tensor, window: int,
                  polyorder: int):
    """Savitzky–Golay smooth the contiguous valid run of each row of
    ``values`` (N, n), with scipy's 'interp' edges at the run's ends.

    Returns ``(smoothed, ok)``; ``ok`` is False where the run is shorter
    than ``window`` (scipy raises there and the reference rejects the
    plume, ``plume_identifier_rg.py:305-307``)."""
    kernel_np, left_np, right_np = savgol_coefficients(window, polyorder)
    dev = values.device
    kernel = torch.from_numpy(kernel_np).to(dev)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    half = window // 2
    n = values.shape[-1]

    start = torch.argmax(valid.to(torch.int32), dim=-1)   # first valid
    length = valid.sum(-1)
    ok = length >= window
    run = _roll_rows(values, -start)        # the run now sits at [0, length)

    padded = torch.nn.functional.pad(run, (half, half))
    interior = kernel[0] * padded[:, 0:n]
    for j in range(1, window):
        interior = interior + kernel[j] * padded[:, j:j + n]

    left_vals = _matvec(left, run[:, :window])
    right_start = torch.clamp(length - window, min=0)
    right_vals = _matvec(right, _roll_rows(run, -right_start)[:, :window])

    idx = torch.arange(n, device=dev)[None, :]
    out = torch.where(idx < half,
                      torch.gather(left_vals, -1,
                                   torch.clamp(idx, 0, half - 1).expand_as(run)),
                      interior)
    r_idx = torch.clamp(idx - (length[:, None] - half), 0, half - 1)
    out = torch.where(idx >= length[:, None] - half,
                      torch.gather(right_vals, -1, r_idx), out)
    out = _roll_rows(out, start)
    return torch.where(valid, out, 0.0), ok


def _forward_fill(vals: torch.Tensor, flags: torch.Tensor):
    """Per row, the value at the last flagged position at or before each
    index (0 before the first), and whether there was one."""
    n = vals.shape[-1]
    pos = torch.where(flags, torch.arange(n, device=vals.device), -1)
    last = torch.cummax(pos, dim=-1).values
    filled = torch.gather(vals, -1, torch.clamp(last, min=0))
    return torch.where(last >= 0, filled, 0.0), last >= 0


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=-1)


def count_peaks_masked(values: torch.Tensor, valid: torch.Tensor,
                       flat_tol) -> torch.Tensor:
    """Number of ``scipy.signal.find_peaks`` peaks in the compacted valid
    samples of each row: a strict rise followed, across any plateau, by a
    strict fall. ``|diff| <= flat_tol`` (per row) counts as plateau.
    Returns int32 (N,)."""
    fv, fhas = _forward_fill(torch.where(valid, values, 0.0), valid)
    prev_v = _shift_right(fv, 0.0)
    prev_has = _shift_right(fhas, False)
    dvalid = valid & prev_has
    d = values - prev_v
    sign = torch.where(torch.abs(d) <= flat_tol[:, None], 0.0, torch.sign(d))
    sign = torch.where(dvalid, sign, 0.0)
    ff, _ = _forward_fill(sign, sign != 0.0)
    prev = _shift_right(ff, 0.0)
    return ((sign < 0) & (prev > 0)).sum(-1).to(torch.int32)


def _line_coords(slope, intercept, min_c, max_c, n_samples: int):
    """x uniform over [min_c, max_c], y on the line, (N, n_samples)."""
    t = torch.arange(n_samples, dtype=torch.float32,
                     device=slope.device) / (n_samples - 1)
    x = min_c[:, None] + (max_c - min_c)[:, None] * t
    y = slope[:, None] * x + intercept[:, None]
    return x, y


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """``map_coordinates(img, [y, x], order=1, mode='constant')`` as JAX
    computes it: corners in the order (lo, lo), (lo, hi), (hi, lo),
    (hi, hi), each weighted by ``w_y * w_x``, out-of-image corners 0.
    Coordinates are clipped to the image by the caller; a NaN coordinate
    gives a sample its caller masks."""
    h, w = img.shape
    y = torch.nan_to_num(y, nan=0.0)
    x = torch.nan_to_num(x, nan=0.0)
    ly, lx = torch.floor(y), torch.floor(x)
    uy, ux = y - ly, x - lx
    wy = (1 - uy, uy)
    wx = (1 - ux, ux)
    iy, ix = ly.long(), lx.long()
    flat = img.reshape(-1)
    total = None
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = iy + dy, ix + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = flat[(torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1))]
            term = (wy[dy] * wx[dx]) * torch.where(ok, v, 0.0)
            total = term if total is None else total + term
    return total


def line_transect(aod: torch.Tensor, slope, intercept, min_r, min_c, max_r,
                  max_c, n_samples: int = 1000):
    """Sample ``aod`` (H, W) along ``y = slope*x + intercept`` for x in
    [min_c, max_c], keeping samples with y strictly inside (min_r, max_r)
    — the rg transect (``plume_identifier_rg.py:331-344``). All line
    parameters are (N,) float32. A sample outside the image extent
    [0, n-1] is 0, as scipy's ``mode='constant'``. Returns
    ``(samples, valid)``, (N, n_samples)."""
    x, y = _line_coords(slope, intercept, min_c, max_c, n_samples)
    valid = (y > min_r[:, None]) & (y < max_r[:, None])
    h, w = aod.shape
    inb = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    samples = _bilinear(aod, torch.clamp(y, 0, h - 1),
                        torch.clamp(x, 0, w - 1))
    return torch.where(inb, samples, 0.0), valid


def line_transect_in_mask(aod: torch.Tensor, mask: torch.Tensor, slope,
                          intercept, min_r, min_c, max_r, max_c,
                          n_samples: int = 1000):
    """The gaussian detector's transect: also require the integer sample
    cell to lie in each candidate's mask (N, H, W)
    (``plume_identifier_gaussian_profile.py:425-427``)."""
    samples, valid = line_transect(aod, slope, intercept, min_r, min_c,
                                   max_r, max_c, n_samples)
    x, y = _line_coords(slope, intercept, min_c, max_c, n_samples)
    h, w = mask.shape[-2:]
    # float → int32 truncates toward zero; NaN and ±inf are clamped, as
    # the JAX gather clamps its out-of-range indices
    yi = torch.clamp(torch.nan_to_num(y, nan=0.0), -1, h).to(torch.int64)
    xi = torch.clamp(torch.nan_to_num(x, nan=0.0), -1, w).to(torch.int64)
    yi, xi = torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)
    n = torch.arange(mask.shape[0], device=mask.device)[:, None]
    inside = mask.reshape(mask.shape[0], -1)[n, yi * w + xi]
    return samples, valid & inside
