"""Binary morphology over the last two axes (``plumekit/ops/morphology.py``).

Border semantics follow skimage, as the reference's singleton cleanup
(``plume_identifier_rg.py:146-147``): erosion counts a neighbour outside
the image as foreground, dilation counts it as background. Leading axes
broadcast, so a (T, H, W) threshold stack is one call.
"""

from __future__ import annotations

import torch


def _shift2d(x: torch.Tensor, dr: int, dc: int, fill: bool) -> torch.Tensor:
    """``out[..., r, c] = x[..., r - dr, c - dc]``, ``fill`` where that
    falls outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] = \
        x[..., max(-dr, 0):h + min(-dr, 0), max(-dc, 0):w + min(-dc, 0)]
    return out


_CROSS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def binary_erosion(mask: torch.Tensor, border_value: bool = True):
    """Cross-footprint erosion."""
    out = mask.clone()
    for dr, dc in _CROSS:
        out &= _shift2d(mask, dr, dc, border_value)
    return out


def binary_dilation(mask: torch.Tensor, border_value: bool = False):
    """Cross-footprint dilation."""
    out = mask.clone()
    for dr, dc in _CROSS:
        out |= _shift2d(mask, dr, dc, border_value)
    return out


def binary_opening_cross(mask: torch.Tensor) -> torch.Tensor:
    """Erosion then dilation: the mask cleanup of ``generate_mask_dict``
    (``plume_identifier_rg.py:143-148``)."""
    return binary_dilation(binary_erosion(mask))


def binary_dilation_square(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Dilation with a ``size``×``size`` square footprint, border False,
    separably as a row-window then a column-window OR."""
    if size % 2 != 1:
        raise ValueError("square footprint size must be odd")
    half = size // 2
    rows = mask.clone()
    for d in range(1, half + 1):
        rows |= _shift2d(mask, d, 0, False)
        rows |= _shift2d(mask, -d, 0, False)
    out = rows.clone()
    for d in range(1, half + 1):
        out |= _shift2d(rows, 0, d, False)
        out |= _shift2d(rows, 0, -d, False)
    return out
