"""Connected-component labelling in plain PyTorch (``plumekit/ops/ccl.py``).

The label contract of the JAX package (``ops/ccl.py:111-115``): int32
labels, 0 for background, and every component labelled with its smallest
flat pixel id ``r * W + c`` plus one. That fixpoint is unique, so any
algorithm that reaches it gives the same labels bit for bit.

This one is min-label hooking with pointer jumping: each pixel holds the
id of a pixel in its component; every round takes the minimum over the
pixel's neighbourhood, hooks the pixel's root to that minimum
(``scatter_reduce`` amin), then jumps pointers until every pixel points at
a root. Labels only decrease and always name a pixel of the component, so
the loop stops exactly at the contract's fixpoint. It is the plain version
of the K1/K4 kernel (:mod:`plumekit_torch.ops.kernels.ccl_sweep`).
"""

from __future__ import annotations

import torch

#: background value in returned label images
BACKGROUND = 0

_OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_OFFSETS_8 = _OFFSETS_4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _neighbour_min(lbl2d: torch.Tensor, sentinel: int, connectivity: int):
    h, w = lbl2d.shape
    pad = torch.full((h + 2, w + 2), sentinel, dtype=lbl2d.dtype,
                     device=lbl2d.device)
    pad[1:-1, 1:-1] = lbl2d
    best = lbl2d.clone()
    for dr, dc in (_OFFSETS_8 if connectivity == 2 else _OFFSETS_4):
        torch.minimum(best, pad[1 + dr:1 + dr + h, 1 + dc:1 + dc + w],
                      out=best)
    return best


def connected_components(mask: torch.Tensor, connectivity: int = 2):
    """Label a (H, W) boolean mask: 8-connected for ``connectivity=2``
    (skimage's 2-D default, used throughout the reference), 4-connected
    for 1. Returns (H, W) int32 labels under the contract above."""
    if mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError(f"want a (H, W) bool mask, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    h, w = mask.shape
    n = h * w
    fg = mask.reshape(-1)
    # labels are int64 (torch indexes with int64); slot n is the background
    # sentinel, pointing at itself so that a jump from background stays put
    fg_ext = torch.cat([fg, fg.new_zeros(1)])
    lbl = torch.where(fg_ext, torch.arange(n + 1, device=mask.device), n)
    while True:
        best = _neighbour_min(lbl[:n].view(h, w), n, connectivity).reshape(-1)
        best = torch.where(fg, best, n)
        new = lbl.clone()
        new[:n] = torch.minimum(new[:n], best)
        new.scatter_reduce_(0, lbl[:n][fg], best[fg], reduce="amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lbl):
            break
        lbl = new
    out = torch.where(fg_ext, lbl + 1, BACKGROUND)[:n]
    return out.view(h, w).to(torch.int32)
