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

import numpy as np
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


def connected_components(mask: torch.Tensor, connectivity: int = 2,
                         init_labels: torch.Tensor = None):
    """Label a (H, W) boolean mask: 8-connected for ``connectivity=2``
    (skimage's 2-D default, used throughout the reference), 4-connected
    for 1. Returns (H, W) int32 labels under the contract above.

    ``init_labels`` warm-starts the loop from labels in this format of a
    subset of ``mask`` (a tighter threshold's): a pixel whose init label
    names a pixel of its own component starts from it, so the loop pays
    only for the bridges the looser mask adds. The result is the cold
    labelling's. A start is never above the pixel's own id, so the
    pointers stay a forest."""
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
    ids = torch.arange(n + 1, device=mask.device)
    if init_labels is not None:
        seeded = init_labels.reshape(-1).to(torch.int64) - 1
        seeded = torch.where(seeded >= 0, torch.minimum(seeded, ids[:n]),
                             ids[:n])
        ids = torch.cat([seeded, ids[n:]])
    lbl = torch.where(fg_ext, ids, n)
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


def connected_components_host(mask, connectivity: int = 2) -> np.ndarray:
    """Host labelling by the native union-find
    (:func:`plumekit_torch.native.ccl_label`; ``scipy.ndimage.label``
    where the library is not built): compact int32 labels 1..N in raster
    order, the same partition as :func:`connected_components` with other
    label values."""
    from plumekit_torch import native

    return native.ccl_label(np.asarray(mask) != 0, connectivity)[0]


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count of every component, addressed by label value: an
    (H·W + 1,) int32 map, index 0 counting the background."""
    h, w = labels.shape
    return torch.bincount(labels.reshape(-1).to(torch.int64),
                          minlength=h * w + 1).to(torch.int32)


def remove_small_components(labels: torch.Tensor,
                            min_size: int) -> torch.Tensor:
    """Zero the components smaller than ``min_size`` pixels (skimage's
    ``remove_small_objects`` on the fire-cluster rasters)."""
    sizes = component_sizes(labels)
    keep = sizes[labels.to(torch.int64)] >= min_size
    return torch.where(keep & (labels != BACKGROUND), labels,
                       torch.zeros_like(labels))
