"""Spatially sharded whole-granule inference (``plumekit/infer/sharded.py``).

One large raster is split over the mesh's (y, x) grid; each device extends
its block with a halo of its neighbours' pixels
(:mod:`plumekit_torch.parallel.halo`), runs the forward on the extended
block with its own replica of the variables, and crops the halo back off.
With ``halo`` at least the network's receptive-field radius the stitched
output equals unsharded inference except near the true image border, where
the halo is zeros and each layer's own padding is not.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from plumekit_torch.parallel.halo import exchange_halo_blocks, split_blocks
from plumekit_torch.parallel.mesh import Mesh, run_per_device


def choose_halo(min_halo: int, block_h: int, depth: int,
                block_w: int | None = None) -> int:
    """Smallest halo ≥ max(min_halo, 1) making (block + 2·halo) divisible
    by 2**depth (the U-Net's downsampling factor) for the height and (when
    given) the width. Never returns 0: a zero halo would slice ``[-0:]`` and
    ``[:-0]`` wrongly, and :func:`make_sharded_infer` rejects it."""
    div = 2**depth
    halo = max(min_halo, 1)
    # 2·halo steps through even offsets only: after div more steps every
    # reachable residue class has been tried
    limit = halo + div
    while ((block_h + 2 * halo) % div
           or (block_w is not None and (block_w + 2 * halo) % div)):
        halo += 1
        if halo > limit:
            raise ValueError(
                f"no halo >= {max(min_halo, 1)} makes blocks "
                f"({block_h}, {block_w}) + 2*halo divisible by {div}; "
                "pad the image or choose a different shard grid")
    return halo


def make_sharded_infer(apply_fn: Callable, mesh: Mesh, halo: int,
                       threshold: float = 0.5):
    """Build ``infer(replicas, image (H, W, C)) -> (probs (H, W), mask)``
    with the image split over the mesh's (y, x) grid. ``replicas`` holds the
    variables of each grid slot, row by row, on that slot's device. H and W
    must divide by the grid, and each block plus 2·halo by the U-Net's
    2**depth (:func:`choose_halo` with both block dims).
    ``apply_fn(variables, batch)`` → (B, h, w, 1) logits. The probabilities
    are gathered on the first slot's device."""
    if halo < 1:
        raise ValueError(
            "halo must be >= 1 (a zero halo would silently double the "
            "block through the -0 slice semantics); use choose_halo")
    grid = mesh.grid()
    devices = [d for row in grid for d in row]

    @torch.no_grad()
    def block_forward(variables, padded):
        logits = apply_fn(variables, padded[None])[0]
        probs = torch.sigmoid(logits[..., 0].float())
        return probs[halo:-halo, halo:-halo]

    def infer(replicas: Sequence, image):
        if len(replicas) != len(devices):
            raise ValueError(f"{len(replicas)} replicas for a grid of "
                             f"{len(devices)} devices")
        blocks = split_blocks(mesh, image)
        if halo > min(blocks[0][0].shape[0], blocks[0][0].shape[1]):
            raise ValueError(
                f"halo {halo} exceeds per-shard block "
                f"{tuple(blocks[0][0].shape[:2])}; use fewer shards or a "
                "larger image")
        padded = [b for row in exchange_halo_blocks(blocks, halo)
                  for b in row]
        probs = run_per_device(block_forward, devices, replicas, padded)
        nx = len(grid[0])
        out = devices[0]
        probs = torch.cat([torch.cat([p.to(out) for p in probs[i:i + nx]],
                                     dim=1)
                           for i in range(0, len(probs), nx)], dim=0)
        return probs, probs > threshold

    return infer


__all__ = ["choose_halo", "make_sharded_infer"]
