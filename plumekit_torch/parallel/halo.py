"""Halo exchange for spatially sharded rasters (``plumekit/parallel/halo.py``).

A (H, W, ...) tensor sharded over the mesh's (y, x) axes is a grid of
blocks, each on its device. Before an op with a spatial receptive field
(a conv, a morphology) each block needs ``halo`` rows and columns of its
neighbours. The exchange runs in two phases, rows then columns: the second
moves the already row-extended blocks sideways, so the corner blocks travel
without diagonal copies. A neighbour's rows are a device-to-device copy.

Blocks at the mesh's edges are padded with zeros, which matches "SAME"
convolution at the true image border. There is no fill parameter: an op
that needs another border identity (+inf for a min-erosion) biases its
input around zero instead.
"""

from __future__ import annotations

from typing import List

import torch

from plumekit_torch.parallel.mesh import Mesh


def exchange_halo_blocks(blocks: List[List[torch.Tensor]], halo: int
                         ) -> List[List[torch.Tensor]]:
    """The (y, x) grid of (h, w, ...) blocks, each on its device → the grid
    of (h + 2·halo, w + 2·halo, ...) blocks with their neighbours' halos
    (zeros at the mesh's edges)."""
    if halo < 1:
        # block[-0:] would select the whole block and double every shard
        raise ValueError(f"halo must be >= 1, got {halo}")
    first = blocks[0][0]
    if halo > min(first.shape[0], first.shape[1]):
        raise ValueError(
            f"halo {halo} exceeds the local block {tuple(first.shape[:2])}; "
            "use fewer shards or a larger image")
    ny, nx = len(blocks), len(blocks[0])
    # phase 1: rows. Each block receives its upper neighbour's last rows
    # (its top halo) and its lower neighbour's first rows
    rows = []
    for iy in range(ny):
        row = []
        for ix in range(nx):
            b = blocks[iy][ix]
            top = (blocks[iy - 1][ix][-halo:].to(b.device) if iy > 0
                   else torch.zeros_like(b[:halo]))
            bot = (blocks[iy + 1][ix][:halo].to(b.device) if iy < ny - 1
                   else torch.zeros_like(b[:halo]))
            row.append(torch.cat([top, b, bot], dim=0))
        rows.append(row)
    # phase 2: columns, the row halos included, so corners travel too
    out = []
    for iy in range(ny):
        row = []
        for ix in range(nx):
            b = rows[iy][ix]
            left = (rows[iy][ix - 1][:, -halo:].to(b.device) if ix > 0
                    else torch.zeros_like(b[:, :halo]))
            right = (rows[iy][ix + 1][:, :halo].to(b.device)
                     if ix < nx - 1 else torch.zeros_like(b[:, :halo]))
            row.append(torch.cat([left, b, right], dim=1))
        out.append(row)
    return out


def split_blocks(mesh: Mesh, x) -> List[List[torch.Tensor]]:
    """(H, W, ...) tensor or numpy array → the grid of its (H/ny, W/nx,
    ...) blocks, each on its device of ``mesh.grid()``."""
    grid = mesh.grid()
    ny, nx = len(grid), len(grid[0])
    if x.shape[0] % ny or x.shape[1] % nx:
        raise ValueError(
            f"array {tuple(x.shape[:2])} does not divide by the mesh "
            f"({ny}, {nx}); pad the raster first")
    bh, bw = x.shape[0] // ny, x.shape[1] // nx
    return [[torch.as_tensor(x[iy * bh:(iy + 1) * bh,
                               ix * bw:(ix + 1) * bw]).to(grid[iy][ix])
             for ix in range(nx)] for iy in range(ny)]


def halo_pad(mesh: Mesh, x, halo: int) -> List[List[torch.Tensor]]:
    """Host-callable: a spatially sharded (H, W, ...) array → its blocks
    extended by their neighbours' halos, as the (y, x) grid of
    (h + 2·halo, w + 2·halo, ...) tensors on their devices. Most callers
    want :func:`plumekit_torch.infer.sharded.make_sharded_infer`."""
    return exchange_halo_blocks(split_blocks(mesh, x), halo)


__all__ = ["exchange_halo_blocks", "halo_pad", "split_blocks"]
