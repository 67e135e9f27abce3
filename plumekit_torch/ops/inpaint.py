"""Nearest-valid-pixel in-painting by jump flooding
(``plumekit/ops/inpaint.py``).

The gaussian detector fills its -999 null pixels with the nearest valid
AOD (``plume_identifier_gaussian_profile.py:451-461``). Jump flooding does
it in O(log max(H, W)) passes: every pixel carries the coordinates of its
best seed so far and, per pass, looks at the seeds of eight neighbours
``step`` pixels away. The passes, the neighbour order and the strict
compare are the JAX package's, so the filled image is equal to its output
bit for bit: candidates come from ``torch.roll``, which wraps across the
image border as ``jnp.roll`` does, and are measured by their true
coordinates, so a wrapped candidate is only ever a far one.
"""

from __future__ import annotations

import torch


def nearest_fill(image: torch.Tensor, invalid_mask: torch.Tensor):
    """Replace the ``invalid_mask`` pixels of an (H, W) image with the value
    of the nearest valid pixel (squared-euclidean metric). If every pixel
    is invalid the image comes back unchanged."""
    h, w = image.shape
    device = image.device
    rr = torch.arange(h, dtype=torch.int32, device=device)[:, None] \
        .expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=device)[None, :] \
        .expand(h, w)
    valid = ~invalid_mask

    big = 2 * (h * h + w * w) + 1          # fits int32 up to 8192²
    minus_one = torch.full((), -1, dtype=torch.int32, device=device)
    big_t = torch.full((), big, dtype=torch.int32, device=device)
    br = torch.where(valid, rr, minus_one)
    bc = torch.where(valid, cc, minus_one)
    bd = torch.where(valid, torch.zeros_like(big_t), big_t)

    s = 1
    while s < max(h, w):
        s *= 2
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)                        # the JFA+1 refinement pass

    for step in steps:
        # each neighbour's candidate is rolled from the running state, the
        # earlier neighbours of this pass included, as in the JAX loop
        for dr in (-step, 0, step):
            for dc in (-step, 0, step):
                if dr == 0 and dc == 0:
                    continue
                cr = torch.roll(br, (dr, dc), dims=(0, 1))
                ccand = torch.roll(bc, (dr, dc), dims=(0, 1))
                d = (rr - cr) ** 2 + (cc - ccand) ** 2
                d = torch.where(cr >= 0, d, big_t)
                better = d < bd
                br = torch.where(better, cr, br)
                bc = torch.where(better, ccand, bc)
                bd = torch.where(better, d, bd)

    found = br >= 0
    flat = br.clamp(0, h - 1).long() * w + bc.clamp(0, w - 1).long()
    filled = image.reshape(-1)[flat]
    return torch.where(invalid_mask & found, filled, image)
