"""Test-time augmentation of ``plumekit/infer/tta.py``: D4-averaged serving.

Each tile batch is expanded to its 8 dihedral views (4 rotations, each
with and without a flip), run through ONE forward at 8× the batch,
inverse-transformed, and the per-pixel probabilities averaged. The result
goes back through the inverse sigmoid, so the wrapper keeps the logits
contract of :func:`plumekit_torch.infer.make_multi_granule_infer`. It
composes with every forward of ``predict_model``: plain, ``--fused`` (K6),
a ``use_mega`` checkpoint (K7) and ``--int8`` (Q1, Q2), each launched once
per forward as without it.
"""

from __future__ import annotations

from typing import Callable

import torch

#: the 8 elements of D4 as (k_rot90, flip), in the JAX package's order; the
#: inverse of (k, f) undoes the rotation first, then the flip
_D4 = [(k, f) for f in (False, True) for k in range(4)]


def make_tta_apply(apply_fn: Callable) -> Callable:
    """Wrap ``apply_fn(variables, (B, t, t, C)) -> (B, t, t, 1)`` logits in
    D4 test-time augmentation, at 8× the forward's batch. Tiles must be
    square; anything else raises ``ValueError``."""

    def tta_apply(variables, x):
        if x.ndim != 4 or x.shape[1] != x.shape[2]:
            raise ValueError(
                f"TTA needs square (B, t, t, C) tiles, got {tuple(x.shape)}:"
                " 90-degree rotations must preserve the tile shape")
        views = []
        for k, f in _D4:
            v = torch.flip(x, dims=(2,)) if f else x
            views.append(torch.rot90(v, k, dims=(1, 2)) if k else v)
        logits = apply_fn(variables, torch.cat(views, dim=0))
        back = []
        for (k, f), part in zip(_D4, logits.chunk(len(_D4), dim=0)):
            if k:
                part = torch.rot90(part, -k, dims=(1, 2))
            if f:
                part = torch.flip(part, dims=(2,))
            back.append(part)
        probs = torch.sigmoid(torch.stack(back).float()).mean(dim=0)
        # the clip bounds the logit at about ±16 instead of inf
        probs = probs.clamp(1e-7, 1.0 - 1e-7)
        return torch.log(probs) - torch.log1p(-probs)

    return tta_apply


__all__ = ["make_tta_apply"]
