"""Augmentation of ``plumekit/train/augment.py``: a random element of the
dihedral group D4 per sample, the same on inputs and labels.

A code in [0, 8) reads bit 0: flip the rows, bit 1: flip the columns, bit
2: transpose, applied in that order. The codes come from an explicit
``torch.Generator``, not from ``jax.random``, so the two packages draw
different codes; :func:`apply_d4` is the JAX ``_apply_d4`` for given codes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def apply_d4(xs: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """xs: (B, T, T, C); codes: (B,) integers on ``xs``' device. Selects
    per sample, so no code is read back to the host."""
    def where(bit, transformed, x):
        pick = ((codes & bit) != 0).view(-1, 1, 1, 1)
        return torch.where(pick, transformed, x)

    xs = where(1, xs.flip(1), xs)
    xs = where(2, xs.flip(2), xs)
    return where(4, xs.transpose(1, 2), xs)


def augment_batch(generator: torch.Generator, xs, ys,
                  shard: Tuple[int, int] = (0, 1)):
    """Random D4 transform per sample, identically applied to inputs and
    labels. xs: (B, T, T, C); ys: (B, T, T, 1); ``generator`` on their
    device. Under data parallelism ``xs`` is part ``rank`` of a global
    batch of ``ranks`` equal parts (``shard = (rank, ranks)``): the codes
    are drawn for the global batch, as the one-process step draws them,
    and this part's are kept."""
    rank, ranks = shard
    b = xs.shape[0]
    codes = torch.randint(0, 8, (b * ranks,), generator=generator,
                          device=generator.device)[rank * b:(rank + 1) * b]
    return apply_d4(xs, codes), apply_d4(ys, codes)


__all__ = ["apply_d4", "augment_batch"]
