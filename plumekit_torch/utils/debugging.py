"""Numerics guard (``plumekit/utils/debugging.py``): run a function under a
dispatch mode that stops at the first op producing a NaN.

The JAX package wraps a function in ``checkify`` with its float and index
checks. Here every op that reaches PyTorch's dispatcher passes through
:class:`_NanCheck`, the ``plumekit::`` custom ops (K5, K6, K7, Q1, Q2)
included, whose outputs are checked as a whole. A debugging aid:
production paths call the raw function.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN produced by {func} (output of shape "
                    f"{tuple(t.shape)}, {t.dtype}, on {t.device})")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` with NaN checks: the returned callable takes the same
    arguments and raises ``FloatingPointError`` naming the op at the first
    op whose floating output holds a NaN.

    Each check reads its result back, so the card waits at every op: use
    it to find a fault, not to serve. An index out of range already raises
    in eager PyTorch on the CPU; on the card it trips a device-side assert,
    which is reported at a later synchronisation (the NaN check's read-back
    is one) and leaves the CUDA context unusable, so rerun the failing call
    with ``CUDA_LAUNCH_BLOCKING=1`` or on the CPU to find the op. The
    ``ctypes`` kernels of the identify path (K1-K4, P1) are no ops of the
    dispatcher: only the ops around them are checked."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NanCheck():
            return fn(*args, **kwargs)

    return wrapper
