"""The collectives of data-parallel training over a ``torch.distributed``
process group, one process (rank) per device.

Under JAX's data mesh the step is one program over the global batch and
XLA inserts the reductions. Here each rank holds its slice of the global
batch and a replica of the parameters, and the step reduces what the global
batch's arithmetic needs:

* the batch-norm statistics of the global batch (per-channel sums, sums of
  squares and counts; ``models/unet._global_batch_norm``);
* the sums the loss and the IoU are ratios of (``models/losses.py``);
* the parameter gradients, once before the optimizer step.

:func:`all_reduce_sum` is differentiable, and its backward sums the
incoming gradients over the ranks too. Every rank forms the same global
loss from the reduced sums, so the loss's reduction hands each rank D times
the gradient of its share: :func:`average_gradients` sums the ranks'
gradients and divides by D, which gives the one-process step's gradient
(``tests/test_torch_train_dp.py`` holds the scale against it).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def world(group=None) -> Tuple[int, int]:
    """(rank, size) of this process in ``group`` (the default group when
    None)."""
    return dist.get_rank(group), dist.get_world_size(group)


def rank_slice(n: int, group=None) -> slice:
    """This rank's part of a global dim of ``n``: equal parts in rank
    order."""
    rank, size = world(group)
    if n % size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{size} ranks")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable (see
    the module docstring for its gradient's scale)."""
    return _AllReduceSum.apply(x, group)


def set_batch_stats_group(model: torch.nn.Module, group) -> None:
    """Make every batch norm of ``model`` take its train-mode statistics
    over the global batch of ``group`` (None: back to the local batch)."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.stats_group = group


def average_gradients(model: torch.nn.Module, group=None) -> None:
    """Every parameter's gradient summed over the ranks and divided by
    their count, in one reduction of one flat buffer."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def broadcast_state(model: torch.nn.Module, group=None,
                    src: int = 0) -> None:
    """Every parameter and buffer of ``model`` set to rank ``src``'s."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=src, group=group)


__all__ = ["all_reduce_sum", "average_gradients", "broadcast_state",
           "rank_slice", "set_batch_stats_group", "world"]
