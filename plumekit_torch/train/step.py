"""Train and eval steps of ``plumekit/train/step.py``, eager.

The step augments, runs the train-mode forward, takes
``dice_bce_loss``, and applies one AdamW update; its metrics are the loss
and ``iou(sigmoid(logits) > 0.5, ys > 0.5)``, left on the device until
the loop logs them. The JAX package scans K steps inside one program
(``make_multi_train_step``); here a chunk of K steps is K calls of the
step, with the same data and augmentation per step. With ``dequant`` a
step takes the quantized transfer's ``(q, lo, scale, y8)`` and decodes it
on the device first (``_dequant_batch``). The training step
reaches no hand-written kernel, as in the JAX package (its forward takes
the fused routes only at inference): the forward and backward are plain
PyTorch. The eval step runs the eval-mode forward, which takes them.

With the recorder on (``utils/timers``), a step records the span
``train.step`` and inside it, in order, ``train.augment``,
``train.forward`` (model and loss), ``train.backward`` (clearing the
gradients, backward, and their average under data parallelism) and
``train.optimizer`` (AdamW and the schedule), each with its device time;
and the counter ``train.steps``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from plumekit_torch.models.losses import dice_bce_loss, iou
from plumekit_torch.ops.quant import dequantize
from plumekit_torch.train.augment import augment_batch
from plumekit_torch.train.state import TrainState
from plumekit_torch.utils import timers


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's random draws, on ``device``: a function
    of (seed, step) alone, so a resumed run draws what the uninterrupted
    run drew at that step (the JAX package folds the step into its key)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(state[0]))
    return generator


def _dequant_batch(batch):
    """``(q, lo (..., C), scale (..., C), y8)`` of the quantized transfer ->
    ``(xs, ys)`` float32 on their device; masks decode as ``y8 / 255``
    (exact for {0, 1} labels). The ellipsis covers a leading steps axis."""
    q, lo, scale, y8 = batch
    xs = dequantize(q, lo[..., None, None, :], scale[..., None, None, :])
    return xs, y8.to(torch.float32) * (1.0 / 255.0)


def make_train_step(dice_weight: float = 0.5, augment: bool = True,
                    label_smooth: float = 0.0, dequant: bool = False,
                    group=None):
    """Returns ``step(state, xs, ys, generator) -> (state, metrics)``;
    ``state`` is updated in place. xs: (B, T, T, C), ys: (B, T, T, 1) on
    the model's device; ``generator`` draws the augmentation codes
    (:func:`step_generator`; unused without augmentation). With
    ``dequant`` the step is ``step(state, (q, lo, scale, y8), generator)``
    and decodes the batch before augmenting it.

    With ``group`` (a ``torch.distributed`` process group) the step is the
    data-parallel one: each rank passes its part of the global batch, in
    rank order, and a replica of the same parameters; batch norm, the loss
    and the IoU take the global batch's sums, the augmentation codes are
    drawn for the global batch, and the gradients are averaged over the
    ranks before AdamW (``parallel/data_parallel.py``), so the step equals
    the one-process step on the global batch."""
    reduce, shard = None, (0, 1)
    if group is not None:
        from plumekit_torch.parallel import data_parallel as dp

        reduce = functools.partial(dp.all_reduce_sum, group=group)
        shard = dp.world(group)

    def core(state: TrainState, xs, ys,
             generator: Optional[torch.Generator]):
        timers.count("train.steps")
        with timers.span("train.step", step=state.step):
            return one_step(state, xs, ys, generator)

    def one_step(state: TrainState, xs, ys,
                 generator: Optional[torch.Generator]):
        dev = xs.device
        with timers.span("train.augment", device=dev):
            if augment:
                xs, ys = augment_batch(generator, xs, ys, shard)
        with timers.span("train.forward", device=dev):
            state.model.train()
            if group is not None:
                dp.set_batch_stats_group(state.model, group)
            logits = state.model(xs)
            loss = dice_bce_loss(logits, ys, dice_weight,
                                 label_smooth=label_smooth, reduce=reduce)
        with timers.span("train.backward", device=dev):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:
                dp.average_gradients(state.model, group)
        with timers.span("train.optimizer", device=dev):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "iou": iou(torch.sigmoid(logits) > 0.5, ys > 0.5,
                                  reduce=reduce)}
        return state, metrics

    if not dequant:
        return core

    def step(state: TrainState, batch, generator):
        return core(state, *_dequant_batch(batch), generator)

    return step


def make_multi_train_step(dice_weight: float = 0.5, augment: bool = True,
                          label_smooth: float = 0.0, seed: int = 0,
                          dequant: bool = False, group=None):
    """Returns ``multi(state, chunk, steps) -> (state, last_metrics)``: one
    step per global step index in ``steps`` over the chunk's batches, each
    with the augmentation codes of :func:`step_generator` of (seed, step).
    ``chunk`` holds (K, B, ...) tensors: ``(xs, ys)``, or with ``dequant``
    ``(q, lo, scale, y8)``, each batch decoded as its step begins. With
    ``group``, this rank's parts of the global batches (see
    :func:`make_train_step`)."""
    step = make_train_step(dice_weight, augment, label_smooth, dequant,
                           group)

    def multi(state: TrainState, chunk, steps):
        metrics = None
        device = chunk[0].device
        for i, s in enumerate(steps):
            batch = tuple(t[i] for t in chunk)
            generator = step_generator(seed, int(s), device)
            if dequant:
                state, metrics = step(state, batch, generator)
            else:
                state, metrics = step(state, *batch, generator)
        return state, metrics

    return multi


def make_eval_step(dice_weight: float = 0.5, group=None):
    """``dice_weight`` must match the training objective, so that the eval
    loss compares with the train loss. With ``group`` each rank passes its
    part of the global batch and every rank gets the global batch's loss
    and IoU, the same on every rank."""
    reduce = None
    if group is not None:
        from plumekit_torch.parallel.data_parallel import all_reduce_sum

        reduce = functools.partial(all_reduce_sum, group=group)

    def eval_step(state: TrainState, xs, ys) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(xs)
                return {"loss": dice_bce_loss(logits, ys,
                                              dice_weight=dice_weight,
                                              reduce=reduce),
                        "iou": iou(torch.sigmoid(logits) > 0.5, ys > 0.5,
                                   reduce=reduce)}
        finally:
            model.train(was_training)

    return eval_step


__all__ = ["make_eval_step", "make_multi_train_step", "make_train_step",
           "step_generator"]
