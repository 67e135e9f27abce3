"""Segmentation losses and metrics of ``plumekit/models/losses.py``: dice
+ BCE and IoU, all in fp32, with the same numerically stable BCE form.

Each is a ratio of sums over the batch. Under data parallelism a rank
holds a slice of the global batch, and ``reduce`` (a differentiable sum
over the ranks, ``parallel/data_parallel.all_reduce_sum``) makes the sums
those of the global batch, so every rank forms the global loss."""

from __future__ import annotations

import torch


def _summed(sums, reduce):
    """The scalar ``sums`` stacked, reduced over the ranks with ``reduce``
    when it is given, and unstacked."""
    sums = torch.stack(sums)
    return sums if reduce is None else reduce(sums)


def bce_with_logits(logits, labels, mask=None, reduce=None):
    """Mean binary cross-entropy over (optionally masked) pixels."""
    logits = logits.float()
    labels = labels.float()
    # numerically stable: max(l,0) - l*y + log1p(exp(-|l|)). At l = 0 the
    # gradient follows JAX's conventions (jnp.maximum splits it, jnp.abs
    # takes +1): a pixel whose last ReLU features are all zero has a logit
    # of exactly the head's bias, 0 at initialisation
    abs_l = torch.where(logits >= 0, logits, -logits)
    per_px = (torch.maximum(logits, torch.zeros_like(logits))
              - logits * labels + torch.log1p(torch.exp(-abs_l)))
    if mask is not None:
        per_px = per_px * mask
        count = mask.sum().to(per_px.dtype)
    else:
        count = per_px.new_tensor(float(per_px.numel()))
    total, count = _summed([per_px.sum(), count], reduce)
    return total / torch.clamp_min(count, 1.0)


def dice_loss(logits, labels, mask=None, eps: float = 1.0, reduce=None):
    """Soft dice loss (1 − dice coefficient), batch-pooled."""
    probs = torch.sigmoid(logits.float())
    labels = labels.float()
    if mask is not None:
        probs = probs * mask
        labels = labels * mask
    inter, p_sum, l_sum = _summed([(probs * labels).sum(), probs.sum(),
                                   labels.sum()], reduce)
    return 1.0 - (2.0 * inter + eps) / (p_sum + l_sum + eps)


def dice_bce_loss(logits, labels, dice_weight: float = 0.5, mask=None,
                  label_smooth: float = 0.0, reduce=None):
    """``dice_weight``·dice + (1 − ``dice_weight``)·BCE. ``label_smooth`` ε
    softens the BCE targets to ``y·(1−2ε)+ε``; dice keeps hard targets."""
    bce_labels = labels
    if label_smooth:
        bce_labels = labels * (1.0 - 2.0 * label_smooth) + label_smooth
    return (dice_weight * dice_loss(logits, labels, mask, reduce=reduce)
            + (1.0 - dice_weight) * bce_with_logits(logits, bce_labels, mask,
                                                    reduce=reduce))


def iou(pred_mask, true_mask, eps: float = 1e-8, reduce=None):
    """Intersection-over-union of boolean masks (any matching shapes)."""
    pred = pred_mask.float()
    true = true_mask.float()
    inter, union = _summed([(pred * true).sum(),
                            torch.maximum(pred, true).sum()], reduce)
    return (inter + eps) / (union + eps)
