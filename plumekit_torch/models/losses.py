"""Segmentation losses and metrics of ``plumekit/models/losses.py``: dice
+ BCE and IoU, all in fp32, with the same numerically stable BCE form."""

from __future__ import annotations

import torch


def bce_with_logits(logits, labels, mask=None):
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
        return per_px.sum() / torch.clamp_min(mask.sum(), 1.0)
    return per_px.mean()


def dice_loss(logits, labels, mask=None, eps: float = 1.0):
    """Soft dice loss (1 − dice coefficient), batch-pooled."""
    probs = torch.sigmoid(logits.float())
    labels = labels.float()
    if mask is not None:
        probs = probs * mask
        labels = labels * mask
    inter = (probs * labels).sum()
    union = probs.sum() + labels.sum()
    return 1.0 - (2.0 * inter + eps) / (union + eps)


def dice_bce_loss(logits, labels, dice_weight: float = 0.5, mask=None,
                  label_smooth: float = 0.0):
    """``dice_weight``·dice + (1 − ``dice_weight``)·BCE. ``label_smooth`` ε
    softens the BCE targets to ``y·(1−2ε)+ε``; dice keeps hard targets."""
    bce_labels = labels
    if label_smooth:
        bce_labels = labels * (1.0 - 2.0 * label_smooth) + label_smooth
    return (dice_weight * dice_loss(logits, labels, mask)
            + (1.0 - dice_weight) * bce_with_logits(logits, bce_labels, mask))


def iou(pred_mask, true_mask, eps: float = 1e-8):
    """Intersection-over-union of boolean masks (any matching shapes)."""
    pred = pred_mask.float()
    true = true_mask.float()
    inter = (pred * true).sum()
    union = torch.maximum(pred, true).sum()
    return (inter + eps) / (union + eps)
