"""U-Net segmentation model (``plumekit/models/unet.py``).

The public interface is NHWC, as in the JAX package: ``UNet(cfg)(x)`` takes
(B, H, W, in_channels) and returns fp32 logits (B, H, W, out_channels), with
H and W divisible by ``2**depth``. Parameters are fp32 masters cast to the
compute dtype per op. Inside, the plain forward runs NCHW tensors in the
channels-last memory format.

``self.training`` is the JAX module's ``train`` argument. In eval mode
batch norm uses the running statistics, and ``cfg.use_mega`` routes an
eligible batch through the whole-forward kernel and ``cfg.use_pallas``
through the fused double-conv kernel, in that order, as the JAX module
reads its flags. In train mode the plain forward always runs, and batch
norm is flax's ``nn.BatchNorm(use_running_average=False)``: it normalises
with the batch mean and biased variance, computed in fp32, and moves the
running buffers as ``ra = 0.99·ra + 0.01·stat`` (flax's momentum sense,
the biased variance; torch's ``momentum`` means 1 − flax's and its
running update uses the unbiased variance, which :func:`_batch_norm`
corrects).

Layer order mirrors the flax module tree, which ``plumekit_torch.convert``
maps one to one: ``blocks[i]`` is ``DoubleConv_i`` (encoder, bottleneck,
then decoder), ``ups[u]`` is ``ConvTranspose_u``, ``head`` is ``head``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from plumekit_torch.config.train import UNetConfig

#: compute dtypes; "float64" is the port's own, a reference for checks of
#: the fp32 arithmetic (norms and the head then run in float64 too)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float64": torch.float64}

#: flax's ``nn.BatchNorm`` momentum: the running average's decay per step
BN_MOMENTUM = 0.99


def _norm(kind: str, features: int, groups: int) -> nn.Module:
    if kind == "batch":
        return nn.BatchNorm2d(features, eps=1e-5)
    if kind == "group":
        # largest group count <= the configured one that divides the
        # channel count, as the JAX package picks it
        return nn.GroupNorm(math.gcd(min(groups, features), features),
                            features, eps=1e-6)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


def _at_least_fp32(x):
    """``x`` promoted to at least fp32, as flax promotes its statistics."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _batch_norm(x, norm: nn.BatchNorm2d, training: bool):
    """Batch norm of NCHW ``x`` in at least fp32, back in ``x``'s dtype:
    with the running statistics, or with the batch's (see the module
    docstring)."""
    xf = _at_least_fp32(x)
    weight, bias = norm.weight.to(xf.dtype), norm.bias.to(xf.dtype)
    if not training:
        return F.batch_norm(xf, norm.running_mean.to(xf.dtype),
                            norm.running_var.to(xf.dtype), weight, bias,
                            False, 0.0, norm.eps).to(x.dtype)
    group = getattr(norm, "stats_group", None)
    if group is not None:
        return _global_batch_norm(xf, norm, weight, bias, group).to(x.dtype)
    # copies: autograd keeps the tensors the call moved
    mean, var = (t.to(xf.dtype, copy=True) for t in (norm.running_mean,
                                                     norm.running_var))
    y = F.batch_norm(xf, mean, var, weight, bias, True, 1 - BN_MOMENTUM,
                     norm.eps)
    with torch.no_grad():
        # torch moved the variance with the unbiased batch variance, v·n/(n
        # − 1); take back its share over flax's biased v (n values per
        # channel). Reading the statistics off the call costs no extra pass
        # over the plane
        n = xf.numel() // xf.shape[1]
        norm.running_mean.copy_(mean)
        norm.running_var.copy_(var - (var - BN_MOMENTUM * norm.running_var)
                               / n)
    return y.to(x.dtype)


def _global_batch_norm(xf, norm: nn.BatchNorm2d, weight, bias, group):
    """Train-mode batch norm of this rank's share of a batch sharded over
    the ranks of ``group`` (``parallel/data_parallel.set_batch_stats_group``)
    with the statistics of the global batch, as flax takes them under JAX's
    data mesh: per-channel sums, sums of squares and counts reduced over the
    ranks (differentiably), flax's biased variance E[x²] − E[x]² (clamped
    at 0), and the running buffers moved as flax moves them."""
    from plumekit_torch.parallel.data_parallel import all_reduce_sum

    c = xf.shape[1]
    sums = all_reduce_sum(torch.cat([
        xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
        xf.new_full((1,), xf.numel() // c)]), group)
    n = sums[-1]
    mean = sums[:c] / n
    var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
    mul = torch.rsqrt(var + norm.eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    with torch.no_grad():
        norm.running_mean.copy_(BN_MOMENTUM * norm.running_mean
                                + (1 - BN_MOMENTUM) * mean)
        norm.running_var.copy_(BN_MOMENTUM * norm.running_var
                               + (1 - BN_MOMENTUM) * var)
    return y


class DoubleConv(nn.Module):
    """(conv3x3 → norm → ReLU) × 2."""

    def __init__(self, in_features: int, features: int, norm: str,
                 groups: int = 8):
        super().__init__()
        self.conv = nn.ModuleList([
            nn.Conv2d(c, features, 3, padding=1, bias=(norm == "none"))
            for c in (in_features, features)])
        self.norm = nn.ModuleList([_norm(norm, features, groups)
                                   for _ in range(2)])

    def forward(self, x):
        """x: NCHW in the compute dtype."""
        for conv, norm in zip(self.conv, self.norm):
            bias = None if conv.bias is None else conv.bias.to(x.dtype)
            x = F.conv2d(x, conv.weight.to(x.dtype), bias, padding=1)
            if isinstance(norm, nn.BatchNorm2d):
                x = _batch_norm(x, norm, self.training)
            elif isinstance(norm, nn.GroupNorm):
                xf = _at_least_fp32(x)
                x = F.group_norm(xf, norm.num_groups,
                                 norm.weight.to(xf.dtype),
                                 norm.bias.to(xf.dtype), norm.eps).to(x.dtype)
            x = torch.relu(x)
        return x


class UNet(nn.Module):
    """Configurable-depth U-Net over NHWC tensors."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        feats = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
        blocks = [DoubleConv(cfg.in_channels, feats[0], cfg.norm,
                             cfg.group_norm_groups)]
        blocks += [DoubleConv(feats[i], feats[i + 1], cfg.norm,
                              cfg.group_norm_groups)
                   for i in range(cfg.depth)]
        self.ups = nn.ModuleList()
        for i in reversed(range(cfg.depth)):
            self.ups.append(nn.ConvTranspose2d(feats[i + 1], feats[i], 2,
                                               stride=2))
            blocks.append(DoubleConv(2 * feats[i], feats[i], cfg.norm,
                                     cfg.group_norm_groups))
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(feats[0], cfg.out_channels, 1)

    def forward(self, x):
        cfg = self.cfg
        inference = not self.training and cfg.norm == "batch"
        if inference and cfg.use_mega:
            from plumekit_torch.models.kernels.unet_mega import (
                make_mega_apply, mega_eligible)

            # the whole forward in one kernel launch where the config and
            # the tile shape allow it; an ineligible shape falls through,
            # as in the JAX package, and nothing else does
            if mega_eligible(cfg, x.shape[1], x.shape[2]):
                return make_mega_apply(cfg)(self, x)
        if inference and cfg.use_pallas:
            # the flag is read inside the module, as in the JAX package:
            # inference replays the net through the fused kernel
            from plumekit_torch.models.fused_forward import make_fused_apply

            return make_fused_apply(cfg)(self, x)
        dtype = DTYPES[cfg.compute_dtype]
        x = x.permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)
        skips = []
        for block in self.blocks[:cfg.depth]:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.blocks[cfg.depth](x)
        for u, skip in enumerate(reversed(skips)):
            up = self.ups[u]
            x = F.conv_transpose2d(x, up.weight.to(dtype), up.bias.to(dtype),
                                   stride=2)
            x = torch.cat([skip, x], dim=1)
            x = self.blocks[cfg.depth + 1 + u](x)
        x = _at_least_fp32(x)
        logits = F.conv2d(x, self.head.weight.to(x.dtype),
                          self.head.bias.to(x.dtype))
        return logits.permute(0, 2, 3, 1)


def receptive_field(depth: int) -> int:
    """Receptive-field radius of the U-Net: 6·2^depth − 4 (see the JAX
    package's ``receptive_field``)."""
    return 6 * 2**depth - 4
