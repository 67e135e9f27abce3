"""U-Net segmentation model (``plumekit/models/unet.py``), inference only.

The public interface is NHWC, as in the JAX package: ``UNet(cfg)(x)`` takes
(B, H, W, in_channels) and returns fp32 logits (B, H, W, out_channels), with
H and W divisible by ``2**depth``. Parameters are fp32 masters cast to the
compute dtype per op; normalisation uses running statistics. Inside, the
plain forward runs NCHW tensors in the channels-last memory format.

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

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


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
                x = F.batch_norm(x.float(), norm.running_mean,
                                 norm.running_var, norm.weight, norm.bias,
                                 False, 0.0, norm.eps).to(x.dtype)
            elif isinstance(norm, nn.GroupNorm):
                x = F.group_norm(x.float(), norm.num_groups, norm.weight,
                                 norm.bias, norm.eps).to(x.dtype)
            x = torch.relu(x)
        return x


class UNet(nn.Module):
    """Configurable-depth U-Net over NHWC tensors (inference)."""

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
        if cfg.use_pallas and cfg.norm == "batch":
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
        logits = F.conv2d(x.float(), self.head.weight, self.head.bias)
        return logits.permute(0, 2, 3, 1)


def receptive_field(depth: int) -> int:
    """Receptive-field radius of the U-Net: 6·2^depth − 4 (see the JAX
    package's ``receptive_field``)."""
    return 6 * 2**depth - 4
