"""UNet++, the nested dense-skip U-Net (``plumekit/models/unetpp.py``).

Node ``X[i][j]`` (row i at scale 1/2^i, fusion column j) is a double conv
of the concat of every earlier node of its row, ``X[i][0..j-1]``, and the
upsampled ``X[i+1][j-1]``. Column 0 is the encoder. The head reads the top
row's last node; with ``deep_supervision`` a head on each of ``X[0][1..L]``
and their mean is the output. The interface is the U-Net's: NHWC in, fp32
logits (B, H, W, out_channels) out, H and W divisible by ``2**depth``.

Modules are keyed by the flax names, so ``plumekit_torch.convert`` maps them
one to one: ``nodes["x_{i}_{j}"]``, ``ups["up_{i}_{j}"]``, and
``heads["head"]`` or ``heads["head_{j}"]``. The module always holds the full
depth-``cfg.depth`` grid; a ``prune_level`` only stops the forward at
:func:`effective_level`, so a full checkpoint loads strictly into a pruned
model (flax ignores the unused subtrees). The forward never reads
``use_pallas`` or ``use_mega``, as the JAX module does not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.unet import DTYPES, DoubleConv, _at_least_fp32


def effective_level(cfg: UNetConfig) -> int:
    """The fusion column the forward tops out at: ``prune_level`` when set
    (validated: UNet++ with deep supervision only, 1 ≤ L ≤ depth), else
    ``depth``. Also the pruned net's downsampling depth."""
    if cfg.prune_level is None:
        return cfg.depth
    if cfg.arch != "unetpp" or not cfg.deep_supervision:
        raise ValueError(
            "prune_level is a serving-time mode of the deep-supervised "
            "UNet++ (side heads on every fusion column are what make the "
            f"truncated grid servable); arch={cfg.arch!r} "
            f"deep_supervision={cfg.deep_supervision}")
    if not 1 <= cfg.prune_level <= cfg.depth:
        raise ValueError(
            f"prune_level must be in [1, depth={cfg.depth}], "
            f"got {cfg.prune_level}")
    return cfg.prune_level


def decoder_nodes(level: int):
    """The fusion nodes ``(i, j)``, j ≥ 1, of a grid topping out at
    ``level``, in the forward's order: column by column, each from the top
    row down. Node X[i][j] reads ``j`` same-scale planes and the upsample
    of X[i+1][j-1]. Every replay of the grid (the module, its FLOPs, the
    int8 calibration, quantization and apply, the kernel timings) walks
    this order."""
    for j in range(1, level + 1):
        for i in range(level + 1 - j):
            yield i, j


def head_names(cfg: UNetConfig, level: int):
    """``{column: head name}`` of the heads a forward topping out at
    ``level`` reads."""
    if cfg.deep_supervision:
        return {j: f"head_{j}" for j in range(1, level + 1)}
    return {level: "head"}


class UNetPP(nn.Module):
    """Configurable-depth UNet++ over NHWC tensors."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        depth = cfg.depth
        feats = [cfg.base_features * 2**i for i in range(depth + 1)]
        self.nodes = nn.ModuleDict()
        self.ups = nn.ModuleDict()
        for i in range(depth + 1):
            cin = cfg.in_channels if i == 0 else feats[i - 1]
            self.nodes[f"x_{i}_0"] = DoubleConv(cin, feats[i], cfg.norm,
                                                cfg.group_norm_groups)
        for i, j in decoder_nodes(depth):
            self.ups[f"up_{i}_{j}"] = nn.ConvTranspose2d(
                feats[i + 1], feats[i], 2, stride=2)
            self.nodes[f"x_{i}_{j}"] = DoubleConv(
                (j + 1) * feats[i], feats[i], cfg.norm,
                cfg.group_norm_groups)
        self.heads = nn.ModuleDict({
            name: nn.Conv2d(feats[0], cfg.out_channels, 1)
            for name in head_names(cfg, depth).values()})

    def forward(self, x):
        cfg = self.cfg
        level = effective_level(cfg)
        dtype = DTYPES[cfg.compute_dtype]
        h = x.permute(0, 3, 1, 2).to(dtype,
                                     memory_format=torch.channels_last)
        grid = {}
        for i in range(level + 1):
            if i:
                h = F.max_pool2d(h, 2)
            h = self.nodes[f"x_{i}_0"](h)
            grid[(i, 0)] = h
        for i, j in decoder_nodes(level):
            up = self.ups[f"up_{i}_{j}"]
            u = F.conv_transpose2d(grid[(i + 1, j - 1)], up.weight.to(dtype),
                                   up.bias.to(dtype), stride=2)
            cat = torch.cat([grid[(i, k)] for k in range(j)] + [u], dim=1)
            grid[(i, j)] = self.nodes[f"x_{i}_{j}"](cat)
        outs = []
        for j, name in head_names(cfg, level).items():
            node = _at_least_fp32(grid[(0, j)])
            head = self.heads[name]
            outs.append(F.conv2d(node, head.weight.to(node.dtype),
                                 head.bias.to(node.dtype)))
        # the JAX module's order: sum of the side heads, then the mean
        logits = sum(outs) / len(outs) if cfg.deep_supervision else outs[0]
        return logits.permute(0, 2, 3, 1)
