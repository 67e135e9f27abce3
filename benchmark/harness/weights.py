"""Seeded model weights, made on the device from ``--seed`` in one draw.

The layout is PyTorch's (``Conv2d`` weights ``(cout, cin, kh, kw)``,
``ConvTranspose2d`` weights ``(cin, cout, 2, 2)``, batch norm's four
vectors) under the module names of a U-Net or UNet++ of the config's
widths, so that the program loads them with ``load_state_dict`` and the
reference reads the same tensors. The names and shapes follow from the
config alone; nothing here imports the program."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.yardstick.flops import decoder_nodes

#: (name, shape, kind) of one tensor
Spec = Tuple[str, Tuple[int, ...], str]


def _double_conv(prefix: str, cin: int, cout: int) -> List[Spec]:
    out: List[Spec] = []
    for k, c in enumerate((cin, cout)):
        out.append((f"{prefix}.conv.{k}.weight", (cout, c, 3, 3), "conv"))
    for k in range(2):
        for field, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                            ("running_mean", "bn_mean"),
                            ("running_var", "bn_var")):
            out.append((f"{prefix}.norm.{k}.{field}", (cout,), kind))
        out.append((f"{prefix}.norm.{k}.num_batches_tracked", (), "count"))
    return out


def _up(prefix: str, cin: int, cout: int) -> List[Spec]:
    return [(f"{prefix}.weight", (cin, cout, 2, 2), "up"),
            (f"{prefix}.bias", (cout,), "up_bias")]


def _head(prefix: str, cin: int, cout: int) -> List[Spec]:
    return [(f"{prefix}.weight", (cout, cin, 1, 1), "head"),
            (f"{prefix}.bias", (cout,), "head_bias")]


def param_specs(cfg) -> List[Spec]:
    """Every tensor of the model of ``cfg`` (batch norm only), in a fixed
    order."""
    if cfg.norm != "batch":
        raise ValueError("the benchmark's weights carry batch norm only")
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    specs: List[Spec] = []
    if cfg.arch == "unet":
        specs += _double_conv("blocks.0", cfg.in_channels, f[0])
        for i in range(cfg.depth):
            specs += _double_conv(f"blocks.{i + 1}", f[i], f[i + 1])
        for u, i in enumerate(reversed(range(cfg.depth))):
            specs += _up(f"ups.{u}", f[i + 1], f[i])
            specs += _double_conv(f"blocks.{cfg.depth + 1 + u}", 2 * f[i],
                                  f[i])
        specs += _head("head", f[0], cfg.out_channels)
        return specs
    if cfg.arch != "unetpp":
        raise ValueError(f"unknown arch {cfg.arch!r}")
    for i in range(cfg.depth + 1):
        cin = cfg.in_channels if i == 0 else f[i - 1]
        specs += _double_conv(f"nodes.x_{i}_0", cin, f[i])
    for i, j in decoder_nodes(cfg.depth):
        specs += _up(f"ups.up_{i}_{j}", f[i + 1], f[i])
        specs += _double_conv(f"nodes.x_{i}_{j}", (j + 1) * f[i], f[i])
    heads = ([f"head_{j}" for j in range(1, cfg.depth + 1)]
             if cfg.deep_supervision else ["head"])
    for name in heads:
        specs += _head(f"heads.{name}", f[0], cfg.out_channels)
    return specs


def make_weights(cfg, init: Dict[str, float], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The fp32 weights of ``cfg`` from one standard normal draw of a
    generator on ``device`` seeded with ``seed``. ``init`` gives each kind
    its scale: kernels ``gain / sqrt(fan_in)``, batch norm's scale ``1 +
    bn_weight·n``, shift and running mean ``·n``, running variance
    ``exp(bn_var·n)``, biases ``·n``."""
    specs = param_specs(cfg)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = draw[at:at + n].reshape(shape)
        at += n
        if kind in ("conv", "up", "head"):
            fan_in = shape[1] * shape[2] * shape[3] if kind != "up" \
                else shape[0]
            t = z * (init[f"{kind}_gain"] / math.sqrt(fan_in))
        elif kind == "bn_weight":
            t = 1.0 + init["bn_weight"] * z
        elif kind == "bn_var":
            t = torch.exp(init["bn_var"] * z)
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        else:   # bn_bias, bn_mean, up_bias, head_bias
            t = init[kind] * z
        out[name] = t.contiguous()
    return out
