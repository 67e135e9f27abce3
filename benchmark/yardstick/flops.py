"""Analytic FLOPs of the U-Net and UNet++ and the sliding-window
redundancy, frozen from ``plumekit_torch/models/flops.py``.

Convention: matmul-class FLOPs only (convs and transposed convs at
2·MACs; norm, activation, pool and concat excluded), per input-resolution
pixel of one forward; a training step costs three forwards' worth.
``cfg`` is any object with the ``UNetConfig`` fields as attributes
(:func:`benchmark.harness.cell.model_config` makes one of a config file).
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM dense peak rates from its data sheet, TFLOP/s: bf16
#: tensor cores 989, int8 1979 (TOPS).
PEAK_TFLOPS = {"bf16": 989.0, "int8": 1979.0}


def effective_level(cfg) -> int:
    """The UNet++ fusion column a forward tops out at."""
    level = getattr(cfg, "prune_level", None)
    return cfg.depth if level is None else level


def decoder_nodes(level: int):
    """The UNet++ fusion nodes (i, j), j ≥ 1, column by column, each from
    the top row down."""
    for j in range(1, level + 1):
        for i in range(level + 1 - j):
            yield i, j


def _conv(cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout


def _up(cin: int, cout: int) -> float:
    return 2.0 * cin * cout


def model_flops_per_pixel(cfg) -> float:
    """Matmul-class FLOPs per input pixel of one forward; area at level i
    scales as 4^-i."""
    base, depth = cfg.base_features, cfg.depth
    feats = [base * (1 << i) for i in range(depth + 1)]
    if cfg.arch == "unetpp":
        level = effective_level(cfg)
        total = 0.0
        prev = cfg.in_channels
        for i in range(level + 1):
            total += (_conv(prev, feats[i]) + _conv(feats[i], feats[i])) \
                / 4.0**i
            prev = feats[i]
        for i, j in decoder_nodes(level):
            cat = (j + 1) * feats[i]
            total += (_up(feats[i + 1], feats[i]) + _conv(cat, feats[i])
                      + _conv(feats[i], feats[i])) / 4.0**i
        n_heads = level if cfg.deep_supervision else 1
        return total + n_heads * _conv(base, cfg.out_channels, 1)
    if cfg.arch != "unet":
        raise ValueError(f"unknown arch {cfg.arch!r}")
    total = 0.0
    prev = cfg.in_channels
    for i in range(depth):
        total += (_conv(prev, feats[i]) + _conv(feats[i], feats[i])) / 4.0**i
        prev = feats[i]
    total += (_conv(prev, feats[depth])
              + _conv(feats[depth], feats[depth])) / 4.0**depth
    for i in reversed(range(depth)):
        total += (_up(feats[i + 1], feats[i]) + _conv(2 * feats[i], feats[i])
                  + _conv(feats[i], feats[i])) / 4.0**i
    return total + _conv(base, cfg.out_channels, 1)


def sliding_redundancy(size: int, tile: int, overlap: int) -> float:
    """Computed pixels over canvas pixels of the sliding-window grid on a
    ``size``² granule (stride = tile − overlap)."""
    stride = tile - overlap
    n = max(0, math.ceil((size - tile) / stride)) + 1
    return (n * n * tile * tile) / float(size * size)
