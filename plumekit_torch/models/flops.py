"""Analytic FLOP counts of the U-Net and UNet++
(``plumekit/models/flops.py``), for
TFLOP/s and model FLOP utilisation beside every MPix/s figure.

Convention: matmul-class FLOPs only (convs and transposed convs at
2·MACs; norm, activation, pool and concat excluded). Counts are per
input-resolution pixel of one forward; a training step costs three
forwards' worth (forward, and backward to inputs and to weights).
"""

from __future__ import annotations

import math

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.unetpp import decoder_nodes, effective_level

#: NVIDIA H100 SXM dense peak rates from its data sheet, TFLOP/s: bf16
#: tensor cores 989, int8 1979 (TOPS).
PEAK_TFLOPS = {"bf16": 989.0, "int8": 1979.0}


def _conv(cin: int, cout: int, k: int = 3) -> float:
    """FLOPs per output pixel of a k×k SAME conv: 2 · k² · cin · cout."""
    return 2.0 * k * k * cin * cout


def _up(cin: int, cout: int) -> float:
    """FLOPs per output pixel of a 2×2 stride-2 transposed conv."""
    return 2.0 * cin * cout


def model_flops_per_pixel(cfg: UNetConfig) -> float:
    """Matmul-class FLOPs per input-resolution pixel of one forward of the
    U-Net, or of the UNet++ with its deep supervision and serving pruning.
    Area at level i scales as 4^-i."""
    base, depth = cfg.base_features, cfg.depth
    feats = [base * (1 << i) for i in range(depth + 1)]
    if cfg.arch == "unetpp":
        level = effective_level(cfg)
        total = 0.0
        prev = cfg.in_channels
        for i in range(level + 1):        # encoder column 0
            total += (_conv(prev, feats[i]) + _conv(feats[i], feats[i])) \
                / 4.0**i
            prev = feats[i]
        for i, j in decoder_nodes(level):  # nested dense decoder
            cat = (j + 1) * feats[i]  # j same-scale nodes + the upsample
            total += (_up(feats[i + 1], feats[i]) + _conv(cat, feats[i])
                      + _conv(feats[i], feats[i])) / 4.0**i
        n_heads = level if cfg.deep_supervision else 1
        return total + n_heads * _conv(base, cfg.out_channels, 1)
    if cfg.arch != "unet":
        raise ValueError(f"unknown arch {cfg.arch!r}")
    total = 0.0
    prev = cfg.in_channels
    for i in range(depth):            # encoder double convs
        total += (_conv(prev, feats[i]) + _conv(feats[i], feats[i])) / 4.0**i
        prev = feats[i]
    total += (_conv(prev, feats[depth])
              + _conv(feats[depth], feats[depth])) / 4.0**depth
    for i in reversed(range(depth)):  # decoder: up + double conv
        total += (_up(feats[i + 1], feats[i]) + _conv(2 * feats[i], feats[i])
                  + _conv(feats[i], feats[i])) / 4.0**i
    return total + _conv(base, cfg.out_channels, 1)


def sliding_redundancy(size: int, tile: int, overlap: int) -> float:
    """Computed pixels over canvas pixels of the sliding-window grid on a
    ``size``² granule (stride = tile − overlap, last tile clamped)."""
    stride = tile - overlap
    n = max(0, math.ceil((size - tile) / stride)) + 1
    return (n * n * tile * tile) / float(size * size)


def mfu(mpix_s: float, flops_per_px: float, peak: str = "bf16",
        redundancy: float = 1.0) -> dict:
    """Apparent TFLOP/s and its share of the card's peak in percent, for a
    measured canvas-pixel rate."""
    tflops = mpix_s * 1e6 * flops_per_px * redundancy / 1e12
    return {"tflops": round(tflops, 1),
            "pct_peak": round(100.0 * tflops / PEAK_TFLOPS[peak], 1)}


__all__ = ["model_flops_per_pixel", "sliding_redundancy", "mfu",
           "PEAK_TFLOPS"]
