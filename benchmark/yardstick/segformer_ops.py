"""FLOPs and bytes of the SegFormer forward, counted from shapes, frozen
from ``plumekit_torch/models/flops.py``'s SegFormer count: matmul-class
FLOPs at 2·MACs of the attention's two products (q kᵀ and the
probabilities times v, every head), the Mix-FFN depthwise 3×3 convs, the
rest of the encoder (patch embeddings, projections, reduction convs,
Mix-FFN's linears) and the head (per-stage linears, the 1×1 fuse, the
classifier). Each input byte is counted read once and each output byte
written once, in bf16. A kernel's bound is the larger of its FLOPs at the
data sheet's 989 bf16 TFLOP/s and its bytes at 3,350 GB/s.

``seg`` is the configuration file's ``segformer`` widths, ``model`` its
``model`` fields (``in_channels``, ``out_channels``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: bytes of one bf16 value
BF16 = 2
#: substrings of the names of the fused attention kernels in the device
#: trace: flash (``pytorch_flash::flash_fwd_kernel``, the one that runs on
#: an H100 with torch 2.11) and memory-efficient
ATTENTION_KERNELS = ("flash_fwd", "fmha_cutlassF")
#: substrings of the names of the depthwise conv's kernels in the device
#: trace: cuDNN's channels-last depthwise kernel on an H100 with torch
#: 2.11, one launch per Mix-FFN
DWCONV_KERNELS = ("conv2d_c1_k1_nhwc",)


def stages(seg: dict, tile: int) -> List[Tuple[int, int, int, int]]:
    """(side, keys per query, channels, hidden) of each stage at
    ``tile``² tiles."""
    out = []
    side = tile
    for i, c in enumerate(seg["hidden_sizes"]):
        k, s, sr = (seg["patch_sizes"][i], seg["strides"][i],
                    seg["sr_ratios"][i])
        side = (side + 2 * (k // 2) - k) // s + 1
        n_kv = (side // sr) ** 2 if sr > 1 else side * side
        out.append((side, n_kv, c, c * seg["mlp_ratios"][i]))
    return out


def flops_per_tile(seg: dict, model: dict, tile: int) -> Dict[str, float]:
    """FLOPs of one forward on one ``tile``² tile, by part: attention,
    dwconv, encoder, head."""
    parts = {"attention": 0.0, "dwconv": 0.0, "encoder": 0.0, "head": 0.0}
    cin = model["in_channels"]
    d = seg["decoder_hidden_size"]
    for i, (side, n_kv, c, hidden) in enumerate(stages(seg, tile)):
        k, sr, depth = (seg["patch_sizes"][i], seg["sr_ratios"][i],
                        seg["depths"][i])
        n = side * side
        parts["encoder"] += 2.0 * n * k * k * cin * c
        per_block = 2.0 * c * c * (2 * n + 2 * n_kv) + 4.0 * n * c * hidden
        if sr > 1:
            per_block += 2.0 * n_kv * sr * sr * c * c
        parts["encoder"] += depth * per_block
        parts["attention"] += depth * 4.0 * n * n_kv * c
        parts["dwconv"] += depth * 18.0 * n * hidden
        parts["head"] += 2.0 * n * c * d
        cin = c
    side1 = stages(seg, tile)[0][0]
    parts["head"] += 2.0 * side1 * side1 * d * (
        len(seg["hidden_sizes"]) * d + model["out_channels"])
    return parts


def attention_flops_and_bytes(seg: dict, tile: int) -> Tuple[float, float]:
    """FLOPs and bytes (q, k, v read, the output written, bf16) of every
    attention call of one forward on one tile."""
    flops = by = 0.0
    for i, (side, n_kv, c, _) in enumerate(stages(seg, tile)):
        n = side * side
        flops += seg["depths"][i] * 4.0 * n * n_kv * c
        by += seg["depths"][i] * BF16 * c * (2 * n + 2 * n_kv)
    return flops, by


def dwconv_flops_and_bytes(seg: dict, tile: int) -> Tuple[float, float]:
    """FLOPs and bytes (input, kernel and bias read, output written, bf16)
    of every Mix-FFN depthwise conv of one forward on one tile."""
    flops = by = 0.0
    for i, (side, _, _, hidden) in enumerate(stages(seg, tile)):
        n = side * side
        flops += seg["depths"][i] * 18.0 * n * hidden
        by += seg["depths"][i] * BF16 * (2 * n * hidden + 10 * hidden)
    return flops, by


def bound_s(flops: float, n_bytes: float) -> float:
    """The least seconds the card could take: FLOPs at the bf16 peak or
    bytes at the memory's, the larger."""
    return max(flops / PEAK_BF16_FLOPS_PER_S, n_bytes / PEAK_BYTES_PER_S)


def kernel_seconds(kernels: Dict[str, float], names) -> float:
    """Device seconds of the profiled kernels whose name holds any of
    ``names``."""
    return sum(s for k, s in kernels.items() if any(n in k for n in names))
