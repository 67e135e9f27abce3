"""The SegFormer attention kernels' share of their roofline: the least time
of the attention calls of the forwards run in the profiled sub-window (q kᵀ
and the probabilities times v at 989 bf16 TFLOP/s, or q, k, v and the
output at 3,350 GB/s, the larger of the two sums; every call is bound by
its FLOPs, at 500-1,000 FLOPs a byte; counted from shapes by the frozen
yardstick) over the profiler's device time of the fused attention
kernels (names in ``yardstick/segformer_ops.ATTENTION_KERNELS``)."""

from benchmark.yardstick import segformer_ops as ops

LAYER = "kernel attention"
UNIT = "%"
MOVES = "serve_mpix_s"


def read(rec):
    prof = rec.get("profile")
    model = rec.get("segformer")
    if not prof or not prof["forward_tiles"] or not model:
        return None
    seconds = ops.kernel_seconds(prof["kernels"], ops.ATTENTION_KERNELS)
    if seconds <= 0:
        return None
    flops, n_bytes = ops.attention_flops_and_bytes(model,
                                                   rec["mix"]["tile"])
    least = sum(prof["forward_tiles"]) * ops.bound_s(flops, n_bytes)
    return 100.0 * least / seconds
