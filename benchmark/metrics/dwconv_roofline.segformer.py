"""The SegFormer's Mix-FFN depthwise conv's share of its roofline: the
least time of the depthwise convs of the forwards run in the profiled
sub-window (their bytes at 3,350 GB/s or FLOPs at 989 TFLOP/s, the larger,
counted from shapes by the frozen yardstick) over the profiler's device
time of the depthwise kernels (names in
``yardstick/segformer_ops.DWCONV_KERNELS``)."""

from benchmark.yardstick import segformer_ops as ops

LAYER = "kernel depthwise conv"
UNIT = "%"
MOVES = "serve_mpix_s"


def read(rec):
    prof = rec.get("profile")
    model = rec.get("segformer")
    if not prof or not prof["forward_tiles"] or not model:
        return None
    seconds = ops.kernel_seconds(prof["kernels"], ops.DWCONV_KERNELS)
    if seconds <= 0:
        return None
    flops, n_bytes = ops.dwconv_flops_and_bytes(model, rec["mix"]["tile"])
    least = sum(prof["forward_tiles"]) * ops.bound_s(flops, n_bytes)
    return 100.0 * least / seconds
