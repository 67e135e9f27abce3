"""Q1's share of its roofline: the least time of the 3×3 convs of the
forwards run in the profiled sub-window (bytes at 3,350 GB/s or int8
operations at 1,979 TOPS, counted from shapes by the frozen yardstick)
over the profiler's device time of the kernels named below."""

from benchmark.yardstick.int8_ops import bound, conv_cases, ops_and_bytes

LAYER = "kernel Q1"
UNIT = "%"
MOVES = "serve_mpix_s"
#: the kernel's name in the device trace
KERNEL = "int8_conv_kernel"


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["forward_tiles"]:
        return None
    seconds = sum(s for name, s in prof["kernels"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    cases = conv_cases(rec["model"], rec["mix"]["tile"])
    least_ms = sum(bound(*ops_and_bytes(case, n))[0]
                   for n in prof["forward_tiles"] for case in cases)
    return 100.0 * least_ms * 1e-3 / seconds
