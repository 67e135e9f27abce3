"""Q2's share of its roofline: the least time of the 2×2 transposed convs
with their requant of the forwards run in the profiled sub-window (bytes at
3,350 GB/s or int8 operations at 1,979 TOPS, counted from shapes by the
frozen yardstick) over the profiler's device time of the kernels named
below."""

from benchmark.yardstick.int8_ops import (bound, upsample_cases,
                                          upsample_ops_and_bytes)

LAYER = "kernel Q2"
UNIT = "%"
MOVES = "serve_mpix_s"
#: the kernel's name in the device trace
KERNEL = "int8_upsample_kernel"


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["forward_tiles"]:
        return None
    seconds = sum(s for name, s in prof["kernels"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    cases = upsample_cases(rec["model"], rec["mix"]["tile"])
    least_ms = sum(bound(*upsample_ops_and_bytes(case, n))[0]
                   for n in prof["forward_tiles"] for case in cases)
    return 100.0 * least_ms * 1e-3 / seconds
