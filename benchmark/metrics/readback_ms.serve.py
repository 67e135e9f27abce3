"""Host milliseconds per group from the program's device completion (a
CUDA event the driver's wrapper waits on) to the group's first yield: the
copy of the probabilities to host memory. Mean over the traced window's
groups."""

import statistics

LAYER = "stream"
UNIT = "ms"
MOVES = "serve_mpix_s"


def read(rec):
    values = rec.get("readback_ms")
    return statistics.fmean(values) if values else None
