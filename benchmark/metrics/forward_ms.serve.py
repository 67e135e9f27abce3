"""Device milliseconds of one forward, by CUDA events around each call of
the forward the sliding program makes. Mean over the traced window."""

import statistics

LAYER = "forward"
UNIT = "ms"
MOVES = "serve_mpix_s"


def read(rec):
    values = rec.get("forward_ms")
    return statistics.fmean(values) if values else None
