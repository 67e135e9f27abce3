"""Device milliseconds per group of the sliding program outside its
forwards: CUDA events around the program's call less those around each
forward it calls (tiling, blending, canvas). Mean over the traced window's
groups."""

import statistics

LAYER = "sliding program"
UNIT = "ms"
MOVES = "serve_mpix_s"


def read(rec):
    values = rec.get("stitch_ms")
    return statistics.fmean(values) if values else None
