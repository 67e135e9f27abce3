"""Host milliseconds a step waits for its batch from the program's host
feed (the stager's drawn, stacked and uploaded chunk); the mean over the
traced window."""

import statistics

LAYER = "host feed"
UNIT = "ms"
MOVES = "train_mpix_s"


def read(rec):
    values = rec.get("data_wait_ms")
    return statistics.fmean(values) if values else None
