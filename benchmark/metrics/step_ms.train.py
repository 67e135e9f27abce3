"""Device milliseconds of one optimizer step (augmentation, train-mode
forward, loss, backward, AdamW), by CUDA events around each call of the
program's step in the traced window; the mean."""

import statistics

LAYER = "train step"
UNIT = "ms"
MOVES = "train_mpix_s"


def read(rec):
    values = rec.get("step_ms")
    return statistics.fmean(values) if values else None
