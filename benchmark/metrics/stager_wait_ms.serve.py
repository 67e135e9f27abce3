"""Host milliseconds per group from the previous group's last yield to the
sliding program's call: the wait for the stager's staged granules and the
stacking of the group. Mean over the groups of the traced window."""

import statistics

LAYER = "stream"
UNIT = "ms"
MOVES = "serve_mpix_s"


def read(rec):
    values = rec.get("stager_wait_ms")
    return statistics.fmean(values) if values else None
