"""Share of the profiled sub-window in which no kernel ran on the device,
in percent (copies do not count as busy here; the result's ``busy_s``
counts them)."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_mpix_s"


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["kernel_busy_s"] / prof["window_s"])
