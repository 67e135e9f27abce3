"""The whole serving step's share of the card's int8 peak: analytic
operations of the tiles computed for the granules served in the traced
window (canvas pixels times the sliding redundancy times the model's
operations a pixel, by the frozen yardstick), over the window's seconds,
against 1,979 TOPS."""

from benchmark.yardstick.flops import (PEAK_TFLOPS, model_flops_per_pixel,
                                       sliding_redundancy)

LAYER = "serving step"
UNIT = "%"
MOVES = "serve_mpix_s"


def read(rec):
    if not rec.get("pixels"):
        return None
    mix = rec["mix"]
    ops = (rec["pixels"] * model_flops_per_pixel(rec["model"])
           * sliding_redundancy(mix["granule"]["size"], mix["tile"],
                                mix["overlap"]))
    return 100.0 * ops / rec["rate_window_s"] / (PEAK_TFLOPS["int8"] * 1e12)
