"""The whole train step's share of the card's bf16 peak: three forwards'
analytic FLOPs a tile pixel (by the frozen yardstick) times the tile
pixels of the steps run in the traced window, over the window's seconds,
against 989 TFLOP/s."""

from benchmark.yardstick.flops import PEAK_TFLOPS, model_flops_per_pixel

LAYER = "train step"
UNIT = "%"
MOVES = "train_mpix_s"


def read(rec):
    if not rec.get("pixels"):
        return None
    flops = 3.0 * model_flops_per_pixel(rec["model"]) * rec["pixels"]
    return 100.0 * flops / rec["rate_window_s"] / (PEAK_TFLOPS["bf16"] * 1e12)
