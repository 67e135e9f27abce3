"""The SegFormer serving step's share of the card's bf16 peak: the analytic
FLOPs of the tiles computed for the granules served in the traced window
(granules times the sliding grid's tiles times a tile's FLOPs by the
frozen yardstick), over the window's seconds, against 989 TFLOP/s. Read
where the program counted SegFormer tiles (``segformer.tiles``)."""

from benchmark.yardstick import segformer_ops as ops
from benchmark.yardstick.flops import sliding_redundancy

LAYER = "serving step"
UNIT = "%"
MOVES = "serve_mpix_s"


def read(rec):
    counters = (rec.get("program") or {}).get("counters") or {}
    model = rec.get("segformer")
    if not rec.get("pixels") or not counters.get("segformer.tiles") \
            or not model:
        return None
    mix = rec["mix"]
    tile = mix["tile"]
    tiles = rec["pixels"] * sliding_redundancy(
        mix["granule"]["size"], tile, mix["overlap"]) / (tile * tile)
    flops = tiles * sum(ops.flops_per_tile(model, rec["model_fields"],
                                           tile).values())
    return 100.0 * flops / rec["rate_window_s"] / ops.PEAK_BF16_FLOPS_PER_S
