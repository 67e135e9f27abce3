"""Sliding-window and streaming inference, and the serve loop."""

from plumekit_torch.infer.serve import ServeStats, scan_pending, serve_loop
from plumekit_torch.infer.sliding import (
    make_multi_granule_infer,
    make_sliding_infer,
    pad_to_multiple,
    tile_grid,
)

__all__ = ["make_multi_granule_infer", "make_sliding_infer",
           "pad_to_multiple", "tile_grid", "serve_loop", "scan_pending",
           "ServeStats"]
