"""Sliding-window and streaming inference."""

from plumekit_torch.infer.sliding import (
    make_multi_granule_infer,
    make_sliding_infer,
    pad_to_multiple,
    tile_grid,
)

__all__ = ["make_multi_granule_infer", "make_sliding_infer",
           "pad_to_multiple", "tile_grid"]
