"""Sliding-window, sharded and streaming inference, and the serve loop."""

from plumekit_torch.infer.export import (export_sliding_infer, load_exported,
                                         save_exported)
from plumekit_torch.infer.serve import ServeStats, scan_pending, serve_loop
from plumekit_torch.infer.sharded import choose_halo, make_sharded_infer
from plumekit_torch.infer.sliding import (
    make_batch_infer_sharded,
    make_multi_granule_infer,
    make_sliding_infer,
    pad_to_multiple,
    tile_grid,
)
from plumekit_torch.infer.streaming import (granule_channel_stream,
                                            stream_inference)

__all__ = ["make_sliding_infer", "make_multi_granule_infer",
           "make_batch_infer_sharded", "pad_to_multiple", "tile_grid",
           "make_sharded_infer", "choose_halo", "stream_inference",
           "granule_channel_stream", "export_sliding_infer",
           "save_exported", "load_exported", "serve_loop", "scan_pending",
           "ServeStats"]
