"""Multi-granule inference over a stream of granule files
(``plumekit/infer/streaming.py``, its full-precision case).

Granules are decoded in order on the calling thread; consecutive granules
of one shape are grouped ``batch_granules`` at a time and go through the
device together. Overlapping decode with device work (pinned memory, a
side stream) is not ported yet (ROADMAP.md, queue A: 'streaming overlap').
A caller that had to decode some granules already (the int8 calibration)
hands them in through ``predecoded``, so that no granule is decoded twice.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from plumekit_torch.infer.sliding import pad_to_multiple
from plumekit_torch.io.granule import Granule, load_granule
from plumekit_torch.train.data import assemble_channels


def decode_granule_channels(
    path: str,
    depth: int,
    fire_locator: Optional[Callable[[Granule], Tuple[list, list]]] = None,
) -> Tuple[str, np.ndarray, Tuple[int, int]]:
    """Decode one granule to a model-ready (H', W', 2) channel stack, padded
    to the U-Net divisibility. Returns (name, channels, original (H, W))."""
    granule = load_granule(path)
    rows, cols = fire_locator(granule) if fire_locator else ([], [])
    channels = assemble_channels(granule.first_layer(), rows, cols)
    padded, hw = pad_to_multiple(channels, 2**depth)
    return granule.name, padded, hw


def granule_channel_stream(
    paths: Iterable[str],
    depth: int,
    fire_locator: Optional[Callable[[Granule], Tuple[list, list]]] = None,
    predecoded: Optional[dict] = None,
) -> Iterator[Tuple[str, np.ndarray, Tuple[int, int]]]:
    """Decoded granules, in order. ``predecoded`` maps a path to its
    already-decoded ``(name, channels, hw)``; an entry is popped on use
    instead of decoding the path again."""
    for path in paths:
        if predecoded and path in predecoded:
            yield predecoded.pop(path)
        else:
            yield decode_granule_channels(path, depth, fire_locator)


def stream_inference(
    paths: Iterable[str],
    infer_fn: Callable,
    variables,
    depth: int,
    device: torch.device,
    batch_granules: int = 1,
    fire_locator=None,
    predecoded: Optional[dict] = None,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Run ``infer_fn(variables, images (G, H, W, C)) -> (probs, masks)``
    over the granules of ``paths``; yields (granule name, probs cropped to
    the granule's own shape) in order. Groups hold up to ``batch_granules``
    consecutive granules of one shape; the tail group is smaller.
    ``predecoded`` as in :func:`granule_channel_stream`."""
    def flush(group):
        stacked = torch.from_numpy(np.stack([c for _, c, _ in group]))
        probs, _masks = infer_fn(variables, stacked.to(device))
        probs = probs.cpu().numpy()
        for i, (name, _c, (h, w)) in enumerate(group):
            yield name, probs[i, :h, :w]

    group = []
    for item in granule_channel_stream(paths, depth, fire_locator,
                                       predecoded):
        if group and group[0][1].shape != item[1].shape:
            yield from flush(group)
            group = []
        group.append(item)
        if len(group) >= batch_granules:
            yield from flush(group)
            group = []
    if group:
        yield from flush(group)
