"""Multi-granule inference over a stream of granule files
(``plumekit/infer/streaming.py``): a host decode pool, a stager thread that
uploads granules ``buffer_size`` ahead, and the forwards on the device.

Granule i+1 decodes and uploads while granule i computes and its caller
writes it. Consecutive granules of one shape are grouped
``batch_granules`` at a time and go through the device together; the tail
group is smaller. With ``quantize`` the upload is the uint16 code of the
channels, dequantized on the device before the forward; with
``quantize_output`` the probabilities are encoded as uint8 on the device
and the readback carries that code. A caller that had to decode some
granules already (the int8 calibration) hands them in through
``predecoded``, so that no granule is decoded twice. An exported program of
fixed G takes whole groups (``infer_is_batched``): a ragged tail is padded
by repeating its last granule, and the duplicates' outputs are dropped.

On the card the readback lands in pinned host memory one granule at a
time: each granule's output is copied without blocking into a pinned block
of its own, on the stream that computed it, and is yielded once its own
copy has landed, while the group's later copies still run. A yielded array
is the numpy view of that block and owns it until the caller drops it, so a
caller that keeps every granule of a long 8192² backlog keeps that much
pinned memory. Off the card the readback is one ``.cpu()``.

With the recorder on (``utils/timers``), each group records the spans
``stream.images`` (stacking and dequantizing), ``stream.infer`` (the
program's call, and the uint8 code of its output with ``quantize_output``)
and ``stream.readback`` with ``stream.readback.device_wait`` (the wait for
the program's work) and ``stream.readback.copy`` (issuing the copies to
host memory and waiting for the first granule's) inside it, each with the
group's index as ``group``; between yields, ``stream.readback_wait``
(``group``, ``granule``), the wait for each later granule's copy on the
card. Counters: ``stream.groups``, ``stream.granules``,
``stream.readback.bytes`` (the bytes copied) and
``stream.readback.pinned`` (the granules read back through pinned memory).
The stager and the queue record theirs (``io/prefetch``).
"""

from __future__ import annotations

import itertools
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from plumekit_torch.infer.sliding import pad_to_multiple
from plumekit_torch.io.granule import Granule, load_granule
from plumekit_torch.io.prefetch import (decode_pool, default_decode_workers,
                                        device_prefetch, make_device_put)
from plumekit_torch.ops.quant import (dequantize, dequantize_probs_uint8,
                                      quantize_probs_uint8, quantize_uint16,
                                      uint16_bits)
from plumekit_torch.train.data import assemble_channels
from plumekit_torch.utils import timers


def decode_granule_channels(
    path: str,
    depth: int,
    fire_locator: Optional[Callable[[Granule], Tuple[list, list]]] = None,
) -> Tuple[str, np.ndarray, Tuple[int, int]]:
    """Decode one granule to a model-ready (H', W', 2) channel stack, padded
    to the U-Net divisibility. Returns (name, channels, original (H, W)).
    Host work only: safe on pool threads."""
    granule = load_granule(path)
    rows, cols = fire_locator(granule) if fire_locator else ([], [])
    channels = assemble_channels(granule.first_layer(), rows, cols)
    padded, hw = pad_to_multiple(channels, 2**depth)
    return granule.name, padded, hw


def granule_channel_stream(
    paths: Iterable[str],
    depth: int,
    fire_locator: Optional[Callable[[Granule], Tuple[list, list]]] = None,
    decode_workers: int = 1,
    predecoded: Optional[dict] = None,
) -> Iterator[Tuple[str, np.ndarray, Tuple[int, int]]]:
    """Decoded granules, in order; with ``decode_workers > 1`` they decode
    on a thread pool (:func:`decode_pool`, ``decode_workers + 1`` in
    flight). ``predecoded`` maps a path to its already-decoded ``(name,
    channels, hw)``; an entry is popped on use instead of decoding the path
    again."""
    def decode(p):
        if predecoded and p in predecoded:
            return predecoded.pop(p)
        return decode_granule_channels(p, depth, fire_locator)

    if decode_workers > 1:
        yield from decode_pool(paths, decode, workers=decode_workers,
                               depth=decode_workers + 1)
        return
    for path in paths:
        yield decode(path)


def host_payload(channels: np.ndarray, quantize: bool) -> tuple:
    """What the stager uploads for one granule: ``(channels,)`` float32, or
    ``(q, lo, scale)`` with q the uint16 code as int16 bits."""
    if quantize:
        q, lo, scale = quantize_uint16(channels)
        return uint16_bits(q), lo, scale
    return (channels,)


def readback(probs: torch.Tensor, sizes: Sequence[Tuple[int, int]]
             ) -> List[Tuple[np.ndarray, Optional[torch.cuda.Event]]]:
    """Start reading a group's probabilities (fp32, or their uint8 code)
    back to the host, granule ``i`` cropped to ``sizes[i]``. Returns, per
    granule, its host array and the event to synchronise before reading it
    (None: ready).

    A CUDA tensor is copied without blocking, on the stream that produced
    it, each granule into a pinned block of its own from PyTorch's caching
    host allocator, with an event after each copy; the array is the block's
    numpy view and keeps it alive. The allocator hands a block out again
    only after its copy's event has passed. Any other tensor is read back
    whole by ``.cpu()``."""
    if probs.device.type != "cuda":
        host = probs.cpu().numpy()
        timers.count("stream.readback.bytes", host.nbytes)
        return [(host[i, :h, :w], None) for i, (h, w) in enumerate(sizes)]
    out = []
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream()
        for i, (h, w) in enumerate(sizes):
            host = torch.empty((h, w), dtype=probs.dtype, pin_memory=True)
            host.copy_(probs[i, :h, :w], non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(stream)
            out.append((host.numpy(), landed))
    timers.count("stream.readback.bytes", sum(a.nbytes for a, _ in out))
    timers.count("stream.readback.pinned", len(out))
    return out


def stream_inference(
    paths: Iterable[str],
    infer_fn: Callable,
    variables,
    depth: int,
    device: torch.device,
    buffer_size: int = 2,
    fire_locator=None,
    decode_workers: Optional[int] = None,
    quantize: bool = False,
    batch_granules: int = 1,
    predecoded: Optional[dict] = None,
    quantize_output: bool = False,
    infer_is_batched: bool = False,
    devices: Optional[Sequence] = None,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Run ``infer_fn(variables, images (G, H, W, C)) -> (probs, masks)``
    over the granules of ``paths``; yields (granule name, float32 probs
    cropped to the granule's own shape) in order. On the card each yielded
    array is the view of a pinned host block of its own (:func:`readback`),
    yielded as soon as its copy has landed; keeping it keeps that block.

    ``decode_workers=None`` sizes the decode pool to the host
    (:func:`default_decode_workers`). ``quantize`` uploads uint16 payloads
    and dequantizes them on the device; ``quantize_output`` reads back
    uint8 probabilities (within 1/510 of the fp32 ones). ``predecoded`` as
    in :func:`granule_channel_stream`. ``infer_is_batched`` says that
    ``infer_fn`` takes exactly ``batch_granules`` granules (an exported
    multi-granule program): a ragged tail group is padded by repeating its
    last granule, and the duplicates' outputs are dropped.

    ``devices`` (with ``infer_is_batched``) are the D slots of a mesh's
    data axis (:func:`plumekit_torch.infer.sliding.make_batch_infer_sharded`):
    granule k of a group is staged straight onto the device of slot
    ``k // (batch_granules / D)``, and ``infer_fn`` takes the group as its D
    per-device parts. Only a ragged tail's padding is copied from one
    device to another."""
    if infer_is_batched and batch_granules < 2:
        raise ValueError(
            "infer_is_batched requires batch_granules >= 2 (the program's "
            "leading granule dim); a single-granule program takes plain "
            "(H, W, C) images — pass infer_is_batched=False")
    if devices is not None and (not infer_is_batched
                                or batch_granules % len(devices)):
        raise ValueError(
            f"a group of {batch_granules} granules does not split over "
            f"{len(devices)} devices (devices need infer_is_batched)")
    if decode_workers is None:
        decode_workers = default_decode_workers()
    slots = [torch.device(device)] if devices is None else \
        [torch.device(d) for d in devices]
    puts = {d: make_device_put(d) for d in set(slots)}
    per_slot = max(1, batch_granules // len(slots))
    # the stager walks the groups as the consumer below forms them
    position = {"shape": None, "k": 0}

    def stage(item):
        name, channels, hw = item
        if position["shape"] != channels.shape \
                or position["k"] == batch_granules:
            position["shape"], position["k"] = channels.shape, 0
        slot = slots[position["k"] // per_slot]
        position["k"] += 1
        return puts[slot]((name, host_payload(channels, quantize), hw))

    stream = device_prefetch(
        granule_channel_stream(paths, depth, fire_locator,
                               decode_workers=decode_workers,
                               predecoded=predecoded),
        buffer_size=buffer_size, device_put=stage)

    def images(group, device=None):
        stacked = [torch.stack([t if device is None else t.to(device)
                                for t in parts])
                   for parts in zip(*(payload for _, payload, _ in group))]
        if quantize:
            q, lo, scale = stacked
            return dequantize(q, lo[:, None, None, :],
                              scale[:, None, None, :])
        return stacked[0]

    group_index = itertools.count()

    def flush(group):
        # no span stays open across the yields below
        n = len(group)
        k = next(group_index)
        timers.count("stream.groups")
        timers.count("stream.granules", n)
        if infer_is_batched and n < batch_granules:
            group = group + [group[-1]] * (batch_granules - n)
        with timers.span("stream.images", group=k):
            if devices is None:
                x = images(group)
            else:
                x = [images(group[i * per_slot:(i + 1) * per_slot], slot)
                     for i, slot in enumerate(slots)]
        with timers.span("stream.infer", group=k):
            probs, _masks = infer_fn(variables, x)
            if quantize_output:
                probs = quantize_probs_uint8(probs)
        done = None
        if timers.enabled() and probs.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(probs.device))
        with timers.span("stream.readback", group=k):
            if done is not None:
                with timers.span("stream.readback.device_wait", group=k):
                    done.synchronize()
            with timers.span("stream.readback.copy", group=k):
                host = readback(probs, [hw for _, _, hw in group[:n]])
                if host[0][1] is not None:
                    host[0][1].synchronize()
        for i, ((name, _p, _hw), (p, landed)) in enumerate(
                zip(group[:n], host)):
            if i and landed is not None:
                with timers.span("stream.readback_wait", group=k, granule=i):
                    landed.synchronize()
            yield name, dequantize_probs_uint8(p) if quantize_output else p

    group = []
    for item in stream:
        if group and group[0][1][0].shape != item[1][0].shape:
            yield from flush(group)
            group = []
        group.append(item)
        if len(group) >= batch_granules:
            yield from flush(group)
            group = []
    if group:
        yield from flush(group)
