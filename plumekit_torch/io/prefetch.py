"""Host decode pool and card prefetch of ``plumekit/io/prefetch.py``.

:func:`decode_pool` decodes items on a thread pool and delivers them in
order; :func:`device_prefetch` runs a stager thread that moves items onto
the device ``buffer_size`` ahead of the consumer. Together they let granule
i+1 decode and upload while granule i computes and is written.

On the card (:func:`make_device_put`) each array is copied into pinned
host memory and from there, without blocking, on a side CUDA stream; the
copy's event travels with the item, the consumer's stream waits on it
before the first use, and every staged tensor is marked as used by the
consumer's stream (``record_stream``), so that the caching allocator does
not hand its block out again while the consumer's work on it is queued.
The pinned sources live until the event has passed. On the CPU a put is a
plain ``.to(device)`` on the stager thread.

Errors are not swallowed: a decode worker's exception is raised at that
item's turn, and a stager's exception at the consumer's next item.

With the recorder on (``utils/timers``), the stager records a
``stream.stage`` span per item, with ``stream.stage.pin`` (the copies into
pinned memory) and ``stream.stage.h2d`` (issuing the uploads) inside it,
and ``stream.stage.queue_full`` while it waits for room in the queue; the
consumer records ``stream.queue_wait`` around each pull and the counters
``stream.queue.gets``, ``stream.queue.empty`` (pulls that found the queue
empty) and ``stream.queue.depth`` (the queue's size summed over pulls).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, NamedTuple, Optional, \
    TypeVar

import numpy as np
import torch

from plumekit_torch.device import resolve_device
from plumekit_torch.utils import timers

T = TypeVar("T")
U = TypeVar("U")

#: name of the stager thread of :func:`device_prefetch`
STAGER_NAME = "plumekit-device-prefetch"


def default_decode_workers() -> int:
    """The decode pool's size on this host: ``cpu_count - 1``, at most 4,
    at least 1 (the JAX package's rule)."""
    return max(1, min(4, (os.cpu_count() or 1) - 1))


def decode_pool(items: Iterable[T], decode_fn: Callable[[T], U],
                workers: int = 4, depth: int = 4) -> Iterator[U]:
    """``decode_fn`` over ``items`` on ``workers`` threads with up to
    ``depth`` items in flight; results are yielded in submission order. A
    worker's exception is raised at that item's turn, after the items
    before it."""
    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque(ex.submit(decode_fn, x)
                        for x in itertools.islice(it, depth))
        try:
            while pending:
                nxt = pending.popleft()
                for x in itertools.islice(it, 1):
                    pending.append(ex.submit(decode_fn, x))
                yield nxt.result()
        finally:
            # an abandoned or failed stream decodes nothing more
            for f in pending:
                f.cancel()


class Staged(NamedTuple):
    """An item staged on the card: its value (with device tensors), the
    event recorded after the copies, the device tensors to mark as used by
    the consumer's stream, and the pinned sources."""

    value: object
    event: "torch.cuda.Event"
    device: torch.device
    tensors: tuple
    pinned: tuple


def _map_arrays(item, fn):
    """``item`` with every numpy array and tensor in nested tuples and lists
    replaced by ``fn(array)``; other leaves pass unchanged."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(x, fn) for x in item)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


def make_device_put(device) -> Callable:
    """The stager's put for ``device``: moves every array of an item (nested
    tuples and lists; other leaves pass). On the card it returns a
    :class:`Staged` (pinned copies on a side stream created here); on the
    CPU the item itself."""
    device = resolve_device(device)
    if device.type != "cuda":
        return lambda item: _map_arrays(
            item, lambda a: torch.as_tensor(a).to(device))
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device)

    def put(item):
        tensors, pinned = [], []

        def move(a):
            with timers.span("stream.stage.pin"):
                src = torch.as_tensor(a).pin_memory()
            timers.count("stream.stage.pin_bytes", src.nbytes)
            pinned.append(src)
            with timers.span("stream.stage.h2d"):
                tensors.append(src.to(device, non_blocking=True))
            return tensors[-1]

        with torch.cuda.device(device), torch.cuda.stream(side):
            value = _map_arrays(item, move)
            event = torch.cuda.Event()
            event.record(side)
        return Staged(value, event, device, tuple(tensors), tuple(pinned))

    return put


def device_prefetch(iterable: Iterable, buffer_size: int = 2,
                    device_put: Optional[Callable] = None) -> Iterator:
    """Iterate ``iterable`` with its items staged ``buffer_size`` ahead by
    ``device_put`` on a stager thread (default: :func:`make_device_put` of
    the current CUDA device). The stager stops when the consumer abandons
    the stream; queued items are dropped then."""
    put = device_put or make_device_put("cuda")
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    end = object()
    err: list = []
    stop = threading.Event()

    def blocking_put(item) -> bool:
        # gives up once the consumer has left, else a dropped stream would
        # park this thread on a full queue, holding staged device memory
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def stager():
        it = iter(iterable)
        try:
            for item in it:
                with timers.span("stream.stage"):
                    staged = put(item)
                with timers.span("stream.stage.queue_full"):
                    if not blocking_put(staged):
                        return
        except BaseException as e:  # handed to the consumer, raised there
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            blocking_put(end)

    t = threading.Thread(target=stager, name=STAGER_NAME, daemon=True)
    t.start()
    in_flight: deque = deque()
    try:
        while True:
            if timers.enabled():
                timers.count("stream.queue.gets")
                timers.count("stream.queue.empty", int(q.empty()))
                timers.count("stream.queue.depth", q.qsize())
            with timers.span("stream.queue_wait"):
                item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            if isinstance(item, Staged):
                stream = torch.cuda.current_stream(item.device)
                stream.wait_event(item.event)
                for tensor in item.tensors:
                    tensor.record_stream(stream)
                in_flight.append(item)
                while in_flight and in_flight[0].event.query():
                    in_flight.popleft()
                item = item.value
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


__all__ = ["STAGER_NAME", "Staged", "decode_pool", "default_decode_workers",
           "device_prefetch", "make_device_put"]
