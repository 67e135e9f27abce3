"""The port's span-and-counter recorder, wall-clock stage timers that wait
for the card, and a profiler scope (``plumekit/utils/timers.py``).

The recorder is one per process and off by default. :func:`span` opens a
named span of host time (and, given a CUDA device, a pair of CUDA events on
that device's current stream); :func:`count` adds to a named counter. While
it is off each call site pays one test of a flag. :func:`enable` turns it
on, :func:`drain` hands back and forgets what was recorded, resolving the
CUDA events into ``device_ms`` (call it after a synchronise), and
:func:`disable` turns it off. Spans nest per thread: a span's parent is the
innermost span open on its thread when it opened. Their clock is
``time.perf_counter_ns()``, ``CLOCK_MONOTONIC`` on Linux. Spans never stay
open across a ``yield``, so that a caller's time is never counted as the
program's; the spans of one group carry its index as an attribute instead.

A CUDA launch returns before the card has run it, so a stage that times
card work must wait for it: :meth:`StageTimes.stage` synchronises the
devices of the tensors it is handed (``sync=`` or ``handle.sync(...)``)
before it reads the clock. Host values need no wait. Its stages are spans,
recorded too while the recorder is on.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from plumekit_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: whether the recorder is on; read at every call site, set by enable()
_ON = False
_SPANS: List["Span"] = []
_COUNTERS: Dict[str, int] = defaultdict(int)
_LOCK = threading.Lock()          # spans and counters of several threads
_IDS = itertools.count(1)
_OPEN = threading.local()


def _open_stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class Span:
    """One timed interval: ``name``, ``attrs``, ``t0_ns``/``t1_ns`` on
    ``time.perf_counter_ns()``, the thread's name, its own ``id`` and its
    ``parent``'s (the innermost span open on the thread when it opened).
    With a CUDA ``device`` it records an event on that device's current
    stream at each end. A span whose ``keep`` is set goes to the recorder
    when it closes."""

    __slots__ = ("id", "parent", "name", "thread", "attrs", "t0_ns", "t1_ns",
                 "keep", "_device", "_events")

    def __init__(self, name: str, attrs: dict, device=None,
                 keep: bool = True):
        self.name = name
        self.attrs = attrs
        self.keep = keep
        self._device = device if device is not None \
            and torch.device(device).type == "cuda" else None
        self._events = None
        self.t1_ns = None

    def __enter__(self):
        stack = _open_stack()
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.current_thread().name
        stack.append(self)
        if self._device is not None:
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        self.t1_ns = time.perf_counter_ns()
        stack = _open_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.keep:
            with _LOCK:
                _SPANS.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def as_dict(self) -> dict:
        out = {"id": self.id, "parent": self.parent, "name": self.name,
               "thread": self.thread, "t0_ns": self.t0_ns,
               "t1_ns": self.t1_ns, "attrs": self.attrs}
        if self._events is not None:
            self._events[1].synchronize()
            out["device_ms"] = self._events[0].elapsed_time(self._events[1])
        return out


class _NoSpan:
    """The span of a recorder that is off: enters and leaves, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, device=None, **attrs):
    """A context manager timing its block as the span ``name`` with
    ``attrs`` (``group=``, ``tiles=``, ``bytes=``, ...). ``device``, a CUDA
    device, adds the block's device time by CUDA events (``device_ms`` in
    :func:`drain`). While the recorder is off, one shared no-op context."""
    if not _ON:
        return _NO_SPAN
    return Span(name, attrs, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] += n


def enabled() -> bool:
    """Whether the recorder is on."""
    return _ON


def enable() -> None:
    """Turn the recorder on."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn the recorder off; what it holds stays until :func:`drain`."""
    global _ON
    _ON = False


def drain() -> dict:
    """``{"spans": [...], "counters": {...}}`` recorded since the last
    drain, and forget them. Each span is a dict of ``id``, ``parent``,
    ``name``, ``thread``, ``t0_ns``, ``t1_ns``, ``attrs`` and, for a span
    with a CUDA device, ``device_ms``: it waits for the span's end event,
    so call it once the caller has synchronised. Spans still open are
    handed out by the drain after they close."""
    with _LOCK:
        spans = list(_SPANS)
        _SPANS.clear()
        counters = dict(_COUNTERS)
        _COUNTERS.clear()
    return {"spans": sorted((s.as_dict() for s in spans),
                            key=lambda d: d["t0_ns"]),
            "counters": counters}


def _devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, found)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _devices(v, found)
    return found


def _sync(x):
    """Wait until the card work feeding ``x`` is done: every CUDA tensor
    in ``x`` (nested tuples, lists and dicts too) synchronises its own
    device once. Host values pass through."""
    for device in _devices(x, set()):
        torch.cuda.synchronize(device)
    return x


class _Trace:
    """What :func:`profile_trace` yields: the running profiler; after the
    scope, the path of the Chrome trace it wrote and, where the card was
    traced, the number of the card's events in it (``card_events``)."""

    def __init__(self, prof):
        self.prof = prof
        self.path: Optional[str] = None
        self.card_events: Optional[int] = None


def _check_card(trace: _Trace) -> None:
    """Count the kernels, copies and fills on the card's timeline of a
    finished session into ``trace.card_events``; none is a WARNING."""
    trace.card_events = sum(
        e.device_type() == torch.autograd.DeviceType.CUDA
        for e in trace.prof.profiler.kineto_results.events())
    if not trace.card_events:
        logger.warning("profile_trace: the card was traced and no event of "
                       "the card came back (not even the witness fill); %s "
                       "holds the host's side only", trace.path)


#: In one process, each profiler session that traces the card loses the
#: records of the first kernels it launches, about one for every 13 s since
#: the process's first session (``experiments/profiler_sessions.py`` on an
#: H100 with torch 2.11: a session's first 14 kernels 180 s on, the same
#: with the card idle or busy between sessions, and the same after a wait
#: on the host). ``profile_trace`` opens such a session with
#: ``WARMUP_MIN`` plus ``WARMUP_PER_S`` for every second since this module
#: was imported one-element adds (in a range named
#: ``profile_trace.warmup``), for those losses to take.
WARMUP_MIN = 32
WARMUP_PER_S = 0.5
_IMPORTED = time.perf_counter()


def _warmup_kernels() -> int:
    return int(WARMUP_MIN + WARMUP_PER_S * (time.perf_counter() - _IMPORTED))


def _warm_up(n: int) -> None:
    with torch.profiler.record_function("profile_trace.warmup"):
        t = torch.zeros(1, device="cuda")
        for _ in range(n):
            t.add_(0)
        torch.cuda.synchronize()


def _witness():
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()


@contextmanager
def profile_trace(log_dir: str):
    """Trace the scope with ``torch.profiler`` (the host's ops, and the
    card's kernels where CUDA is available) and write a Chrome trace,
    ``trace_<pid>_<ns>.json``, under ``log_dir`` (open it in Perfetto or
    ``chrome://tracing``). Yields a handle whose ``path`` names the file
    once the scope has ended.

    Where the card is traced, the scope ends with one fill of a
    one-element tensor on the current card, a witness that must come back
    in the trace: a session that recorded no event of the card's logs a
    WARNING (its trace holds the host's side only) and leaves
    ``card_events`` at 0. Such a session opens with empty kernels for
    the losses of a long-running process to take (:data:`WARMUP_PER_S`)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        trace = _Trace(prof)
        if cuda:
            _warm_up(_warmup_kernels())
        yield trace
        if cuda:
            _witness()
    trace.path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(trace.path)
    if cuda:
        _check_card(trace)


class Timer:
    """Context manager measuring wall seconds; ``timer.elapsed`` afterwards."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


class _StageHandle:
    """Carrier through which a stage registers its result for the wait:
    ``with st.stage('fwd') as h: h.sync(f(x))``."""

    def __init__(self):
        self.value = None

    def sync(self, value):
        self.value = value
        return value


class StageTimes:
    """Accumulates named stage durations; ``sync=`` waits for the card.
    Each stage is a :class:`Span`, which the recorder keeps while it is
    on."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str, sync=None):
        """``sync=`` takes a value that exists before the block; to time
        work produced inside it, call ``handle.sync(result)`` on the
        yielded handle (without a wait on the block's own output, a stage
        times the launches and not the card's work)."""
        handle = _StageHandle()
        s = Span(name, {}, keep=_ON).__enter__()
        try:
            yield handle
        finally:
            if sync is not None:
                _sync(sync)
            if handle.value is not None:
                _sync(handle.value)
            s.__exit__(None, None, None)
            self.totals[name] += s.seconds
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
