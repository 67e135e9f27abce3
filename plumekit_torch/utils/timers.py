"""Wall-clock stage timers that wait for the card, and a profiler scope
(``plumekit/utils/timers.py``).

A CUDA launch returns before the card has run it, so a stage that times
card work must wait for it: :meth:`StageTimes.stage` synchronises the
devices of the tensors it is handed (``sync=`` or ``handle.sync(...)``)
before it reads the clock. Host values need no wait.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from plumekit_torch.utils.logging import get_logger

logger = get_logger(__name__)


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
    """Accumulates named stage durations; ``sync=`` waits for the card."""

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
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if sync is not None:
                _sync(sync)
            if handle.value is not None:
                _sync(handle.value)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
