"""One short ``torch.profiler`` session over a steady part of the window,
and what is read from it: device time by kernel name, the busy share, and
the idle gaps by what the consumer's host thread was doing.

A session loses the records of the first kernels it sees, more as the
process ages (the repository's own finding with this torch), so it opens
with a run of tiny kernels that nothing reads. The window is the span of a
``bench.window`` range on the profiler's own clock; host spans that the
driver times with ``time.perf_counter`` are moved onto that clock by the
range's start."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

#: tiny kernels that open a session, taking the records a session drops
PAD_KERNELS = 256


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Session:
    """``start()`` and ``stop()`` around integral groups of work on the
    current device; ``host_span(name, t0, t1)`` records what the consuming
    thread did (perf_counter seconds); ``reading()`` after ``stop()``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._window = None
        self._t0 = None
        self.host: List[Tuple[str, float, float]] = []
        self.stopped = False
        self._events: Optional[list] = None
        #: host seconds spent opening and closing the session, which a
        #: rate over the traced window leaves out
        self.overhead_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None and not self.stopped

    def start(self) -> None:
        t = time.perf_counter()
        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        pad = torch.zeros(1, device=self.device)
        for _ in range(PAD_KERNELS):
            pad.add_(1.0)
        torch.cuda.synchronize(self.device)
        self._window = torch.profiler.record_function("bench.window")
        self._t0 = time.perf_counter()
        self.overhead_s += self._t0 - t
        self._window.__enter__()

    def host_span(self, name: str, t0: float, t1: float) -> None:
        if self.active:
            self.host.append((name, t0, t1))

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.stopped = True
        self.overhead_s += time.perf_counter() - t

    @property
    def events(self) -> list:
        """The session's events, read once it has stopped (after the
        window: reading them takes seconds)."""
        if self._events is None:
            self._events = list(self._prof.events())
        return self._events

    def reading(self) -> Dict:
        """``window_s``; ``busy_s``, the union of every device operation
        (kernels, copies, fills) inside the window, and ``kernel_busy_s``,
        of the kernels alone; ``kernels`` ({operation name: device
        seconds}); ``idle`` ({host span name: seconds in which no device
        operation ran})."""
        cuda = torch.autograd.DeviceType.CUDA
        win = [e for e in self.events if e.name == "bench.window"
               and e.device_type != cuda]
        if not win:
            raise RuntimeError("the profiler kept no window range")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        dev, compute = [], []
        kernels: Dict[str, float] = {}
        for e in self.events:
            # the driver's own ranges are mirrored on the device's timeline
            if e.device_type != cuda or e.name.startswith("bench."):
                continue
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b <= a:
                continue
            dev.append((a, b))
            if not e.name.startswith(("Memcpy", "Memset")):
                compute.append((a, b))
            kernels[e.name] = kernels.get(e.name, 0.0) + (b - a) * 1e-6
        busy = _merge(dev)
        gaps = []
        at = w0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        # host spans onto the profiler's clock (microseconds)
        spans = [(n, w0 + (t0 - self._t0) * 1e6, w0 + (t1 - self._t0) * 1e6)
                 for n, t0, t1 in self.host]
        idle: Dict[str, float] = {}
        for a, b in gaps:
            for n, s0, s1 in spans:
                lo, hi = max(a, s0), min(b, s1)
                if hi > lo:
                    idle[n] = idle.get(n, 0.0) + (hi - lo) * 1e-6
            covered = sum(max(0.0, min(b, s1) - max(a, s0))
                          for _, s0, s1 in spans)
            rest = (b - a) - covered
            if rest > 0:
                idle["other"] = idle.get("other", 0.0) + rest * 1e-6
        return {"window_s": (w1 - w0) * 1e-6,
                "busy_s": sum(b - a for a, b in busy) * 1e-6,
                "kernel_busy_s": sum(b - a for a, b in _merge(compute))
                * 1e-6,
                "kernels": kernels, "idle": idle}


def warm_up(device) -> None:
    """Open and close one session: the profiler's first use in a process
    takes seconds, which belong to set-up."""
    warm = Session(device)
    warm.start()
    warm.stop()


def top(table: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries as ``[[name, value], ...]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
