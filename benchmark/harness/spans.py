"""The program's own spans (``plumekit_torch.utils.timers``, on
``time.perf_counter_ns``) on the timeline of a stopped profiler session
(``harness.profile.Session``), and the session's device idle time put down
to them.

:func:`anchor` finds one instant on both clocks: the profiler's own start
(``trace_start_ns``, the zero of its event times) where it proves to lie
within the session's opening on ``perf_counter_ns`` or, carried over by the
offset between the two clocks, on ``CLOCK_REALTIME``; otherwise the start
of the ``bench.window`` range, which the session reads on ``perf_counter``
just before the range opens. :func:`to_profiler_us` places a reading by it,
and :func:`idle_by_span` puts each stretch of the window in which the
device ran nothing down to the innermost program span open on a thread.
The session's own ``reading()`` is not changed by any of this."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from benchmark.harness.profile import _merge

#: (instant in perf_counter_ns, the same instant in profiler us, its source)
Anchor = Tuple[int, float, str]


def window_us(session) -> Tuple[float, float]:
    """The ``bench.window`` range of a stopped session, in profiler us."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in session.events if e.name == "bench.window"
           and e.device_type != cuda]
    if not win:
        raise RuntimeError("the profiler kept no window range")
    return win[0].time_range.start, win[0].time_range.end


def realtime_offset_ns(reads: int = 5) -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()`` at one instant:
    the reading of the first clock between two of the second, the pair
    read closest together of ``reads``."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        r = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, r - (a + b) // 2)
    return best[1]


def anchor(session) -> Anchor:
    """The instant that ties ``perf_counter_ns`` to a stopped session's
    timeline. The session opened its profiler after ``_t0 - overhead_s``
    and before ``_t0`` (its opening and closing are all of
    ``overhead_s``)."""
    t0_ns = int(session._t0 * 1e9)
    lo_ns = int((session._t0 - session.overhead_s) * 1e9)
    start = session._prof.profiler.kineto_results.trace_start_ns()
    if lo_ns <= start <= t0_ns:
        return start, 0.0, "trace_start_ns"
    offset = realtime_offset_ns()
    if lo_ns + offset <= start <= t0_ns + offset:
        return start - offset, 0.0, "trace_start_ns, CLOCK_REALTIME"
    return t0_ns, window_us(session)[0], "bench.window"


def to_profiler_us(t_ns: int, at: Anchor) -> float:
    """A ``time.perf_counter_ns()`` reading on the profiler's timeline
    (microseconds, as its events' ``time_range``)."""
    anchor_ns, anchor_us, _ = at
    return anchor_us + (t_ns - anchor_ns) / 1e3


def idle_by_span(session, spans: List[dict], thread: str) -> Dict:
    """The stopped session's stretches of its window with no device
    operation (kernel, copy or fill), each put down to the innermost of
    ``spans`` (the recorder's dicts) open on the thread named ``thread``:
    {span name: seconds}, every name of the thread's spans in the window
    listed (0.0 where the device never idled in it), and ``untraced`` for
    what no span covers."""
    w0, w1 = window_us(session)
    dev = []
    for e in session.events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("bench."):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            dev.append((a, b))
    gaps, at = [], w0
    for a, b in _merge(dev):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    clock = anchor(session)
    mine = []
    for sp in spans:
        if sp["thread"] != thread:
            continue
        a = to_profiler_us(sp["t0_ns"], clock)
        b = to_profiler_us(sp["t1_ns"], clock)
        if b > w0 and a < w1:
            mine.append((sp["name"], a, b))
    return attribute_idle(gaps, mine)


def innermost(spans: List[Tuple[str, float, float]]
              ) -> List[Tuple[float, float, str]]:
    """Nested spans ``(name, start, end)`` of one thread as consecutive
    stretches ``(start, end, name of the innermost span open)``, gaps
    between spans left out."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    events = []
    for rank, i in enumerate(order):
        name, a, b = spans[i]
        events.append((a, 1, rank, name))
        events.append((b, 0, -rank, name))   # inner spans end first
    events.sort()
    out, stack, at = [], [], None
    for t, opens, _, name in events:
        if stack and t > at:
            out.append((at, t, stack[-1]))
        at = t
        if opens:
            stack.append(name)
        elif stack:
            stack.pop()
    return out


def attribute_idle(gaps: List[Tuple[float, float]],
                   spans: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """Seconds of the sorted, disjoint ``gaps`` (microseconds) under each
    innermost span of ``spans`` (one thread's, nested, on the same
    clock); what no span covers is ``untraced``. Every span name has an
    entry."""
    out = {name: 0.0 for name, _, _ in spans}
    out["untraced"] = 0.0
    stretches = innermost(spans)
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(stretches) and stretches[j][1] <= a:
            j += 1
        k = j
        while k < len(stretches) and stretches[k][0] < b:
            s0, s1, name = stretches[k]
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                out[name] += (hi - lo) * 1e-6
                covered += hi - lo
            k += 1
        out["untraced"] += (b - a - covered) * 1e-6
    return out
