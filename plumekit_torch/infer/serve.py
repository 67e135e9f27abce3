"""Continuous serving (``plumekit/infer/serve.py``): watch a granule
directory and hand each new arrival to a processor.

The loop is the JAX package's, in plain Python:

* a :class:`plumekit_torch.train.checkpoint.WorkLog` records the served
  granules (restart-idempotent, membership by exact line), and the
  processor marks a granule only after its output is durably on disk, so a
  crash between the two serves the granule again instead of losing it;
* a file whose mtime is younger than ``settle_s`` is skipped until a later
  scan (it may still be uploading);
* the caller builds the model's program once and the loop reuses it.

The processor ``process_batch(paths) -> int`` serves what it can, marks the
worklog itself and returns how many it served; paths it leaves unmarked
come back on the next scan. Exits: ``once`` after the first scan's backlog,
``idle_exit`` consecutive empty scans, ``max_cycles`` scans, or
``stop_event`` (a ``threading.Event``, set by the CLI's SIGINT and SIGTERM
handlers) between cycles.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from plumekit_torch.train.checkpoint import WorkLog
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)


@dataclass
class ServeStats:
    """Outcome of a :func:`serve_loop` run (returned, and updated live so
    that a supervising thread can watch it)."""

    cycles: int = 0            # scans performed
    served: int = 0            # granules processed and marked done
    #: granules seen but deferred (unsettled file, or a processor that
    #: could not run yet, e.g. int8 waiting for a calibratable granule)
    deferred_last_cycle: int = 0
    errors: int = 0            # cycles whose process_batch raised
    stopped_by: str = ""       # "once" | "idle" | "max_cycles" | "stop_event"
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)


class UnionLog:
    """Read-only union of several :class:`WorkLog`-shaped logs: serve scans
    against served ∪ failed without merging the files."""

    def __init__(self, *logs):
        self.logs = logs

    def done(self, item: str) -> bool:
        return any(log.done(item) for log in self.logs)

    def items(self) -> set:
        out: set = set()
        for log in self.logs:
            out |= log.items()
        return out


def scan_pending(
    scan_dir: str,
    worklog: WorkLog,
    extensions: Tuple[str, ...],
    settle_s: float = 2.0,
    now: Optional[float] = None,
) -> List[str]:
    """Sorted paths of the granules in ``scan_dir`` that are not in the
    worklog and whose mtime is at least ``settle_s`` old. The worklog is
    read once per scan (``worklog.items()``), not once per entry."""
    if now is None:
        now = time.time()
    done = worklog.items()
    pending = []
    try:
        names = sorted(os.listdir(scan_dir))
    except FileNotFoundError:
        return []
    for name in names:
        if not name.endswith(extensions) or name in done:
            continue
        path = os.path.join(scan_dir, name)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # vanished between listdir and stat
        if age < settle_s:
            logger.debug("serve: %s settled %.1fs < %.1fs — deferring",
                         name, age, settle_s)
            continue
        pending.append(path)
    return pending


def serve_loop(
    scan_dir: str,
    worklog: WorkLog,
    process_batch: Callable[[Sequence[str]], int],
    extensions: Tuple[str, ...],
    poll_s: float = 10.0,
    once: bool = False,
    idle_exit: int = 0,
    max_cycles: int = 0,
    settle_s: float = 2.0,
    stop_event: Optional[threading.Event] = None,
) -> ServeStats:
    """Run the watch loop until one of its exits (module docstring). A
    cycle whose ``process_batch`` raises is logged and counted in
    ``errors``; whatever it did not mark comes back on the next scan."""
    stats = ServeStats()
    idle = 0
    while True:
        if stop_event is not None and stop_event.is_set():
            stats.stopped_by = "stop_event"
            return stats
        pending = scan_pending(scan_dir, worklog, extensions,
                               settle_s=settle_s)
        stats.cycles += 1
        if pending:
            idle = 0
            try:
                served = process_batch(pending)
            except Exception:
                # a daemon outlives a bad cycle; processors quarantine the
                # granules that fail on their own, so this cannot spin
                logger.exception("serve: cycle %d failed — retrying "
                                 "unserved granules next cycle",
                                 stats.cycles)
                served = 0
                with stats._lock:
                    stats.errors += 1
            with stats._lock:
                stats.served += served
                stats.deferred_last_cycle = len(pending) - served
            if served:
                logger.info("serve: cycle %d served %d granule(s), %d "
                            "deferred", stats.cycles, served,
                            stats.deferred_last_cycle)
        else:
            idle += 1
            with stats._lock:
                stats.deferred_last_cycle = 0
        if once:
            # deferred granules stay unmarked for the next invocation:
            # retrying here could spin on a backlog that never becomes
            # servable
            stats.stopped_by = "once"
            return stats
        if idle_exit and idle >= idle_exit:
            stats.stopped_by = "idle"
            return stats
        if max_cycles and stats.cycles >= max_cycles:
            stats.stopped_by = "max_cycles"
            return stats
        # a stop request during the poll ends the wait at once
        if stop_event is not None:
            stop_event.wait(poll_s)
        else:
            time.sleep(poll_s)
