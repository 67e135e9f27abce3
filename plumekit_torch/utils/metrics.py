"""The per-step metrics CSV of ``plumekit/utils/metrics.py``."""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional


class MetricsWriter:
    """Append-only CSV metrics: one row per step, columns discovered from the
    first write. Safe to re-open for resume (appends); a later run that
    logs new keys extends the header by rewriting the file atomically."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fields: Optional[list] = None
        if os.path.exists(path) and os.path.getsize(path):
            with open(path) as f:
                self._fields = next(csv.reader(f))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new = self._fields is None
        if new:
            self._fields = list(row)
        elif any(k not in self._fields for k in row):
            extended = self._fields + [k for k in row
                                       if k not in self._fields]
            if os.path.exists(self.path):
                with open(self.path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            else:
                old_rows = []
            # a temp file and an atomic replace: a crash mid-rewrite keeps
            # the run's metrics history
            tmp = self.path + ".tmp"
            with open(tmp, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=extended, restval="")
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
            os.replace(tmp, self.path)
            self._fields = extended
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, restval="",
                               extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)
