"""VIIRS active-fire tables without pandas (``plumekit/io/fires.py``).

A fire table is a dict of equal-length numpy columns: ``latitude``,
``longitude`` and ``frp`` as float64, ``acq_date`` as strings and
``date_time`` as ``datetime64[D]`` (``plume_identifier_rg.py:534-535``),
plus whatever other columns the CSV carries.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np

FireTable = Dict[str, np.ndarray]


def _column(values):
    """float64 if every cell parses as a number, else the strings."""
    try:
        return np.array([float(v) for v in values], dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=str)


def load_fire_csv(path: str) -> FireTable:
    """Load a VIIRS fire CSV and add the ``date_time`` column."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    table = {name: _column([r[i] for r in rows])
             for i, name in enumerate(header)}
    table["date_time"] = np.array(table["acq_date"], dtype="datetime64[D]")
    return table


def n_fires(table: FireTable) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: FireTable, keep) -> FireTable:
    """The rows of ``table`` selected by a boolean mask or index array."""
    return {k: v[keep] for k, v in table.items()}


def subset_fires_to_image(lat: np.ndarray, lon: np.ndarray, fires: FireTable,
                          date_to_find, min_frp: Optional[float] = None
                          ) -> FireTable:
    """Fires on ``date_to_find`` strictly inside the image bbox, optionally
    with ``frp > min_frp`` (``plume_identifier_rg.py:50-58``). The bbox is
    NaN-aware: off-lens grid corners carry NaN coordinates."""
    keep = fires["date_time"] == np.datetime64(date_to_find, "D")
    keep &= ((fires["latitude"] > float(np.nanmin(lat)))
             & (fires["latitude"] < float(np.nanmax(lat)))
             & (fires["longitude"] > float(np.nanmin(lon)))
             & (fires["longitude"] < float(np.nanmax(lon))))
    if min_frp is not None:
        keep &= fires["frp"] > min_frp
    return take(fires, keep)
