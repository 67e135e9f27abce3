"""Fire → pixel location and fixed-capacity fire arrays (numpy copy of
``plumekit/identify/locate.py``).

For each fire: restrict to a ±0.05° lat/lon box, take the
haversine-nearest pixel, drop fires whose box is empty and fires too close
to the image edge for the association window
(``plume_identifier_rg.py:97-134``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from plumekit_torch.geo.distance import haversine_km


def locate_fires_in_image(fire_lats, fire_lons, lat: np.ndarray,
                          lon: np.ndarray, win_half: int,
                          edge_margin: Optional[int] = None,
                          box_deg: float = 0.05
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) int32 of the located fires, in order, unlocatable ones
    dropped. ``edge_margin=None`` applies the rg rule ``win_half + 1``;
    0 keeps edge fires."""
    if edge_margin is None:
        edge_margin = win_half + 1
    h, w = lat.shape
    rows, cols = [], []
    for flat, flon in zip(np.asarray(fire_lats), np.asarray(fire_lons)):
        box = ((lat > flat - box_deg) & (lat < flat + box_deg)
               & (lon > flon - box_deg) & (lon < flon + box_deg))
        if not box.any():
            continue
        ys, xs = np.nonzero(box)
        d = haversine_km(flon, flat, lon[ys, xs], lat[ys, xs])
        i = int(np.argmin(d))
        r, c = int(ys[i]), int(xs[i])
        if edge_margin:
            if r < edge_margin or r > h - edge_margin:
                continue
            if c < edge_margin or c > w - edge_margin:
                continue
        rows.append(r)
        cols.append(c)
    return np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)


def fire_bucket(n: int, capacity: int, floor: int = 8) -> int:
    """Power-of-two fire capacity for ``n`` real fires, at least ``floor``
    and capped at ``capacity``: the JAX package's shape contract."""
    b = floor
    while b < min(max(n, 1), capacity):
        b *= 2
    return min(b, capacity)


def pad_fires(rows: np.ndarray, cols: np.ndarray, capacity: int,
              bucket: bool = False):
    """Pack ragged fire locations into fixed-capacity int32 arrays plus a
    validity mask; fires beyond the capacity are dropped. ``bucket=True``
    shrinks the capacity to :func:`fire_bucket`."""
    if bucket:
        capacity = fire_bucket(len(rows), capacity)
    n = min(len(rows), capacity)
    out_r = np.zeros(capacity, dtype=np.int32)
    out_c = np.zeros(capacity, dtype=np.int32)
    valid = np.zeros(capacity, dtype=bool)
    out_r[:n] = rows[:n]
    out_c[:n] = cols[:n]
    valid[:n] = True
    return out_r, out_c, valid
