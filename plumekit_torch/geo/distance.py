"""Great-circle distance and pixel-index grids of
``plumekit/geo/distance.py``, numpy only."""

from __future__ import annotations

import numpy as np

#: Earth radius of the reference's haversine (``plume_identifier_rg.py:93``)
HAVERSINE_RADIUS_KM = 6367.0


def haversine_km(lon1, lat1, lon2, lat2):
    """Great-circle distance in km between points in decimal degrees."""
    lon1, lat1, lon2, lat2 = (np.radians(v) for v in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = np.sin(dlat / 2.0) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    return 2.0 * HAVERSINE_RADIUS_KM * np.arcsin(np.sqrt(a))


def grid_indexes(shape):
    """(rows, cols) integer index grids of an image of ``shape`` (H, W)
    (``plume_identifier_rg.py:69-74``)."""
    rows, cols = np.mgrid[0:shape[0], 0:shape[1]]
    return rows, cols
