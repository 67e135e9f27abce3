"""MODIS sinusoidal grid math of ``plumekit/geo/sinusoidal.py``, numpy
only: the projection on a sphere of radius R is ``x = R·lon·cos(lat)``,
``y = R·lat`` (radians)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: sphere radius of the MODIS sinusoidal projection (``tools.py:126``)
SINU_RADIUS_M = 6371007.181


def sinusoidal_to_wgs84(x, y):
    """Sinusoidal meters → (lon, lat) degrees; NaN outside the lens."""
    lat = y / SINU_RADIUS_M
    cosl = np.cos(lat)
    invalid = ((np.abs(lat) > np.pi / 2 + 1e-12)
               | (np.abs(cosl) < 1e-9)
               | (np.abs(x) > SINU_RADIUS_M * np.pi * np.abs(cosl) + 1e-6))
    lon = np.where(invalid, np.nan,
                   x / (SINU_RADIUS_M * np.where(invalid, 1.0, cosl)))
    return np.degrees(lon), np.degrees(np.where(invalid, np.nan, lat))


def wgs84_to_sinusoidal(lon_deg, lat_deg):
    """(lon, lat) degrees → sinusoidal meters."""
    lat = np.radians(lat_deg)
    lon = np.radians(lon_deg)
    return SINU_RADIUS_M * lon * np.cos(lat), SINU_RADIUS_M * lat


def grid_from_extent(x0: float, y0: float, x1: float, y1: float, ny: int,
                     nx: int) -> Tuple[np.ndarray, np.ndarray]:
    """(lat, lon) grids of a granule with UL corner ``(x0, y0)`` and LR
    corner ``(x1, y1)`` in sinusoidal meters (``tools.py:116-128``)."""
    xinc = (x1 - x0) / nx
    yinc = (y1 - y0) / ny
    x = np.linspace(x0, x0 + xinc * nx, nx)
    y = np.linspace(y0, y0 + yinc * ny, ny)
    xv, yv = np.meshgrid(x, y)
    lon, lat = sinusoidal_to_wgs84(xv, yv)
    return lat, lon
