"""UTM projection and nearest-neighbour swath resampling of
``plumekit/geo/utm.py`` (the reference's ``utm_resampler``, ``tools.py:9-64``)
in numpy and scipy.

The kd-tree plan is built on the host (scipy's cKDTree, once per target
grid) into a flat gather map; applying it is a gather and a select, which
runs on the card when the image is a CUDA tensor. Every float64 expression
is the JAX package's, so plans and coordinates equal it bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import stats
from scipy.spatial import cKDTree

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_EP2 = _E2 / (1.0 - _E2)
_K0 = 0.9996
_FALSE_E = 500000.0

_M1 = 1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256
_M2 = 3 * _E2 / 8 + 3 * _E2**2 / 32 + 45 * _E2**3 / 1024
_M3 = 15 * _E2**2 / 256 + 45 * _E2**3 / 1024
_M4 = 35 * _E2**3 / 3072

_E1 = (1 - np.sqrt(1 - _E2)) / (1 + np.sqrt(1 - _E2))
_P2 = 3 * _E1 / 2 - 27 * _E1**3 / 32
_P3 = 21 * _E1**2 / 16 - 55 * _E1**4 / 32
_P4 = 151 * _E1**3 / 96
_P5 = 1097 * _E1**4 / 512


def utm_zone_of(lons) -> int:
    """Modal UTM zone of an array of longitudes (``tools.py:20-28``)."""
    lons = np.asarray(lons)
    lons = (lons + 180) - np.floor((lons + 180) / 360) * 360 - 180
    zones = np.floor((lons + 180) / 6) + 1
    mode = stats.mode(zones, axis=None)
    return int(np.atleast_1d(mode.mode)[0])


def _meridional_arc(lat):
    return _A * (
        _M1 * lat
        - _M2 * np.sin(2 * lat)
        + _M3 * np.sin(4 * lat)
        - _M4 * np.sin(6 * lat)
    )


@dataclass(frozen=True)
class UTMProjection:
    """Forward and inverse UTM of one zone on WGS84 (Snyder's series;
    false northing 0 in the north, 10 000 000 m in the south)."""

    zone: int
    south: bool = False

    @property
    def central_meridian_deg(self) -> float:
        return -183.0 + 6.0 * self.zone

    @property
    def false_northing(self) -> float:
        return 10000000.0 if self.south else 0.0

    def forward(self, lon_deg, lat_deg):
        """(lon, lat) degrees → (easting, northing) meters."""
        lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
        lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
        lon0 = np.radians(self.central_meridian_deg)

        sin_lat, cos_lat, tan_lat = np.sin(lat), np.cos(lat), np.tan(lat)
        n = _A / np.sqrt(1 - _E2 * sin_lat**2)
        t = tan_lat**2
        c = _EP2 * cos_lat**2
        # Δlon wrapped into (−π, π], so that a swath across the
        # antimeridian projects at its physical size in zone 1 or 60
        dlon = lon - lon0
        dlon = dlon - 2 * np.pi * np.round(dlon / (2 * np.pi))
        a = dlon * cos_lat
        m = _meridional_arc(lat)

        east = _FALSE_E + _K0 * n * (
            a
            + (1 - t + c) * a**3 / 6
            + (5 - 18 * t + t**2 + 72 * c - 58 * _EP2) * a**5 / 120
        )
        north = self.false_northing + _K0 * (
            m
            + n
            * tan_lat
            * (
                a**2 / 2
                + (5 - t + 9 * c + 4 * c**2) * a**4 / 24
                + (61 - 58 * t + t**2 + 600 * c - 330 * _EP2) * a**6 / 720
            )
        )
        return east, north

    def inverse(self, east, north):
        """(easting, northing) meters → (lon, lat) degrees, lon in
        [−180, 180)."""
        x = np.asarray(east, dtype=np.float64) - _FALSE_E
        y = np.asarray(north, dtype=np.float64) - self.false_northing
        lon0 = np.radians(self.central_meridian_deg)

        m = y / _K0
        mu = m / (_A * _M1)
        fp = (
            mu
            + _P2 * np.sin(2 * mu)
            + _P3 * np.sin(4 * mu)
            + _P4 * np.sin(6 * mu)
            + _P5 * np.sin(8 * mu)
        )

        sin_fp, cos_fp, tan_fp = np.sin(fp), np.cos(fp), np.tan(fp)
        c1 = _EP2 * cos_fp**2
        t1 = tan_fp**2
        n1 = _A / np.sqrt(1 - _E2 * sin_fp**2)
        r1 = _A * (1 - _E2) / (1 - _E2 * sin_fp**2) ** 1.5
        d = x / (n1 * _K0)

        lat = fp - (n1 * tan_fp / r1) * (
            d**2 / 2
            - (5 + 3 * t1 + 10 * c1 - 4 * c1**2 - 9 * _EP2) * d**4 / 24
            + (61 + 90 * t1 + 298 * c1 + 45 * t1**2 - 252 * _EP2 - 3 * c1**2)
            * d**6
            / 720
        )
        lon = lon0 + (
            d
            - (1 + 2 * t1 + c1) * d**3 / 6
            + (5 - 2 * c1 + 28 * t1 - 3 * c1**2 + 8 * _EP2 + 24 * t1**2) * d**5 / 120
        ) / cos_fp
        lon_deg = np.degrees(lon)
        lon_deg = (lon_deg + 180.0) % 360.0 - 180.0
        return lon_deg, np.degrees(lat)


class UTMResampler:
    """Nearest-neighbour swath → UTM grid resampler (``tools.py:9-64``).

    The grid covers the swath's extent in its modal zone at
    ``pixel_size`` meters; per target cell, ``index_map`` holds the flat
    index of the nearest swath pixel and ``valid`` whether it lies within
    ``radius_of_influence`` meters (the reference's 10 km default,
    ``tools.py:57``). :meth:`resample_image` applies that plan to a numpy
    array or a torch tensor.
    """

    def __init__(self, lats, lons, pixel_size: float,
                 radius_of_influence: float = 10000.0,
                 source_valid=None):
        """``source_valid`` (bool, swath shape) drops invalid swath pixels
        from the source set and from the grid's zone, extent and size, as
        the reference notebook's masked-array resample does (cell 10):
        geolocation fills such as GMTCO's -999.3 would otherwise blow the
        grid up to millions of cells."""
        self.pixel_size = float(pixel_size)
        lats = np.asarray(lats, dtype=np.float64)
        lons = np.asarray(lons, dtype=np.float64)
        src_idx = None
        if source_valid is not None:
            sv = np.asarray(source_valid, bool)
            src_idx = np.nonzero(sv.ravel())[0]
            if src_idx.size == 0:
                # nothing to resample: a 1×1 all-invalid plan, its zone and
                # hemisphere from coordinates clamped onto the earth (raw
                # fills would give e.g. zone 44 south)
                self.zone = utm_zone_of(np.clip(lons, -180.0, 180.0))
                self.south = bool(
                    np.mean(np.clip(lats, -90.0, 90.0)) < 0)
                self.proj = UTMProjection(self.zone, self.south)
                self.extent = (0.0, 0.0, self.pixel_size, self.pixel_size)
                self.x_size = self.y_size = 1
                self.cell_x = self.cell_y = self.pixel_size
                self.valid = np.zeros((1, 1), bool)
                self.index_map = np.zeros((1, 1), np.int32)
                return
            glats, glons = lats.ravel()[src_idx], lons.ravel()[src_idx]
        else:
            glats, glons = lats, lons
        self.zone = utm_zone_of(glons)
        self.south = bool(np.mean(glats) < 0)
        self.proj = UTMProjection(self.zone, self.south)

        x, y = self.proj.forward(glons, glats)
        self.extent = (np.min(x), np.min(y), np.max(x), np.max(y))
        # at least one cell: a source set under half a pixel across would
        # round to an empty grid with NaN cell sizes
        self.x_size = max(
            1, int(np.round((self.extent[2] - self.extent[0]) / pixel_size)))
        self.y_size = max(
            1, int(np.round((self.extent[3] - self.extent[1]) / pixel_size)))
        if self.extent[2] <= self.extent[0]:
            self.extent = (self.extent[0], self.extent[1],
                           self.extent[0] + pixel_size, self.extent[3])
        if self.extent[3] <= self.extent[1]:
            self.extent = (self.extent[0], self.extent[1],
                           self.extent[2], self.extent[1] + pixel_size)

        # pyresample spaces the cells evenly over the extent, so a cell is
        # extent / size wide, not the nominal pixel size (tools.py:33-50)
        self.cell_x = (self.extent[2] - self.extent[0]) / self.x_size
        self.cell_y = (self.extent[3] - self.extent[1]) / self.y_size

        txv, tyv = self._cell_centers()
        pts = np.column_stack([x.ravel(), y.ravel()])
        tree = cKDTree(pts)
        # each query point is answered on its own, so the threads change
        # nothing in the result, ties included
        dist, idx = tree.query(
            np.column_stack([txv.ravel(), tyv.ravel()]),
            distance_upper_bound=radius_of_influence, workers=-1,
        )
        self.valid = np.isfinite(dist).reshape(self.y_size, self.x_size)
        idx = np.where(np.isfinite(dist), idx, 0)
        if src_idx is not None:
            idx = src_idx[idx]
        self.index_map = idx.reshape(self.y_size, self.x_size).astype(np.int32)

    def _cell_centers(self):
        """Meshgrid of the target cell centres (row 0 at the largest
        northing), shared by the plan's query and :meth:`lonlats`."""
        tx = self.extent[0] + (np.arange(self.x_size) + 0.5) * self.cell_x
        ty = self.extent[3] - (np.arange(self.y_size) + 0.5) * self.cell_y
        return np.meshgrid(tx, ty)

    def resample_image(self, image, fill_value=-999.0):
        """The plan applied to a swath-shaped numpy array, or to a torch
        tensor on the tensor's device."""
        if isinstance(image, torch.Tensor):
            index = torch.from_numpy(self.index_map).to(image.device,
                                                        torch.int64)
            valid = torch.from_numpy(self.valid).to(image.device)
            return torch.where(valid, image.reshape(-1)[index], fill_value)
        flat = np.asarray(image).reshape(-1)
        return np.where(self.valid, flat[self.index_map], fill_value)

    def lonlats(self):
        """(lon_grid, lat_grid) of the target cell centres (the notebook's
        ``area_def.get_lonlats()``, cell 10)."""
        txv, tyv = self._cell_centers()
        lon, lat = self.proj.inverse(txv, tyv)
        return lon, lat

    def resample_points_to_utm(self, point_lats, point_lons):
        x, y = self.proj.forward(np.asarray(point_lons), np.asarray(point_lats))
        return list(zip(x, y))

    def resample_point_to_geo(self, point_y, point_x):
        return self.proj.inverse(point_x, point_y)

