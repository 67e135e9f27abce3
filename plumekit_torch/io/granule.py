"""Granule container and the formats of ``plumekit/io/granule.py``: the
``.npz`` / ``.h5`` fixtures, in numpy only, so both packages read each
other's files, and MAIAC MCD19A2 ``.hdf`` (HDF4) granules, read by
:mod:`plumekit_torch.io.hdf4` without ``pyhdf``."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from plumekit_torch.geo.sinusoidal import (grid_from_extent,
                                           parse_struct_metadata)
from plumekit_torch.io.hdf4 import SDFile

#: fill value for invalid AOD
NULL_VALUE = -999.0

#: MAIAC AOD scale factor (reference ``tools.py:89``)
AOD_SCALE = 0.001

#: every granule serialisation the JAX package understands, in probe order
GRANULE_EXTENSIONS = (".npz", ".h5", ".hdf5", ".hdf")


@dataclass
class Granule:
    """One scene: ``layers`` maps orbit timestamp → (H, W) float32 AOD with
    invalid pixels set to :data:`NULL_VALUE`; ``lat``/``lon`` are (H, W)."""

    layers: Dict[str, np.ndarray]
    lat: np.ndarray
    lon: np.ndarray
    name: str = "granule"

    @property
    def shape(self):
        return self.first_layer().shape

    def first_layer(self) -> np.ndarray:
        return next(iter(self.layers.values()))


#: hull-CSV timestamp of detectors that run on the first layer (rg, basic);
#: ``select`` stamps it on hull tables without a ``datetime`` column
LAYER0_SENTINEL = "layer0"


def resolve_layer(granule: Granule, ts) -> np.ndarray:
    """The AOD layer a hull-CSV ``datetime`` names, strictly: the sentinel
    and single-layer granules give the first layer, a known timestamp its
    layer, and an unknown timestamp on a multi-orbit granule raises rather
    than pair plume masks or decisions with another orbit's AOD."""
    ts = str(ts)
    if ts == LAYER0_SENTINEL:
        return granule.first_layer()
    if ts in granule.layers:
        return granule.layers[ts]
    if len(granule.layers) == 1:
        return granule.first_layer()
    raise ValueError(
        f"hull timestamp {ts!r} not among granule layers "
        f"{sorted(granule.layers)}; cannot pick an orbit layer")


def find_granule(directory: str, base: str) -> Optional[str]:
    """Path of the granule named ``base`` under ``directory`` in any
    serialisation of :data:`GRANULE_EXTENSIONS`, or None."""
    for ext in GRANULE_EXTENSIONS:
        cand = os.path.join(directory, base + ext)
        if os.path.exists(cand):
            return cand
    return None


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing .h5 files requires h5py, "
                          "which is not installed (granules can be .npz "
                          "instead)") from e
    return h5py


def save_granule(path: str, granule: Granule) -> None:
    """NPZ (``.npz``) or HDF5 (``.h5``/``.hdf5``) serialisation."""
    if path.endswith((".h5", ".hdf5")):
        with _h5py().File(path, "w") as f:
            f.create_dataset("lat", data=granule.lat)
            f.create_dataset("lon", data=granule.lon)
            g = f.create_group("layers")
            for ts, aod in granule.layers.items():
                g.create_dataset(ts, data=aod)
            f.attrs["name"] = granule.name
        return
    arrays = {"lat": granule.lat, "lon": granule.lon}
    for ts, aod in granule.layers.items():
        arrays[f"aod_{ts}"] = aod
    np.savez_compressed(path, name=granule.name, **arrays)


def load_granule(path: str) -> Granule:
    if path.endswith((".h5", ".hdf5")):
        with _h5py().File(path, "r") as f:
            layers = {ts: np.asarray(f["layers"][ts]) for ts in f["layers"]}
            return Granule(layers=layers, lat=np.asarray(f["lat"]),
                           lon=np.asarray(f["lon"]),
                           name=str(f.attrs.get("name", "granule")))
    if path.endswith(".hdf"):
        return read_maiac_hdf4(path)
    with np.load(path, allow_pickle=False) as data:
        layers = {k[len("aod_"):]: data[k]
                  for k in data.files if k.startswith("aod_")}
        name = str(data["name"]) if "name" in data.files else "granule"
        return Granule(layers=layers, lat=data["lat"], lon=data["lon"],
                       name=name)


def read_maiac_hdf4(path: str, max_layers_rule: bool = True,
                    correct_orbit_layer: bool = False) -> Granule:
    """Read a MAIAC MCD19A2 HDF4 granule with :class:`~plumekit_torch.io.
    hdf4.SDFile` (no ``pyhdf``), as ``plumekit/io/granule.py``'s reader does
    (``tools.read_modis_aod``, ``tools.py:67-130``): orbit timestamps from
    the ``Orbit_time_stamp`` attribute; if more than four, only the first
    "A"(qua) orbit (``tools.py:79-81``); ``Optical_Depth_055`` × 0.001 with
    negatives set to −999 (``tools.py:89-90``); the lat/lon grid from the
    ``StructMetadata.0`` corners.

    COMPAT: when the >4-orbit rule fires, the reference stores **layer 0**
    under the Aqua timestamp (``tools.py:84-90``); the default reproduces
    that, ``correct_orbit_layer=True`` reads the Aqua orbit's own layer.
    A missing global attribute raises a :class:`ValueError` naming it
    where the JAX package's reader raises a bare ``KeyError``.
    """
    with SDFile(path) as hdf:
        fattrs = hdf.attributes()
        for key in ("Orbit_time_stamp", "StructMetadata.0"):
            if key not in fattrs:
                raise ValueError(f"{path}: no global attribute {key!r}")
        timestamps = [t for t in fattrs["Orbit_time_stamp"].split(" ") if t]
        indexed = list(enumerate(timestamps))
        if max_layers_rule and len(timestamps) > 4:
            indexed = [(i, t) for i, t in indexed if "A" in t][:1]
            if not correct_orbit_layer:
                # reference quirk: enumerate over the FILTERED list reads
                # layer 0 regardless of which orbit the timestamp names
                indexed = [(0, t) for _i, t in indexed]

        layers: Dict[str, np.ndarray] = {}
        for i, timestamp in indexed:
            m = re.search(r"[0-9]{11}[A-Z]", timestamp)
            if m is None:
                raise ValueError(
                    f"{path}: malformed orbit timestamp {timestamp!r} in "
                    "Orbit_time_stamp (expected 11 digits + platform "
                    "letter, e.g. '20172302054A')")
            t = m.group()
            aod = hdf.select("Optical_Depth_055")[i, :, :].astype(
                np.float32) * AOD_SCALE
            aod[aod < 0] = NULL_VALUE
            layers[t] = aod

        if not layers:
            # >4-orbit granule with no Aqua ("A") stamp (e.g. a Terra-only
            # high-latitude tile): the reference dies with an IndexError
            raise ValueError(
                f"{path}: {len(timestamps)} orbit timestamps and none is an "
                "Aqua ('A') orbit — the reference's >4-layer rule "
                "(tools.py:79-81) selects Aqua only; pass "
                "max_layers_rule=False to keep every orbit")
        x0, y0, x1, y1 = parse_struct_metadata(fattrs["StructMetadata.0"])
    ny, nx = next(iter(layers.values())).shape
    lat, lon = grid_from_extent(x0, y0, x1, y1, ny, nx)
    return Granule(layers=layers, lat=lat, lon=lon,
                   name=os.path.basename(path)[:-4])
