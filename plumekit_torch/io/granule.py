"""Granule container and the ``.npz`` / ``.h5`` formats of
``plumekit/io/granule.py``, in numpy only, so both packages read each
other's files."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

#: fill value for invalid AOD
NULL_VALUE = -999.0

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
        raise NotImplementedError(
            f"{path}: MAIAC HDF4 granules are not read by plumekit_torch yet "
            "(ROADMAP.md, queue A: 'MAIAC HDF4 reader'); convert them to "
            ".npz with the JAX package's load_granule/save_granule")
    with np.load(path, allow_pickle=False) as data:
        layers = {k[len("aod_"):]: data[k]
                  for k in data.files if k.startswith("aod_")}
        name = str(data["name"]) if "name" in data.files else "granule"
        return Granule(layers=layers, lat=data["lat"], lon=data["lon"],
                       name=name)
