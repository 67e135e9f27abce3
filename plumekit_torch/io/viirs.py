"""VIIRS SDR swaths and their reprojection onto UTM grids
(``plumekit/io/viirs.py``): the swath container (curvilinear lat/lon and
named channels), a synthetic swath with VIIRS scan geometry, and
:func:`reproject_swath`, which writes the ``raw/reprojected_viirs``
products of the reference's layout (``filepaths.py:13-16``).

h5py and matplotlib are imported only where a file is written, since the
machine with the card has neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from plumekit_torch.geo.utm import UTMResampler
from plumekit_torch.io.granule import _h5py

#: fill of off-swath grid cells, as the AOD null
FILL_VALUE = -999.0


@dataclass
class Swath:
    """One VIIRS-like granule in scan geometry: curvilinear ``lat``/``lon``
    of shape (lines, samples) and named channel rasters of that shape."""

    lat: np.ndarray
    lon: np.ndarray
    channels: Dict[str, np.ndarray] = field(default_factory=dict)
    name: str = "swath"

    @property
    def shape(self):
        return self.lat.shape


def save_swath(path: str, swath: Swath) -> None:
    arrays = {"lat": swath.lat, "lon": swath.lon}
    for ch, img in swath.channels.items():
        arrays[f"ch_{ch}"] = img
    np.savez_compressed(path, name=swath.name, **arrays)


def load_swath(path: str) -> Swath:
    with np.load(path, allow_pickle=False) as data:
        channels = {k[len("ch_"):]: data[k]
                    for k in data.files if k.startswith("ch_")}
        name = str(data["name"]) if "name" in data.files else "swath"
        return Swath(lat=data["lat"], lon=data["lon"], channels=channels,
                     name=name)


def make_synthetic_swath(
    lines: int = 96,
    samples: int = 128,
    center_lat: float = -10.0,
    center_lon: float = -60.0,
    track_azimuth_deg: float = 15.0,
    nadir_km: float = 0.75,
    edge_growth: float = 2.0,
    seed: int = 0,
    name: str = "viirs_swath",
) -> Swath:
    """A swath with VIIRS scan geometry: the cross-track spacing grows from
    ``nadir_km`` at nadir to ``edge_growth`` times it at the scan edges
    (the bowtie), and the ground track is rotated by
    ``track_azimuth_deg``. Channels ``blue``, ``aod``, ``red`` and
    ``green``; the same arrays as the JAX package's for the same
    arguments."""
    rng = np.random.default_rng(seed)
    j = np.arange(samples) - (samples - 1) / 2.0
    spacing = nadir_km * (1.0 + (edge_growth - 1.0) * (j / j[-1]) ** 2)
    cross_km = np.cumsum(spacing) - np.cumsum(spacing)[samples // 2]
    along_km = (np.arange(lines) - (lines - 1) / 2.0) * nadir_km

    az = np.radians(track_azimuth_deg)
    xk = along_km[:, None] * np.sin(az) + cross_km[None, :] * np.cos(az)
    yk = along_km[:, None] * np.cos(az) - cross_km[None, :] * np.sin(az)

    km_per_deg_lat = 111.32
    km_per_deg_lon = km_per_deg_lat * np.cos(np.radians(center_lat))
    lat = center_lat + yk / km_per_deg_lat
    lon = center_lon + xk / km_per_deg_lon

    yy, xx = np.mgrid[0:lines, 0:samples].astype(np.float64)
    blue = (
        0.3
        + 0.2 * np.sin(2 * np.pi * xx / samples) * np.cos(2 * np.pi * yy / lines)
        + 0.02 * rng.standard_normal((lines, samples))
    ).astype(np.float32)
    r0, c0 = lines * 0.4, samples * 0.5
    aod = (
        0.1
        + 0.8 * np.exp(-0.5 * (((yy - r0) / (lines * 0.08)) ** 2
                               + ((xx - c0) / (samples * 0.25)) ** 2))
    ).astype(np.float32)
    red = (0.25 + 0.15 * (xx / samples)).astype(np.float32)
    green = (0.25 + 0.15 * (yy / lines)).astype(np.float32)
    return Swath(lat=lat, lon=lon,
                 channels={"blue": blue, "aod": aod, "red": red,
                           "green": green},
                 name=name)


def reproject_swath(
    swath: Swath,
    pixel_size_m: float = 750.0,
    radius_of_influence_m: float = 10000.0,
):
    """Every channel of a swath resampled onto its modal-zone UTM grid:
    ``(resampler, {channel: (y, x) float32 raster})``, off-swath cells at
    :data:`FILL_VALUE`. One plan serves every channel."""
    resampler = UTMResampler(swath.lat, swath.lon, pixel_size_m,
                             radius_of_influence=radius_of_influence_m)
    out = {
        ch: np.asarray(resampler.resample_image(img, fill_value=FILL_VALUE),
                       dtype=np.float32)
        for ch, img in swath.channels.items()
    }
    return resampler, out


def write_reprojected_h5(path: str, resampler: UTMResampler,
                         rasters: Dict[str, np.ndarray]) -> None:
    """The ``raw/reprojected_viirs/h5`` product: one dataset per channel,
    ``valid``, and the grid's metadata as attributes."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        for ch, img in rasters.items():
            f.create_dataset(ch, data=img)
        f.create_dataset("valid", data=resampler.valid)
        f.attrs["utm_zone"] = resampler.zone
        f.attrs["south"] = resampler.south
        f.attrs["pixel_size_m"] = resampler.pixel_size
        f.attrs["extent"] = np.asarray(resampler.extent, dtype=np.float64)
        f.attrs["fill_value"] = FILL_VALUE


def write_quicklooks(base: str, rasters: Dict[str, np.ndarray],
                     blue_dir: str, tcc_dir: str) -> None:
    """The blue-channel and true-colour PNGs of the reference's
    ``reprojected_viirs/{blue,tcc}`` directories."""
    from plumekit_torch.viz.plots import _plt

    plt = _plt("--quicklooks")

    def norm(a):
        v = np.where(a == FILL_VALUE, np.nan, a)
        if not np.isfinite(v).any():      # a channel wholly off the grid
            return np.zeros_like(a, dtype=np.float32)
        lo, hi = np.nanmin(v), np.nanmax(v)
        return np.nan_to_num((v - lo) / max(hi - lo, 1e-9))

    if "blue" in rasters:
        plt.imsave(os.path.join(blue_dir, base + "_blue.png"),
                   norm(rasters["blue"]), cmap="gray")
    if all(ch in rasters for ch in ("red", "green", "blue")):
        rgb = np.stack([norm(rasters[c]) for c in ("red", "green", "blue")],
                       axis=-1)
        plt.imsave(os.path.join(tcc_dir, base + "_tcc.png"), rgb)
