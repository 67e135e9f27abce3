"""VIIRS IP aerosol granules: the reference notebook's workflow
(``notebooks/Identifying plumes from AOD and Active Fires.ipynb``) as
``plumekit/io/viirs_aod.py`` runs it.

An IVAOT granule (``All_Data/VIIRS-Aeros-Opt-Thick-IP_All/faot550``, cell
6) and its terrain-corrected GMTCO geolocation are paired by their IDPS
file names, resampled onto a 750 m grid of the modal UTM zone with invalid
AOD left out of the source set (cell 10), and the fixed-threshold
detector runs on the resampled raster against the scene date's fires
(cells 13-25).

The h5 decode and the plan stay on the host; the detector runs on the
device it is given (its mask labels through the K2 kernel on the card).
:func:`identify_viirs_arrays` takes the decoded arrays, so that a machine
without h5py runs the path too.
"""

from __future__ import annotations

import datetime as _dt
import os
import re
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from plumekit_torch.geo.utm import UTMResampler
from plumekit_torch.io.granule import _h5py
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

#: HDF5 dataset paths of notebook cell 6
IVAOT_DATASET = "All_Data/VIIRS-Aeros-Opt-Thick-IP_All/faot550"
GMTCO_LAT = "All_Data/VIIRS-MOD-GEO-TC_All/Latitude"
GMTCO_LON = "All_Data/VIIRS-MOD-GEO-TC_All/Longitude"

# an IDPS granule file name (notebook cell 4), e.g.
# IVAOT_npp_d20160822_t1702001_e1703242_b24974_c20181017161815133750_noaa_ops.h5
_STAMP_RE = re.compile(
    r"^(?P<product>[A-Z0-9]+)_(?P<platform>[a-z0-9]+)"
    r"_d(?P<date>\d{8})_t(?P<start>\d{7})_e(?P<end>\d{7})"
    r"_b(?P<orbit>\d+)_c(?P<created>\d+)_(?P<origin>\w+)\.h5$"
)


@dataclass(frozen=True)
class GranuleStamp:
    """The identity fields of an IDPS VIIRS granule file name."""

    product: str
    platform: str
    date: _dt.date
    start: str
    end: str
    orbit: int

    @property
    def key(self) -> Tuple[str, str, str, str, int]:
        """Pairing key: two products of one granule differ only in the
        product code and the creation stamp (notebook cell 4)."""
        return (self.platform, self.date.isoformat(), self.start, self.end,
                self.orbit)


def parse_granule_filename(fname: str) -> Optional[GranuleStamp]:
    m = _STAMP_RE.match(os.path.basename(fname))
    if not m:
        return None
    d = m.group("date")
    return GranuleStamp(
        product=m.group("product"),
        platform=m.group("platform"),
        date=_dt.date(int(d[:4]), int(d[4:6]), int(d[6:8])),
        start=m.group("start"),
        end=m.group("end"),
        orbit=int(m.group("orbit")),
    )


def format_granule_filename(stamp: GranuleStamp,
                            created: str = "0" * 20,
                            origin: str = "noaa_ops") -> str:
    return (f"{stamp.product}_{stamp.platform}"
            f"_d{stamp.date:%Y%m%d}_t{stamp.start}_e{stamp.end}"
            f"_b{stamp.orbit:05d}_c{created}_{origin}.h5")


def read_ivaot_aod(path: str) -> np.ndarray:
    """The faot550 layer as float32; every fill class stays negative (the
    notebook takes ``aod < 0`` as invalid, cell 10)."""
    with _h5py().File(path, "r") as f:
        return np.asarray(f[IVAOT_DATASET][:], dtype=np.float32)


def read_gmtco_geo(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(lat, lon) float64 swath grids of the terrain-corrected geo file."""
    with _h5py().File(path, "r") as f:
        lat = np.asarray(f[GMTCO_LAT][:], dtype=np.float64)
        lon = np.asarray(f[GMTCO_LON][:], dtype=np.float64)
    return lat, lon


def pair_granules(aod_dir: str, geo_dir: str) -> List[Dict[str, str]]:
    """IVAOT files matched to their GMTCO companions by granule identity:
    ``[{"aod": path, "geo": path, "stamp": GranuleStamp}, ...]`` sorted by
    (date, start). An unpaired file is logged and skipped."""
    geos: Dict[tuple, str] = {}
    for fname in sorted(os.listdir(geo_dir)):
        st = parse_granule_filename(fname)
        if st is not None and st.product == "GMTCO":
            geos[st.key] = os.path.join(geo_dir, fname)

    pairs: List[Dict[str, str]] = []
    for fname in sorted(os.listdir(aod_dir)):
        st = parse_granule_filename(fname)
        if st is None or st.product != "IVAOT":
            continue
        geo = geos.get(st.key)
        if geo is None:
            logger.warning("no GMTCO companion for %s; skipping", fname)
            continue
        pairs.append({"aod": os.path.join(aod_dir, fname), "geo": geo,
                      "stamp": st})
    pairs.sort(key=lambda p: (p["stamp"].date, p["stamp"].start))
    return pairs


def resample_viirs_aod(
    aod: np.ndarray,
    lat: np.ndarray,
    lon: np.ndarray,
    pixel_size_m: float = 750.0,
    radius_of_influence_m: float = 10000.0,
):
    """Notebook cells 9-10: a UTM grid over the swath, invalid AOD
    (``aod < 0``) and off-earth geolocation left out of the source set,
    off-grid cells NaN. Returns ``(resampler, aod_r (y, x) float32,
    lat_grid, lon_grid)``."""
    valid = (aod >= 0) & (np.abs(lat) <= 90) & (np.abs(lon) <= 180)
    resampler = UTMResampler(
        lat, lon, pixel_size_m,
        radius_of_influence=radius_of_influence_m,
        source_valid=valid,
    )
    aod_r = np.asarray(resampler.resample_image(aod, fill_value=np.nan),
                       dtype=np.float32)
    lon_grid, lat_grid = resampler.lonlats()
    return resampler, aod_r, lat_grid, lon_grid


def identify_viirs_arrays(aod, lat, lon, date, fires, cfg=None,
                          pixel_size_m: float = 750.0, device="cuda"):
    """The notebook's resample and fixed-threshold identify on decoded
    arrays: ``date`` is the scene's day (``datetime64[D]``), ``fires`` a
    fire table (:mod:`plumekit_torch.io.fires`). The detector runs on
    ``device`` over the raster with its NaN cells at -999, which fail the
    background-ratio screen and the 0.2 mask.

    Returns ``(plume_dict, plume_image, aod_r, resampler)``, the first two
    as :func:`plumekit_torch.identify.basic.identify` gives them."""
    from plumekit_torch.config.identify import BasicIdentifyConfig
    from plumekit_torch.identify import basic

    resampler, aod_r, lat_grid, lon_grid = resample_viirs_aod(
        aod, lat, lon, pixel_size_m)
    plume_dict, plume_image = basic.identify(
        np.nan_to_num(aod_r, nan=-999.0), lat_grid, lon_grid,
        np.datetime64(date, "D"), fires, cfg or BasicIdentifyConfig(),
        device=device)
    return plume_dict, plume_image, aod_r, resampler


def identify_viirs_aod(aod_path: str, geo_path: str, fires, cfg=None,
                       pixel_size_m: float = 750.0, device="cuda"):
    """The notebook end to end (cells 4-25) on an IVAOT/GMTCO file pair:
    the scene date from the IVAOT file name, then
    :func:`identify_viirs_arrays`."""
    stamp = parse_granule_filename(aod_path)
    if stamp is None:
        raise ValueError(f"not an IDPS granule filename: {aod_path}")
    aod = read_ivaot_aod(aod_path)
    lat, lon = read_gmtco_geo(geo_path)
    if aod.shape != lat.shape:
        raise ValueError(
            f"AOD swath {aod.shape} does not match geolocation {lat.shape}; "
            "mispaired granules?")
    return identify_viirs_arrays(aod, lat, lon, stamp.date, fires, cfg,
                                 pixel_size_m, device=device)


def make_synthetic_ivaot_scene(
    lines: int = 96,
    samples: int = 128,
    date: _dt.date = _dt.date(2016, 8, 22),
    seed: int = 0,
    n_plumes: int = 1,
    fill_fraction: float = 0.06,
):
    """A notebook-shaped synthetic scene: a swath with scan geometry,
    plumes rooted at fire clusters, a stripe of negative retrieval fills
    and a fire table of the granule's date. The same draws in the same
    order as the JAX package's, so the arrays and the fire table are its.

    Returns ``(stamp, aod (lines, samples) float32, lat, lon, fires,
    plume_origins_swath_rc)``."""
    from plumekit_torch.io.synthetic import (_anisotropic_gaussian,
                                             make_fire_table)
    from plumekit_torch.io.viirs import make_synthetic_swath

    rng = np.random.default_rng(seed)
    sw = make_synthetic_swath(lines=lines, samples=samples, seed=seed)
    lat, lon = sw.lat, sw.lon

    aod = (0.05 + 0.02 * rng.standard_normal((lines, samples))
           ).astype(np.float32)
    aod = np.clip(aod, 0.0, None)
    origins = []
    fire_rows, fire_cols, frps = [], [], []
    for _ in range(n_plumes):
        r0 = rng.uniform(0.3, 0.7) * lines
        c0 = rng.uniform(0.25, 0.6) * samples
        theta = rng.uniform(0, np.pi)
        s_major, s_minor = 12.0, 3.0
        rc = r0 + s_major * np.sin(theta)
        cc = c0 + s_major * np.cos(theta)
        aod += 0.7 * _anisotropic_gaussian(
            (lines, samples), rc, cc, theta, s_major, s_minor
        ).astype(np.float32)
        origins.append((int(r0), int(c0)))
        for _ in range(4):
            fire_rows.append(int(np.clip(r0 + rng.normal(0, 1.2), 0,
                                         lines - 1)))
            fire_cols.append(int(np.clip(c0 + rng.normal(0, 1.2), 0,
                                         samples - 1)))
            frps.append(float(rng.uniform(30.0, 200.0)))

    # a retrieval-failure stripe: the product encodes fills below zero
    n_fill = int(fill_fraction * lines)
    if n_fill:
        aod[:n_fill] = -999.3

    fires = make_fire_table(lat, lon, fire_rows, fire_cols, frps,
                            date.isoformat(), rng)
    stamp = GranuleStamp(product="IVAOT", platform="npp", date=date,
                         start="1702001", end="1703242", orbit=24974 + seed)
    return stamp, aod, lat, lon, fires, origins


def write_synthetic_pair(
    aod_dir: str,
    geo_dir: str,
    stamp: GranuleStamp,
    aod: np.ndarray,
    lat: np.ndarray,
    lon: np.ndarray,
) -> Tuple[str, str]:
    """An IVAOT/GMTCO pair in the notebook's h5 layout, geolocation as
    float32 as the product stores it."""
    h5py = _h5py()
    aod_path = os.path.join(
        aod_dir, format_granule_filename(replace(stamp, product="IVAOT")))
    geo_path = os.path.join(
        geo_dir, format_granule_filename(replace(stamp, product="GMTCO")))
    with h5py.File(aod_path, "w") as f:
        f.create_dataset(IVAOT_DATASET, data=np.asarray(aod, np.float32))
    with h5py.File(geo_path, "w") as f:
        f.create_dataset(GMTCO_LAT, data=np.asarray(lat, np.float32))
        f.create_dataset(GMTCO_LON, data=np.asarray(lon, np.float32))
    return aod_path, geo_path
