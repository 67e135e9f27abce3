"""Synthetic MAIAC-like scenes of ``plumekit/io/synthetic.py``, numpy and
scipy only: for the same config and seed the AOD layers, the lat/lon grids
and the fires' lat/lon/frp are the JAX package's bit for bit (the same
draws from the same ``numpy`` generator in the same order). Fires are a
fire table (:mod:`plumekit_torch.io.fires`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
from scipy import ndimage

from plumekit_torch.geo.sinusoidal import grid_from_extent, wgs84_to_sinusoidal
from plumekit_torch.io.fires import FireTable
from plumekit_torch.io.granule import NULL_VALUE, Granule


@dataclass(frozen=True)
class SyntheticSceneConfig:
    size: int = 256
    n_layers: int = 1
    n_plumes: int = 3
    n_background_blobs: int = 3
    background_level: float = 0.05
    background_noise: float = 0.015
    plume_amplitude: Tuple[float, float] = (0.5, 0.9)
    plume_sigma_major: Tuple[float, float] = (18.0, 30.0)
    plume_sigma_minor: Tuple[float, float] = (2.5, 4.0)
    blob_amplitude: Tuple[float, float] = (0.3, 0.6)
    blob_sigma: Tuple[float, float] = (8.0, 14.0)
    null_blobs: int = 0
    null_blob_sigma: float = 6.0
    fires_per_plume: Tuple[int, int] = (4, 9)
    fire_frp: Tuple[float, float] = (20.0, 300.0)
    extra_fires: int = 0
    distractor_blobs: int = 0
    distractor_amplitude: Tuple[float, float] = (0.4, 0.7)
    distractor_sigma: Tuple[float, float] = (7.0, 12.0)
    fires_per_distractor: Tuple[int, int] = (3, 6)
    center_lat: float = -10.0
    center_lon: float = -60.0
    pixel_size_m: float = 1000.0
    date: str = "2017-08-01"
    seed: int = 0
    gt_threshold: float = 0.1


@dataclass
class SyntheticScene:
    granule: Granule
    fires: FireTable
    #: (H, W) int32: 0 background, k > 0 for plume k
    gt_labels: np.ndarray
    plumes: List[dict]
    distractors: List[dict] = field(default_factory=list)

    @property
    def gt_mask(self) -> np.ndarray:
        return self.gt_labels > 0


def _grid(cfg: SyntheticSceneConfig):
    xc, yc = wgs84_to_sinusoidal(cfg.center_lon, cfg.center_lat)
    half = cfg.size / 2.0 * cfg.pixel_size_m
    return grid_from_extent(
        xc - half, yc + half, xc + half, yc - half, cfg.size, cfg.size
    )


def _anisotropic_gaussian(shape, r0, c0, theta, s_major, s_minor):
    rr, cc = np.mgrid[0 : shape[0], 0 : shape[1]].astype(np.float64)
    dr, dc = rr - r0, cc - c0
    u = dc * np.cos(theta) + dr * np.sin(theta)
    v = -dc * np.sin(theta) + dr * np.cos(theta)
    return np.exp(-0.5 * ((u / s_major) ** 2 + (v / s_minor) ** 2))


def make_scene(cfg: SyntheticSceneConfig) -> SyntheticScene:
    rng = np.random.default_rng(cfg.seed)
    H = W = cfg.size
    lat, lon = _grid(cfg)

    layers: Dict[str, np.ndarray] = {}
    gt_labels = np.zeros((H, W), dtype=np.int32)
    plumes: List[dict] = []
    fire_rows: List[int] = []
    fire_cols: List[int] = []
    fire_frps: List[float] = []

    margin = min(48, H // 4)
    for k in range(cfg.n_plumes):
        r0 = rng.uniform(margin, H - margin)
        c0 = rng.uniform(margin, W - margin)
        theta = rng.uniform(0, np.pi)
        s_major = rng.uniform(*cfg.plume_sigma_major)
        s_minor = rng.uniform(*cfg.plume_sigma_minor)
        amp = rng.uniform(*cfg.plume_amplitude)
        # the plume extends downwind: centred one major sigma from its origin
        rc = r0 + s_major * np.sin(theta)
        cc = c0 + s_major * np.cos(theta)
        g = _anisotropic_gaussian((H, W), rc, cc, theta, s_major, s_minor)
        plumes.append(
            dict(origin=(r0, c0), center=(rc, cc), theta=theta,
                 sigma_major=s_major, sigma_minor=s_minor, amplitude=amp)
        )
        gt_labels[(amp * g) > cfg.gt_threshold] = k + 1

        n_f = rng.integers(cfg.fires_per_plume[0], cfg.fires_per_plume[1] + 1)
        for _ in range(n_f):
            fire_rows.append(int(np.clip(r0 + rng.normal(0, 1.5), 0, H - 1)))
            fire_cols.append(int(np.clip(c0 + rng.normal(0, 1.5), 0, W - 1)))
            fire_frps.append(float(rng.uniform(*cfg.fire_frp)))

    distractors: List[dict] = []
    for _ in range(cfg.distractor_blobs):
        dr = rng.uniform(margin, H - margin)
        dc = rng.uniform(margin, W - margin)
        ds = rng.uniform(*cfg.distractor_sigma)
        da = rng.uniform(*cfg.distractor_amplitude)
        ecc = rng.uniform(1.0, 1.6)
        th = rng.uniform(0, np.pi)
        distractors.append(dict(center=(dr, dc), theta=th,
                                sigma_major=ds * ecc, sigma_minor=ds,
                                amplitude=da))
        n_f = rng.integers(cfg.fires_per_distractor[0],
                           cfg.fires_per_distractor[1] + 1)
        for _ in range(n_f):
            fire_rows.append(int(np.clip(dr + rng.normal(0, 1.5), 0, H - 1)))
            fire_cols.append(int(np.clip(dc + rng.normal(0, 1.5), 0, W - 1)))
            fire_frps.append(float(rng.uniform(*cfg.fire_frp)))

    for _ in range(cfg.extra_fires):
        fire_rows.append(int(rng.uniform(margin, H - margin)))
        fire_cols.append(int(rng.uniform(margin, W - margin)))
        fire_frps.append(float(rng.uniform(*cfg.fire_frp)))

    for li in range(cfg.n_layers):
        noise = rng.normal(0.0, 1.0, (H, W))
        aod = cfg.background_level + cfg.background_noise * ndimage.gaussian_filter(
            noise, 4.0
        ) * 10.0
        aod = np.clip(aod, 0.0, None)
        for p in plumes:
            aod += p["amplitude"] * _anisotropic_gaussian(
                (H, W), *p["center"], p["theta"], p["sigma_major"], p["sigma_minor"]
            )
        for p in distractors:
            aod += p["amplitude"] * _anisotropic_gaussian(
                (H, W), *p["center"], p["theta"], p["sigma_major"], p["sigma_minor"]
            )
        for _ in range(cfg.n_background_blobs):
            br = rng.uniform(margin, H - margin)
            bc = rng.uniform(margin, W - margin)
            bs = rng.uniform(*cfg.blob_sigma)
            ba = rng.uniform(*cfg.blob_amplitude)
            aod += ba * _anisotropic_gaussian((H, W), br, bc, 0.0, bs, bs)
        for _ in range(cfg.null_blobs):
            nr = int(rng.uniform(0, H))
            nc = int(rng.uniform(0, W))
            rr, ccg = np.mgrid[0:H, 0:W]
            hole = ((rr - nr) ** 2 + (ccg - nc) ** 2) < cfg.null_blob_sigma**2
            aod[hole] = NULL_VALUE
        ts = f"20172{li:02d}0000A"  # MAIAC-style timestamp
        layers[ts] = aod.astype(np.float32)

    granule = Granule(layers=layers, lat=lat, lon=lon,
                      name=f"SYNTH.{cfg.seed:08d}")
    fires = make_fire_table(lat, lon, fire_rows, fire_cols, fire_frps,
                            cfg.date, rng)
    return SyntheticScene(granule=granule, fires=fires, gt_labels=gt_labels,
                          plumes=plumes, distractors=distractors)


def make_fire_table(lat, lon, rows, cols, frps, date: str, rng=None
                    ) -> FireTable:
    """VIIRS-like fire table at the given pixels (``make_fire_dataframe``
    of the JAX package). Sub-pixel jitter keeps fire coordinates off exact
    cell centres, as real detections are."""
    rng = rng or np.random.default_rng(0)
    rows = np.asarray(rows, dtype=int)
    cols = np.asarray(cols, dtype=int)
    jitter = 0.002  # deg, well under the 0.05-deg location box
    return {
        "latitude": lat[rows, cols] + rng.uniform(-jitter, jitter, rows.size),
        "longitude": lon[rows, cols] + rng.uniform(-jitter, jitter, rows.size),
        "frp": np.asarray(frps, dtype=float),
        "acq_date": np.full(rows.size, date),
        "date_time": np.full(rows.size, np.datetime64(date, "D")),
    }


def write_fire_csv(path: str, fires: FireTable) -> None:
    """Write ``latitude, longitude, frp, acq_date`` as ``make_dataset`` of
    the JAX package does (floats at full precision)."""
    import csv

    cols = ["latitude", "longitude", "frp", "acq_date"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in zip(*(fires[c] for c in cols)):
            w.writerow([repr(float(v)) for v in row[:3]] + [str(row[3])])
