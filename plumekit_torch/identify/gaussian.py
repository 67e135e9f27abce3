"""Multi-scale, multi-orbit detector (``plumekit/identify/gaussian.py``; the
reference's ``plume_identifier_gaussian_profile.py``) on the port's sweep.

What differs from rg, all reproduced: every orbit layer is processed;
nulls are in-painted before detection (jump flooding on the device); raw
fires are clustered by rasterise, label, remove-small (the K2 entry)
instead of DBSCAN; three threshold sweeps of 25 levels run per layer
(steps 0.02/0.03/0.04 up to 0.5/0.75/1.0); the gates add at most 20% null
pixels, an axis ratio of at least 8 and at most 3 transect peaks; the
accepted mask is buffered by a 5×5 dilation before its hull is taken; only
hulls are written.
"""

from __future__ import annotations

import numpy as np
import torch

from plumekit_torch.config.identify import GaussianIdentifyConfig
from plumekit_torch.device import resolve_device
from plumekit_torch.identify.locate import locate_fires_in_image, pad_fires
from plumekit_torch.identify.pipeline import (SweepStatics,
                                              make_sweep_identifier,
                                              validate_descending_thresholds)
from plumekit_torch.identify.rg import (HULL_COLUMNS, _to_host,
                                        build_scene_dataframes)
from plumekit_torch.io.fires import n_fires, subset_fires_to_image
from plumekit_torch.io.granule import Granule
from plumekit_torch.io.tables import Table
from plumekit_torch.ops.cluster import raster_cluster_centroids
from plumekit_torch.ops.inpaint import nearest_fill
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

GRANULE_HULL_COLUMNS = HULL_COLUMNS + ("datetime",)


def _statics(cfg: GaussianIdentifyConfig) -> SweepStatics:
    return SweepStatics(
        win_half=cfg.win_half,
        min_plume_pixels=cfg.min_plume_pixels,
        max_plume_pixels=cfg.max_plume_pixels,
        max_lim=cfg.max_lim,
        axis_ratio=cfg.min_axis_ratio,
        max_peaks=cfg.max_peaks,
        n_transect=cfg.n_transect,
        savgol_window=0,                       # unsmoothed transect
        check_null=True,
        max_invalid_frac=cfg.max_invalid_frac,
        use_mask_b=False,                      # only the chosen index is vetted
        reject_last_threshold=cfg.compat.reject_last_threshold,
        dilate_plume_px=cfg.dilate_plume_px,
    )


def load_fires(lat, lon, fires, date_to_find, cfg: GaussianIdentifyConfig):
    """Subset (no FRP gate) and locate every raw fire: ``load_fires``
    (``plume_identifier_gaussian_profile.py:526-539``)."""
    sub = subset_fires_to_image(lat, lon, fires, date_to_find)
    if not n_fires(sub):
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    return locate_fires_in_image(sub["latitude"], sub["longitude"], lat, lon,
                                 cfg.win_half)


def cluster_fire_centroids(shape, fire_rows, fire_cols,
                           cfg: GaussianIdentifyConfig, device="cuda"):
    """Pad the raw fires to ``max_fires`` (no bucketing, as the JAX
    package) and cluster them on ``device``. Depends only on the fire table
    and the grid, so a multi-orbit granule computes it once."""
    if len(fire_rows) > cfg.max_fires:
        logger.warning("raw fires (%d) exceed capacity (%d); truncating "
                       "before clustering", len(fire_rows), cfg.max_fires)
    device = resolve_device(device)
    f_rows, f_cols, f_valid = pad_fires(fire_rows, fire_cols, cfg.max_fires)
    with torch.inference_mode():
        return raster_cluster_centroids(
            shape, torch.from_numpy(f_rows).to(device),
            torch.from_numpy(f_cols).to(device),
            torch.from_numpy(f_valid).to(device), cfg.min_fire_cluster_px)


def identify_layer(aod: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                   fire_rows: np.ndarray, fire_cols: np.ndarray,
                   cfg: GaussianIdentifyConfig = GaussianIdentifyConfig(),
                   clusters=None, device="cuda") -> Table:
    """One orbit layer to its hull table
    (``plume_identifier_gaussian_profile.py:464-518`` call order): plume ids
    run on from one threshold set to the next. ``clusters`` is a
    :func:`cluster_fire_centroids` result on ``device``
    (:func:`identify_granule` passes it; a lone call computes it here)."""
    device = resolve_device(device)
    null_mask = aod == cfg.null_value
    if clusters is None:
        clusters = cluster_fire_centroids(aod.shape, fire_rows, fire_cols,
                                          cfg, device)
    cr, cc, cvalid = clusters
    fn = make_sweep_identifier(_statics(cfg))
    rows = []
    min_id = 0
    with torch.inference_mode():
        null_t = torch.from_numpy(null_mask).to(device)
        aod_i = nearest_fill(
            torch.from_numpy(np.ascontiguousarray(aod, np.float32))
            .to(device), null_t).contiguous()
        for thresholds in cfg.threshold_sets():
            thr = torch.from_numpy(
                validate_descending_thresholds(thresholds)).to(device)
            out = _to_host(fn(aod_i, aod_i, null_t, thr, cr, cc, cvalid))
            _, hull = build_scene_dataframes(out, lat, lon, dedup=False)
            if len(hull):
                rows += [(r[0] + min_id,) + r[1:] for r in hull.rows]
                min_id = int(max(r[0] for r in rows)) + 1
    return Table(HULL_COLUMNS, rows)


def identify_granule(granule: Granule, fires, date_to_find,
                     cfg: GaussianIdentifyConfig = GaussianIdentifyConfig(),
                     device="cuda") -> Table:
    """All orbit layers of a granule to one hull table with a ``datetime``
    column (``plume_identifier_gaussian_profile.py:606-644``). A scene with
    fewer than ``min_fires_per_scene`` located fires is skipped
    (``:598-600``) and gives an empty table."""
    device = resolve_device(device)
    fire_rows, fire_cols = load_fires(granule.lat, granule.lon, fires,
                                      date_to_find, cfg)
    table = Table(GRANULE_HULL_COLUMNS)
    if len(fire_rows) < cfg.min_fires_per_scene:
        logger.info("too few fires (%d) — skipping scene", len(fire_rows))
        return table
    clusters = cluster_fire_centroids(granule.shape, fire_rows, fire_cols,
                                      cfg, device)
    for ts, aod in granule.layers.items():
        hull = identify_layer(aod, granule.lat, granule.lon, fire_rows,
                              fire_cols, cfg, clusters=clusters,
                              device=device)
        table.rows += [r + (ts,) for r in hull.rows]
    return table
