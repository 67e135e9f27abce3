"""Curated-label training data of ``plumekit/train/curated.py``: curated
hull tables back into pixel masks, model-ready (channels, mask) samples
under ``model_data_dir`` (``prepare_model_data``) and the training set
read from them (``train_model --curated``)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from plumekit_torch.config.paths import PathsConfig
from plumekit_torch.io.granule import (Granule, find_granule, load_granule,
                                       resolve_layer)
from plumekit_torch.io.tables import Table, is_missing, unique
from plumekit_torch.train.data import GranuleSample, assemble_channels
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)


def rasterize_hulls(plumes: Table, shape) -> np.ndarray:
    """Union of the filled convex hulls (one per plume ``id``) as an (H, W)
    bool mask: Delaunay ``find_simplex >= 0`` over each hull's bbox, the
    selector's containment test. Hulls of fewer than 3 vertices, with NaN
    vertices or collinear are skipped."""
    from scipy.spatial import Delaunay, QhullError

    h, w = shape
    mask = np.zeros((h, w), dtype=bool)
    i_id = plumes.columns.index("id")
    i_x, i_y = plumes.columns.index("hull_x"), plumes.columns.index("hull_y")
    for pid in unique(plumes.column("id")):
        if is_missing(pid):
            continue        # pandas' groupby drops NaN keys
        rows = [r for r in plumes.rows if r[i_id] == pid]
        hx = np.array([r[i_x] for r in rows], dtype=np.float64)
        hy = np.array([r[i_y] for r in rows], dtype=np.float64)
        if len(hx) < 3 or np.isnan(hx).any() or np.isnan(hy).any():
            continue
        x0 = int(np.clip(np.floor(hx.min()), 0, w - 1))
        x1 = int(np.clip(np.ceil(hx.max()) + 1, 1, w))
        y0 = int(np.clip(np.floor(hy.min()), 0, h - 1))
        y1 = int(np.clip(np.ceil(hy.max()) + 1, 1, h))
        yy, xx = np.mgrid[y0:y1, x0:x1]
        pts = np.column_stack([xx.ravel(), yy.ravel()])
        try:
            inside = Delaunay(np.column_stack([hx, hy])).find_simplex(pts) >= 0
        except QhullError:
            continue
        mask[yy.ravel()[inside], xx.ravel()[inside]] = True
    return mask


def granule_to_channels(granule: Granule, ts: str, fires,
                        date=None) -> np.ndarray:
    """(H, W, 2) AOD and fire-density channels of one orbit layer: the
    fires of ``date`` on the image (all fires without a date), located with
    ``win_half=0, edge_margin=0``."""
    from plumekit_torch.identify.locate import locate_fires_in_image
    from plumekit_torch.io.fires import n_fires, subset_fires_to_image

    # strict: an unknown timestamp on a multi-orbit granule raises
    aod = resolve_layer(granule, ts)
    rows = cols = np.zeros(0, np.int32)
    if fires is not None and n_fires(fires):
        sub = (subset_fires_to_image(granule.lat, granule.lon, fires, date)
               if date is not None else fires)
        rows, cols = locate_fires_in_image(
            sub["latitude"], sub["longitude"], granule.lat, granule.lon,
            win_half=0, edge_margin=0)
    return assemble_channels(aod, rows, cols)


def masks_for_kept_ids(mask_npz_path: str, kept_ids,
                       shape) -> Optional[np.ndarray]:
    """Union of the kept plumes' device masks, or None when the npz lacks
    one of them (the caller falls back to hulls)."""
    with np.load(mask_npz_path) as data:
        union = np.zeros(shape, dtype=bool)
        for pid in kept_ids:
            key = str(int(pid))
            if key not in data:
                logger.warning("%s: kept id %s missing from mask npz — "
                               "falling back to hulls", mask_npz_path, key)
                return None
            union |= data[key].astype(bool)
    return union


def build_model_data(paths: PathsConfig, fire_csv: Optional[str] = None,
                     out_dir: Optional[str] = None, use_masks: bool = True,
                     uncurated: bool = False) -> List[str]:
    """For every curated hull CSV (``reduced/plume/hull/*_extent.csv``;
    with ``uncurated`` every identify hull CSV), write one npz per orbit
    layer, ``channels`` (H, W, 2) and ``mask`` (H, W) float32, under
    ``model_data_dir``; returns the paths. With ``use_masks`` a granule
    whose per-plume device-mask npz exists takes the union of its kept
    plumes' masks, else the hull fills."""
    from plumekit_torch.io.dates import granule_date
    from plumekit_torch.io.fires import load_fire_csv, n_fires

    reduced_dir = paths.ensure(
        "hull_df_dir" if uncurated else "reduced_plume_hull_dir")
    maiac_dir = paths.ensure("maiac_dir")
    out_dir = out_dir or paths.ensure("model_data_dir")
    fires = None
    if fire_csv is None:
        cand = os.path.join(paths.resolve("fires_dir"), "fires.csv")
        fire_csv = cand if os.path.exists(cand) else None
    if fire_csv is not None:
        fires = load_fire_csv(fire_csv)
        if not n_fires(fires):       # header-only CSV: same as no fires
            fires = None

    written: List[str] = []
    for fname in sorted(os.listdir(reduced_dir)):
        if not fname.endswith("_extent.csv"):
            continue
        plumes = Table.read_csv(os.path.join(reduced_dir, fname))
        if not len(plumes):
            continue
        if not {"hull_x", "hull_y"} <= set(plumes.columns):
            # the basic detector's bbox-only extent CSVs share the tree
            logger.info("%s has no hull columns (basic detector) — "
                        "skipping", fname)
            continue
        base = fname.replace("_extent.csv", "")
        gpath = find_granule(maiac_dir, base)
        if gpath is None:
            logger.warning("no granule for %s — skipping", fname)
            continue
        granule = load_granule(gpath)
        if "datetime" not in plumes.columns:
            # the granule's first layer key, where select stamps "layer0"
            plumes = plumes.with_column("datetime", next(iter(granule.layers)))
        date = None
        if fires is not None:
            date = granule_date(base, default=fires["date_time"][0])
        mask_npz = os.path.join(paths.resolve("plume_mask_dir"),
                                base + "_masks.npz")
        i_dt = plumes.columns.index("datetime")
        for ts in unique(plumes.column("datetime")):
            kept = plumes.where(lambda r: r[i_dt] == ts)
            kept_ids = unique(kept.column("id"))
            mask = None
            src = "hulls"
            if use_masks and os.path.exists(mask_npz):
                mask = masks_for_kept_ids(mask_npz, kept_ids, granule.shape)
                src = "device masks"
            if mask is None:
                mask = rasterize_hulls(kept, granule.shape)
                src = "hulls"
            channels = granule_to_channels(granule, str(ts), fires, date)
            out = os.path.join(out_dir, f"{base}__{ts}.npz")
            np.savez_compressed(out, channels=channels,
                                mask=mask.astype(np.float32))
            written.append(out)
            logger.info("%s: %d plume px (%d plumes, from %s)", out,
                        int(mask.sum()),
                        len([i for i in kept_ids if not is_missing(i)]), src)
    return written


def make_curated_dataset(model_data_dir: str) -> List[GranuleSample]:
    """Every model-ready npz under ``model_data_dir``, in name order."""
    samples: List[GranuleSample] = []
    for fname in sorted(os.listdir(model_data_dir)):
        if not fname.endswith(".npz"):
            continue
        with np.load(os.path.join(model_data_dir, fname)) as data:
            samples.append(GranuleSample(channels=data["channels"],
                                         mask=data["mask"]))
    if not samples:
        raise FileNotFoundError(
            f"no model-ready samples in {model_data_dir}; run "
            "'plumekit-torch prepare_model_data' after curation")
    return samples


__all__ = ["build_model_data", "granule_to_channels", "make_curated_dataset",
           "masks_for_kept_ids", "rasterize_hulls"]
