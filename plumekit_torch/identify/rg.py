"""Threshold-sweep ("region growth") detector — the rg driver of
``plumekit/identify/rg.py``.

Host side: fire subsetting, clustering and location, convex hulls and the
result tables (ragged, numpy/scipy). Device side: the whole 20-threshold
sweep (:mod:`plumekit_torch.identify.pipeline`) on the device of the AOD
tensor it is given.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from plumekit_torch.config.identify import RGIdentifyConfig
from plumekit_torch.identify.locate import locate_fires_in_image, pad_fires
from plumekit_torch.identify.pipeline import (SweepStatics,
                                              make_sweep_identifier,
                                              validate_descending_thresholds)
from plumekit_torch.io.fires import n_fires, subset_fires_to_image
from plumekit_torch.ops.cluster import mean_cluster_positions
from plumekit_torch.ops.geometry import convex_hull_vertices_host
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

AOD_COLUMNS = ("id", "plume_pixel_extent", "plume_min_row", "plume_max_row",
               "plume_min_col", "plume_max_col", "plume_aod_mean",
               "plume_aod_sd", "bg_aod_level")
HULL_COLUMNS = ("id", "hull_lats", "hull_lons", "hull_x", "hull_y")


@dataclass
class Table:
    """Rows of plain Python values under named columns: the port's stand-in
    for the JAX package's result dataframes."""

    columns: Tuple[str, ...]
    rows: List[tuple] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    def to_csv(self, path: str) -> None:
        """Header and rows; floats at full precision (``repr``), as
        pandas writes them."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            w.writerows(self.rows)


def _statics(cfg: RGIdentifyConfig) -> SweepStatics:
    return SweepStatics(
        win_half=cfg.win_half,
        min_plume_pixels=cfg.min_plume_pixels,
        max_plume_pixels=cfg.max_plume_pixels,
        max_lim=cfg.max_lim,
        axis_ratio=cfg.side_ratio,
        max_peaks=cfg.max_peaks,
        n_transect=cfg.n_transect,
        savgol_window=cfg.savgol_window,
        savgol_polyorder=cfg.savgol_polyorder,
        check_null=False,
        use_mask_b=True,
        pick_larger_mask=cfg.compat.pick_larger_mask,
        reject_last_threshold=cfg.compat.reject_last_threshold,
        dilate_plume_px=0,
    )


def _prep_fires(lat, lon, date_to_find, fires, cfg, capacity=None):
    """Subset the fire table to the scene and date, cluster, locate on the
    grid, pad. ``capacity=None`` buckets to this scene's own count."""
    subset = subset_fires_to_image(lat, lon, fires, date_to_find,
                                   min_frp=cfg.min_frp)
    logger.info("...extracted %d fires for image roi", n_fires(subset))
    if n_fires(subset):
        c_lat, c_lon = mean_cluster_positions(subset, cfg.cluster_dist_km)
        rows, cols = locate_fires_in_image(c_lat, c_lon, lat, lon,
                                           cfg.win_half)
    else:
        rows = cols = np.zeros((0,), np.int32)
    logger.info("...located %d fire clusters on grid", len(rows))
    if len(rows) > cfg.max_fires:
        logger.warning("fire clusters (%d) exceed capacity (%d); truncating",
                       len(rows), cfg.max_fires)
    if capacity is None:
        return pad_fires(rows, cols, cfg.max_fires, bucket=True)
    return pad_fires(rows, cols, capacity)


def _to_host(out: dict) -> dict:
    """The sweep's tensors as numpy; of the (F, H, W) mask only the rows
    of accepted fires are copied (the rest are all False)."""
    host = {k: v.cpu().numpy() for k, v in out.items() if k != "mask"}
    mask = np.zeros(tuple(out["mask"].shape), dtype=bool)
    keep = np.nonzero(host["accepted"])[0]
    if keep.size:
        mask[keep] = out["mask"][torch.from_numpy(keep).to(
            out["mask"].device)].cpu().numpy()
    host["mask"] = mask
    return host


def identify(aod: np.ndarray, lat: np.ndarray, lon: np.ndarray,
             date_to_find, fires, cfg: RGIdentifyConfig = RGIdentifyConfig(),
             device="cpu"):
    """Identify one scene (``plume_identifier_rg.py:460-506`` call order)
    with the sweep on ``device``. Returns ``(aod_table, hull_table,
    device_out)``; the tables carry the reference's column names, and no
    plume gives empty tables."""
    f_rows, f_cols, f_valid = _prep_fires(lat, lon, date_to_find, fires, cfg)
    thresholds = validate_descending_thresholds(cfg.thresholds)
    device = torch.device(device)
    fn = make_sweep_identifier(_statics(cfg))
    aod_t = torch.from_numpy(np.ascontiguousarray(aod, np.float32)).to(device)
    with torch.inference_mode():
        out = fn(aod_t, aod_t, torch.zeros(aod.shape, dtype=torch.bool,
                                           device=device),
                 torch.from_numpy(thresholds).to(device),
                 torch.from_numpy(f_rows).to(device),
                 torch.from_numpy(f_cols).to(device),
                 torch.from_numpy(f_valid).to(device))
        out = _to_host(out)
    return _scene_results(out, lat, lon)


def _scene_results(out: dict, lat, lon):
    """Build the tables and cache the masks of the plumes that survived
    the dedup under ``out["plume_masks"]``."""
    masks: dict = {}
    aod_table, hull_table = build_scene_dataframes(out, lat, lon,
                                                   masks_out=masks)
    kept = set(aod_table.column("id"))
    out["plume_masks"] = {pid: m for pid, m in masks.items() if pid in kept}
    return aod_table, hull_table, out


def _iter_valid_plumes(out: dict):
    """Yield ``(plume_id, fire_index, mask, hull_rows, hull_cols)`` over
    accepted fires, skipping plumes with no 2-D hull: the one walk that
    assigns plume ids, shared by the tables and :func:`plume_masks`."""
    from scipy.spatial import QhullError

    plume_id = 0
    for f in np.nonzero(out["accepted"])[0]:
        mask = out["mask"][f]
        ys, xs = np.nonzero(mask)
        if ys.size < 3:
            continue
        points = np.column_stack([ys, xs])
        try:
            verts = convex_hull_vertices_host(points)
        except QhullError:
            logger.info("plume at fire %d dropped: degenerate hull "
                        "(%d collinear pixels)", int(f), ys.size)
            continue
        yield plume_id, int(f), mask, points[verts, 0], points[verts, 1]
        plume_id += 1


def plume_masks(out: dict) -> dict:
    """``{plume_id: (H, W) bool mask}`` for every plume in the scene
    tables, keyed as ``hull_table``'s ids."""
    if "plume_masks" in out:
        return out["plume_masks"]
    return {pid: mask for pid, _f, mask, _hy, _hx in _iter_valid_plumes(out)}


def build_scene_dataframes(out: dict, lat: np.ndarray, lon: np.ndarray,
                           dedup: bool = True, masks_out: dict = None):
    """The reference's two outputs as row tables:

    * ``aod_table``: one row per accepted plume: pixel extent, bbox, AOD
      mean/sd, ``bg_aod_level`` = the chosen threshold *index*
      (``plume_identifier_rg.py:425-437``);
    * ``hull_table``: convex-hull vertices in pixel and geographic
      coordinates (``:411-420``).

    ``dedup`` drops a row whose stats equal an earlier row's (two fires
    claiming one plume), keeping the first id, and the dropped ids' hull
    rows with it (``:453-455``; the JAX package's ``drop_duplicates``).
    """
    aod_rows, hull_rows = [], []
    for plume_id, f, mask, hy, hx in _iter_valid_plumes(out):
        if masks_out is not None:
            masks_out[plume_id] = mask
        for y, x in zip(hy.tolist(), hx.tolist()):
            hull_rows.append((float(plume_id), float(lat[y, x]),
                              float(lon[y, x]), int(x), int(y)))
        min_r, min_c, max_r, max_c = (int(v) for v in out["bbox"][f])
        aod_rows.append((plume_id, int(out["area"][f]), min_r, max_r, min_c,
                         max_c, float(out["aod_mean"][f]),
                         float(out["aod_sd"][f]), int(out["t_index"][f])))
    if dedup and aod_rows:
        seen, kept = set(), []
        for row in aod_rows:
            if row[1:] not in seen:
                seen.add(row[1:])
                kept.append(row)
        ids = {row[0] for row in kept}
        hull_rows = [r for r in hull_rows if int(r[0]) in ids]
        aod_rows = kept
    return Table(AOD_COLUMNS, aod_rows), Table(HULL_COLUMNS, hull_rows)
