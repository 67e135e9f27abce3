"""Fixed-threshold detector (``plumekit/identify/basic.py``; the reference's
``plume_identifier_basic.py``).

Per scene, on one device: the 21×21 background-ratio fire screen
(``:164-205``), the 0.2-threshold mask, its opening and its labels (the K2
entry; ``:228-234``), each fire's nearest label with the duplicate-label
and size gates (``:208-258``), and the bounding boxes (``:263-269``).

The JAX program builds (F, H, W) compares that XLA fuses away; here they
run in chunks over the fires, and only for the fires that need them. All
of them are integer or boolean reductions, so the results do not depend
on the chunking.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from plumekit_torch.config.identify import BasicIdentifyConfig
from plumekit_torch.device import resolve_device
from plumekit_torch.identify.locate import locate_fires_in_image, pad_fires
from plumekit_torch.io.fires import n_fires, subset_fires_to_image
from plumekit_torch.ops.cluster import CHUNK_ELEMENTS, mean_cluster_positions
from plumekit_torch.ops.kernels.ccl_sweep import multi_threshold_ccl
from plumekit_torch.ops.morphology import binary_opening_cross
from plumekit_torch.ops.segment import (gather_windows, label_window_nearest,
                                        masked_bbox, window_starts)
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)


def _make_program(cfg: BasicIdentifyConfig):
    """``program(aod, fire_rows, fire_cols, fire_valid) -> dict`` over
    tensors on one device, with the JAX program's keys, shapes and dtypes:
    ``near``, ``plume`` (F,) bool, ``label``, ``area`` (F,) int32, ``bbox``
    (F, 4) int32 and ``plume_image`` (H, W) int32."""
    w = cfg.win_half
    size = 2 * w + 1
    step = size // 3      # int(21 / 3) = 7 (plume_identifier_basic.py:189)

    def fire_near_plume(aod, rows, cols):
        """Max/min ratio of the nine sub-window means against the limit
        (``:164-205``). A window that would leave the image is shifted
        inside it, as ``lax.dynamic_slice`` does; callers keep fires a
        full window away from the edge."""
        h, wid = aod.shape
        sr, sc = window_starts(rows, cols, h, wid, w)
        win = gather_windows(aod, sr, sc, size)
        sub = win[:, :3 * step, :3 * step].reshape(-1, 3, step, 3, step)
        means = sub.mean((2, 4))
        min_m = means.amin((1, 2))
        max_m = means.amax((1, 2))
        # a zero background divides to inf (kept); a negative one (-999
        # nulls in the window) gives a negative ratio, which fails
        zero = min_m == 0
        ratio = torch.where(zero, torch.inf,
                            max_m / torch.where(zero, 1.0, min_m))
        return ratio > cfg.aod_ratio_limit

    def program(aod, fire_rows, fire_cols, fire_valid):
        h, wid = aod.shape
        f_count = fire_rows.shape[0]
        device = aod.device
        near = fire_near_plume(aod, fire_rows, fire_cols) & fire_valid

        limit = torch.tensor(cfg.aod_min_limit, dtype=aod.dtype,
                             device=device)
        opened = binary_opening_cross(aod >= limit)
        labels = multi_threshold_ccl(opened[None], connectivity=2,
                                     nested=False)[0]

        lab_f, found = label_window_nearest(labels, fire_rows, fire_cols, w)
        # only found labels enter the duplicate count (``:238-242``)
        live = near & found
        lab_eff = torch.where(live, lab_f, -1)
        counts = ((lab_eff[:, None] == lab_eff[None, :])
                  & live[None, :]).sum(1)
        keep = live & (counts < 2)

        chunk = max(1, CHUNK_ELEMENTS // (h * wid))
        area = torch.zeros(f_count, dtype=torch.int32, device=device)
        for part in torch.split(torch.nonzero(live)[:, 0], chunk):
            area[part] = (labels[None] == lab_eff[part, None, None]) \
                .sum((1, 2)).to(torch.int32)
        keep &= (area <= cfg.max_plume_pixels) \
            & (area >= cfg.min_plume_pixels)

        # no two kept fires share a component: the counts gate removed
        # every pair of live fires with one label
        bbox = torch.tensor([h, wid, 0, 0], dtype=torch.int32,
                            device=device).repeat(f_count, 1)
        any_mask = torch.zeros((h, wid), dtype=torch.bool, device=device)
        for part in torch.split(torch.nonzero(keep)[:, 0], chunk):
            masks = labels[None] == lab_f[part, None, None]
            bbox[part] = torch.stack(masked_bbox(masks), -1)
            any_mask |= masks.any(0)
        plume_image = torch.where(any_mask, labels, 0)
        return dict(near=near, plume=keep, label=lab_f, area=area,
                    bbox=bbox, plume_image=plume_image)

    return program


def _prep_fires(lat, lon, date_to_find, fires, cfg):
    """Subset to the scene and date (FRP gate), cluster, locate, pad to a
    power-of-two capacity."""
    subset = subset_fires_to_image(lat, lon, fires, date_to_find,
                                   min_frp=cfg.min_frp)
    if n_fires(subset):
        c_lat, c_lon = mean_cluster_positions(subset, cfg.cluster_dist_km)
        # basic has no explicit edge filter; its full-window test drops the
        # same fires (plume_identifier_basic.py:184)
        rows, cols = locate_fires_in_image(c_lat, c_lon, lat, lon,
                                           cfg.win_half)
    else:
        rows = cols = np.zeros((0,), np.int32)
    if len(rows) > cfg.max_fires:
        logger.warning("fire clusters (%d) exceed capacity (%d); truncating",
                       len(rows), cfg.max_fires)
    return pad_fires(rows, cols, cfg.max_fires, bucket=True)


def _to_host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def identify(aod: np.ndarray, lat: np.ndarray, lon: np.ndarray, date_to_find,
             fires, cfg: BasicIdentifyConfig = BasicIdentifyConfig(),
             device="cuda") -> Tuple[Dict[int, dict], np.ndarray]:
    """``(plume_roi_dict, plume_image)`` as the reference's ``identify``
    (``plume_identifier_basic.py:272-318``): ``{plume_id: {min_r, min_c,
    max_r, max_c}}`` and the labelled image of the surviving plumes. The
    caller zeroes negative AOD if it wants to (the api does)."""
    device = resolve_device(device)
    f_rows, f_cols, f_valid = _prep_fires(lat, lon, date_to_find, fires, cfg)
    program = _make_program(cfg)
    with torch.inference_mode():
        out = program(
            torch.from_numpy(np.ascontiguousarray(aod, np.float32))
            .to(device),
            torch.from_numpy(f_rows).to(device),
            torch.from_numpy(f_cols).to(device),
            torch.from_numpy(f_valid).to(device))
        out = _to_host(out)
    plume_dict: Dict[int, dict] = {}
    for pid, f in enumerate(np.nonzero(out["plume"])[0], start=1):
        min_r, min_c, max_r, max_c = (int(v) for v in out["bbox"][f])
        plume_dict[pid] = {"min_r": min_r, "min_c": min_c, "max_r": max_r,
                           "max_c": max_c}
    return plume_dict, out["plume_image"]
