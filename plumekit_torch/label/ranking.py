"""Model-guided curation order of ``plumekit/label/ranking.py``: each
plume's mean predicted probability ("model support") over its device mask
or its rasterised hull, and the review queue in ascending support, the
likeliest false plumes first (``select --rank-with-predictions``)."""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import numpy as np

from plumekit_torch.io.tables import Table, is_missing
from plumekit_torch.ops.quant import dequantize_probs_uint8
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

#: manifest and score column name
SUPPORT_COL = "model_support"
SCORE_COLUMNS = ("id", "datetime", SUPPORT_COL, "n_pixels")


def plume_support(probs: np.ndarray, plumes: Table,
                  masks: Optional[Mapping[str, np.ndarray]] = None) -> Table:
    """One row per (datetime, id) of ``plumes``, in sorted order: ``id``,
    ``datetime`` (as str), the mean of ``probs`` over the plume's pixels
    (its device mask in ``masks``, keys ``str(id)``, when present and of
    the prediction's shape, else its rasterised hull) and ``n_pixels``.
    A plume with no pixels gets support NaN."""
    from plumekit_torch.train.curated import rasterize_hulls

    i_dt, i_id = plumes.columns.index("datetime"), plumes.columns.index("id")
    groups = {}
    for r in plumes.rows:
        if is_missing(r[i_dt]) or is_missing(r[i_id]):
            continue        # pandas' groupby drops NaN keys
        groups.setdefault((r[i_dt], r[i_id]), []).append(r)
    rows = []
    for dt, pid in sorted(groups):
        mask = None
        if masks is not None:
            m = masks.get(str(int(pid)))
            if m is not None and m.shape == probs.shape:
                mask = np.asarray(m, dtype=bool)
            elif m is not None:
                logger.warning(
                    "plume %s: device mask shape %s != prediction %s "
                    "(stale artifact?) — scoring the hull instead",
                    pid, m.shape, probs.shape)
        if mask is None:
            mask = rasterize_hulls(Table(plumes.columns, groups[(dt, pid)]),
                                   probs.shape)
        n = int(mask.sum())
        support = float(probs[mask].mean()) if n else math.nan
        rows.append((int(pid), str(dt), support, n))
    return Table(SCORE_COLUMNS, rows)


def load_prediction(predictions_dir: str, base: str) -> Optional[np.ndarray]:
    """The saved probability map ``<base>_pred.npz`` (uint8 predictions
    decoded to [0, 1]) as float32, or None."""
    path = os.path.join(predictions_dir, base + "_pred.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        probs = data["probs"]
        if probs.dtype == np.uint8:
            probs = dequantize_probs_uint8(probs)
        return np.asarray(probs, dtype=np.float32)


def load_plume_masks(mask_dir: str, base: str) -> Optional[dict]:
    """``build_features``' per-plume masks of ``base`` (keys ``str(id)``),
    or None."""
    path = os.path.join(mask_dir, base + "_masks.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: data[k].copy() for k in data.files}


def review_order(scores: Table) -> list:
    """(id, datetime) keys, most-suspect first: ascending support with NaN
    (never scored) at the very front, ties by datetime then id."""
    keyed = [(-math.inf if is_missing(s) else s, dt, i)
             for i, dt, s in zip(scores.column("id"),
                                 scores.column("datetime"),
                                 scores.column(SUPPORT_COL))]
    return [(int(i), str(dt)) for _, dt, i in sorted(keyed)]


__all__ = ["SCORE_COLUMNS", "SUPPORT_COL", "load_plume_masks",
           "load_prediction", "plume_support", "review_order"]
