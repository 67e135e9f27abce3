"""Plume curation of ``plumekit/label/selector.py`` on the port's row
tables: review every plume of a hull table (crop, in-hull AOD, the
auto-reject verdict), split the table by decisions, write a review batch
(PNG crops and a manifest) for humans to fill in, or review plume by plume
at the keyboard.

The pandas steps of the JAX functions are spelled out here: the duplicate
pass (a groupby mean in pandas' compensated sum, rounding to 3 places, the
first of each duplicate kept, the left order kept through the inner
merge) and ``unique()`` in first-appearance order (``io/tables.unique``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from plumekit_torch.io.granule import Granule, resolve_layer
from plumekit_torch.io.tables import Table, is_missing, nan_key, unique
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

#: crop buffer around the hull bbox (``plume_selector.py:56``)
BUFFER_PX = 40
#: AOD histogram bins for the auto-reject rule (``plume_selector.py:133,210``)
HIST_BINS = np.arange(0, 1, 0.02)


def group_mean(values) -> float:
    """The mean of the non-NaN values as pandas' groupby mean takes it:
    a compensated (Kahan) sum over the rows in order, over the count."""
    total = comp = 0.0
    n = 0
    for v in values:
        v = float(v)
        if math.isnan(v):
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        if comp != comp:
            comp = 0.0
        total = t
    return total / n if n else math.nan


def remove_duplicated_plumes(plumes: Table) -> Table:
    """Drop plumes whose (datetime, centroid rounded to 3 places)
    duplicates an earlier plume in (id, datetime) order
    (``plume_selector.py:26-49``); the rows kept stay in their order."""
    ci = plumes.columns.index
    i_id, i_dt = ci("id"), ci("datetime")
    i_lat, i_lon = ci("hull_lats"), ci("hull_lons")
    groups = {}
    for r in plumes.rows:
        if is_missing(r[i_id]) or is_missing(r[i_dt]):
            continue        # pandas' groupby drops NaN keys
        groups.setdefault((r[i_id], r[i_dt]), []).append(r)
    keys = sorted(groups)
    means = np.array([[group_mean(r[i_lat] for r in groups[k]),
                       group_mean(r[i_lon] for r in groups[k])]
                      for k in keys], dtype=np.float64).reshape(-1, 2)
    rounded = np.round(means, 3)
    seen, kept = set(), set()
    for k, (lat, lon) in zip(keys, rounded.tolist()):
        dup = (nan_key(k[1]), nan_key(lat), nan_key(lon))
        if dup not in seen:
            seen.add(dup)
            kept.add(k)
    return plumes.where(lambda r: (r[i_id], r[i_dt]) in kept)


def subset_plume(aod: np.ndarray, plume: Table):
    """Crop the AOD to the hull bbox ± :data:`BUFFER_PX` and shift the hull
    into crop space (``plume_selector.py:53-85``); ``(None, None, None)``
    for a NaN hull."""
    hull_x = np.asarray(plume.column("hull_x"), dtype=np.float64)
    hull_y = np.asarray(plume.column("hull_y"), dtype=np.float64)
    h, w = aod.shape
    x0 = np.maximum(hull_x.min() - BUFFER_PX, 0)
    y0 = np.maximum(hull_y.min() - BUFFER_PX, 0)
    x1 = np.minimum(hull_x.max() + BUFFER_PX, w)
    y1 = np.minimum(hull_y.max() + BUFFER_PX, h)
    if np.isnan([y0, y1, x0, x1]).any():
        return None, None, None
    return (aod[int(y0):int(y1), int(x0):int(x1)], hull_x - x0,
            hull_y - y0)


def find_plume_aod(plume_image: np.ndarray, hull_x, hull_y) -> np.ndarray:
    """AOD of the crop's pixels inside the hull (Delaunay containment over
    the full crop, the JAX package's fix of the reference's square
    sampling)."""
    from scipy.spatial import Delaunay

    h, w = plume_image.shape
    yy, xx = np.mgrid[0:h, 0:w]
    pts = np.column_stack([xx.ravel(), yy.ravel()])
    hull = np.column_stack([hull_x, hull_y])
    try:
        inside = Delaunay(hull).find_simplex(pts) >= 0
    except Exception:
        return np.zeros((0,), np.float32)
    return plume_image[yy.ravel()[inside], xx.ravel()[inside]]


def auto_reject(in_plume_aod: np.ndarray) -> bool:
    """True when the modal 0.02-wide histogram bin is the zero bin
    (``plume_selector.py:210-212``)."""
    if in_plume_aod.size == 0:
        return True
    h, _ = np.histogram(in_plume_aod, bins=HIST_BINS)
    return int(np.argmax(h)) == 0


@dataclass
class PlumeReview:
    plume_id: int
    datetime: object
    crop: Optional[np.ndarray]
    hull_x: Optional[np.ndarray]
    hull_y: Optional[np.ndarray]
    in_plume_aod: Optional[np.ndarray]
    auto_rejected: bool


def review_plumes(plumes: Table, granule: Granule,
                  dedup: bool = True) -> List[PlumeReview]:
    """Every plume prepared for review (``plume_selector.py:189-221``), per
    datetime and id in first-appearance order; ``dedup=False`` skips the
    duplicate pass for a table that has had it."""
    if dedup:
        plumes = remove_duplicated_plumes(plumes)
    i_dt, i_id = plumes.columns.index("datetime"), plumes.columns.index("id")
    out: List[PlumeReview] = []
    for dt in unique(plumes.column("datetime")):
        aod = resolve_layer(granule, dt)
        dt_rows = plumes.where(lambda r: r[i_dt] == dt)
        for pid in unique(dt_rows.column("id")):
            plume = dt_rows.where(lambda r: r[i_id] == pid)
            crop, hx, hy = subset_plume(aod, plume)
            if crop is None:
                out.append(PlumeReview(int(pid), dt, None, None, None, None,
                                       True))
                continue
            vals = find_plume_aod(crop, hx, hy)
            out.append(PlumeReview(int(pid), dt, crop, hx, hy, vals,
                                   auto_reject(vals)))
    return out


def apply_decisions(plumes: Table, granule: Granule,
                    decide: Callable[[PlumeReview], bool],
                    scores: Optional[Table] = None) -> Tuple[Table, Table]:
    """Split the deduplicated table into (kept, rejected) by ``decide``;
    auto-rejected plumes never reach it. ``scores`` orders the calls
    most-suspect-first; the split does not depend on the order."""
    plumes = remove_duplicated_plumes(plumes)
    reviews = order_reviews(review_plumes(plumes, granule, dedup=False),
                            scores)
    kept_keys = {(r.plume_id, r.datetime) for r in reviews
                 if not r.auto_rejected and decide(r)}
    i_id, i_dt = plumes.columns.index("id"), plumes.columns.index("datetime")
    keep = [(int(r[i_id]), r[i_dt]) in kept_keys for r in plumes.rows]
    return (Table(plumes.columns, [r for r, k in zip(plumes.rows, keep) if k]),
            Table(plumes.columns,
                  [r for r, k in zip(plumes.rows, keep) if not k]))


def order_reviews(reviews: List[PlumeReview],
                  scores: Optional[Table]) -> List[PlumeReview]:
    """Reviews in file order without scores, most-suspect-first with them
    (ascending model support, unscored plumes at the head)."""
    if scores is None:
        return reviews
    from plumekit_torch.label.ranking import review_order

    pos = {key: i for i, key in enumerate(review_order(scores))}
    # str() on the lookup side too: a numeric datetime column reads as a
    # number
    return sorted(reviews,
                  key=lambda r: pos.get((r.plume_id, str(r.datetime)),
                                        len(pos)))


MANIFEST_COLUMNS = ("id", "datetime", "png", "auto_rejected", "keep")


def export_review_batch(plumes: Table, granule: Granule, out_dir: str,
                        scores: Optional[Table] = None) -> Table:
    """Write a PNG (crop and histogram) per plume and ``manifest.csv`` with
    a blank ``keep`` column for humans to fill; returns the manifest. With
    ``scores`` (:func:`plumekit_torch.label.ranking.plume_support`) the
    manifest is most-suspect-first and carries ``model_support``. Needs
    matplotlib, imported here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    support = {}
    columns = MANIFEST_COLUMNS
    if scores is not None:
        from plumekit_torch.label.ranking import SUPPORT_COL

        support = {(int(i), str(dt)): s for i, dt, s in zip(
            scores.column("id"), scores.column("datetime"),
            scores.column(SUPPORT_COL))}
        columns = columns + (SUPPORT_COL,)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for r in order_reviews(review_plumes(plumes, granule), scores):
        # a plume without a crop (NaN hull) gets no PNG and an empty cell
        png = (f"{granule.name}_{r.datetime}_{r.plume_id}.png"
               if r.crop is not None else "")
        if r.crop is not None:
            fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 4))
            vmax = float(r.in_plume_aod.max()) if r.in_plume_aod.size else 1.0
            ax0.imshow(r.crop, vmin=0, vmax=max(vmax, 1e-3))
            ax0.plot(r.hull_x, r.hull_y, "r--", lw=2)
            ax1.hist(r.in_plume_aod, bins=HIST_BINS)
            fig.savefig(os.path.join(out_dir, png), bbox_inches="tight")
            plt.close(fig)
        row = (r.plume_id, r.datetime, png, r.auto_rejected, "")
        if scores is not None:
            row += (support.get((r.plume_id, str(r.datetime)), math.nan),)
        rows.append(row)
    # pandas writes a frame of no rows without columns
    manifest = Table(columns if rows else (), rows)
    manifest.to_csv(os.path.join(out_dir, "manifest.csv"))
    return manifest


def interactive_review(plumes: Table, granule: Granule,
                       scores: Optional[Table] = None) -> Tuple[Table, Table]:
    """The reference's blocking review (``plume_selector.py:118-134``): one
    figure per plume (crop with its hull, histogram); key '1' keeps, '0'
    rejects, closing the window without a key rejects. ``scores`` presents
    the plumes most-suspect-first (:func:`apply_decisions`). Needs
    matplotlib with an interactive backend, imported here."""
    import matplotlib.pyplot as plt

    def decide(r: PlumeReview) -> bool:
        decision = {}

        def press(event):
            if event.key in ("0", "1"):
                decision["keep"] = event.key == "1"
                plt.close()

        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(12, 5))
        fig.canvas.mpl_connect("key_press_event", press)
        vmax = float(r.in_plume_aod.max()) if r.in_plume_aod.size else 1.0
        im = ax0.imshow(r.crop, vmin=0, vmax=max(vmax, 1e-3))
        plt.colorbar(ax=ax0, mappable=im)
        ax0.plot(r.hull_x, r.hull_y, "r--", lw=2)
        ax1.hist(r.in_plume_aod, bins=HIST_BINS)
        plt.show()
        return decision.get("keep", False)

    return apply_decisions(plumes, granule, decide, scores=scores)


__all__ = ["BUFFER_PX", "HIST_BINS", "MANIFEST_COLUMNS", "PlumeReview",
           "apply_decisions", "auto_reject", "export_review_batch",
           "find_plume_aod", "group_mean", "interactive_review",
           "order_reviews", "remove_duplicated_plumes", "review_plumes",
           "subset_plume"]
