"""Model evaluation of ``plumekit/train/evaluate.py``: a checkpoint's
sliding-window predictions (inference mode) or saved ``predict_model``
NPZs (predictions mode) scored against model-ready labels, per sample and
pooled: pixel IoU, dice, precision, recall and accuracy from exact int64
confusion counts, plume-level detection counts, threshold sweeps and
scene-level bootstrap intervals.

Tables are :class:`plumekit_torch.io.tables.Table` rows in the JAX
package's columns, written as pandas writes its frames.

The plume-level counts label connected components through K2
(``ops/kernels/ccl_sweep.multi_threshold_ccl``, 8-connected): the CUDA
kernel for masks on the card, its plain version for masks on the CPU.
K2 names a component by its smallest flat index + 1; the labels are
renumbered 1..n in ascending order, which is first-encounter raster
order, the numbering of the JAX package's host CCL, so the greedy match
breaks IoU ties the same way. A threshold sweep labels the (T + 1, H, W)
stack of its T thresholded masks and the true mask in one launch per
sample.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from plumekit_torch.device import resolve_device
from plumekit_torch.io.tables import Table
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)

#: metric column order shared by rows and aggregates
METRIC_KEYS = ("iou", "dice", "precision", "recall", "accuracy")
#: exact-count columns persisted per sample (re-poolable, bootstrappable)
PIXEL_COUNT_COLS = ("tp", "fp", "fn", "tn")
OBJECT_COUNT_COLS = ("obj_tp", "obj_fp", "obj_fn")
#: object-level metric names accepted by the threshold sweep
OBJECT_METRIC_KEYS = ("obj_precision", "obj_recall", "obj_f1")
PIXEL_COLUMNS = ("name", "plume_px") + METRIC_KEYS + PIXEL_COUNT_COLS
OBJECT_COLUMNS = (("name", "pred_plumes", "true_plumes") + OBJECT_METRIC_KEYS
                  + OBJECT_COUNT_COLS)
AGGREGATE_NAMES = ("micro", "macro")

ProbPairs = Iterable[Tuple[str, np.ndarray, np.ndarray]]


def confusion_counts(pred_mask: np.ndarray,
                     true_mask: np.ndarray) -> np.ndarray:
    """Exact pixel confusion tallies ``[tp, fp, fn, tn]`` (int64)."""
    if pred_mask.shape != true_mask.shape:
        raise ValueError(
            f"prediction shape {pred_mask.shape} != label shape "
            f"{true_mask.shape}")
    pred = np.asarray(pred_mask, dtype=bool)
    true = np.asarray(true_mask, dtype=bool)
    tp = np.count_nonzero(pred & true)
    fp = np.count_nonzero(pred & ~true)
    fn = np.count_nonzero(~pred & true)
    tn = pred.size - tp - fp - fn
    return np.array([tp, fp, fn, tn], dtype=np.int64)


def _ratio(num: float, den: float, empty: float = 1.0) -> float:
    """An empty denominator scores ``empty``: no plume predicted and none
    labelled is a perfect agreement."""
    return num / den if den > 0 else empty


def metrics_from_counts(counts: np.ndarray) -> Dict[str, float]:
    """IoU, dice, precision, recall and accuracy from ``[tp, fp, fn, tn]``;
    an empty union is 1.0, an empty positive set under a non-empty
    counterpart 0.0."""
    tp, fp, fn, tn = (float(c) for c in counts)
    return {
        "iou": _ratio(tp, tp + fp + fn),
        "dice": _ratio(2 * tp, 2 * tp + fp + fn),
        "precision": _ratio(tp, tp + fp),
        "recall": _ratio(tp, tp + fn),
        "accuracy": _ratio(tp + tn, tp + fp + fn + tn, empty=0.0),
    }


def load_model_data(model_data_dir: str) -> List[Tuple[str, str]]:
    """(sample name, npz path) of every model-ready sample, sorted; names
    are the ``{granule}__{ts}`` stems ``build_model_data`` writes."""
    if not os.path.isdir(model_data_dir):
        raise FileNotFoundError(
            f"model-data directory {model_data_dir!r} does not exist; run "
            "'plumekit-torch prepare_model_data' (or point --data at it)")
    out = [(fname[:-len(".npz")], os.path.join(model_data_dir, fname))
           for fname in sorted(os.listdir(model_data_dir))
           if fname.endswith(".npz")]
    if not out:
        raise FileNotFoundError(
            f"no model-ready samples in {model_data_dir}")
    return out


def _pixel_row(name: str, plume_px: int, metrics: Dict[str, float],
               counts=None) -> tuple:
    # pandas stores the count columns as float64, because the macro row
    # has none, and writes them so ("12.0")
    tail = ((math.nan,) * len(PIXEL_COUNT_COLS) if counts is None
            else tuple(float(int(c)) for c in counts))
    return (name, plume_px) + tuple(metrics[k] for k in METRIC_KEYS) + tail


def _summarise(rows: List[Tuple[tuple, np.ndarray]]) -> List[tuple]:
    """Micro (pooled-count) and macro (mean-of-samples) aggregate rows."""
    pooled = np.sum([c for _, c in rows], axis=0)
    micro = _pixel_row("micro", int(pooled[0] + pooled[2]),
                       metrics_from_counts(pooled), pooled)
    i_px = PIXEL_COLUMNS.index("plume_px")
    macro = _pixel_row(
        "macro", int(np.mean([r[i_px] for r, _ in rows])),
        {k: float(np.mean([r[PIXEL_COLUMNS.index(k)] for r, _ in rows]))
         for k in METRIC_KEYS})
    return [micro, macro]


def _score_rows(pairs: Iterable[Tuple[str, np.ndarray, np.ndarray]]
                ) -> Table:
    """(name, pred bool, true bool) → per-sample rows, then the micro and
    macro aggregates."""
    rows = []
    for name, pred, true in pairs:
        counts = confusion_counts(pred, true)
        rows.append((_pixel_row(name, int(counts[0] + counts[2]),
                                metrics_from_counts(counts), counts), counts))
    if not rows:
        raise ValueError("nothing to evaluate: no (prediction, label) pairs")
    return Table(PIXEL_COLUMNS, [r for r, _ in rows] + _summarise(rows))


def bootstrap_ci(sample_counts: np.ndarray,
                 metric_fn: Callable[[np.ndarray], Dict[str, float]],
                 n_boot: int = 1000, seed: int = 0, alpha: float = 0.05
                 ) -> Dict[str, Tuple[float, float]]:
    """Scene-level bootstrap interval of the pooled metrics: the
    (samples, k) count rows resampled with replacement ``n_boot`` times
    from ``default_rng(seed)``, each resample pooled through
    ``metric_fn``; percentile interval (95% by default)."""
    counts = np.asarray(sample_counts, dtype=np.int64)
    if counts.ndim != 2 or counts.shape[0] < 1:
        raise ValueError(
            f"sample_counts must be (samples, k), got {counts.shape}")
    if n_boot < 1:
        raise ValueError(f"n_boot must be >= 1, got {n_boot}")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, counts.shape[0], size=(n_boot, counts.shape[0]))
    pooled = counts[idx].sum(axis=1)
    keys = list(metric_fn(pooled[0]).keys())
    vals = np.array([[m[k] for k in keys]
                     for m in (metric_fn(p) for p in pooled)])
    lo = np.percentile(vals, 100 * alpha / 2, axis=0)
    hi = np.percentile(vals, 100 * (1 - alpha / 2), axis=0)
    return {k: (float(a), float(b)) for k, a, b in zip(keys, lo, hi)}


def bootstrap_from_df(table: Table, kind: str = "pixel", n_boot: int = 1000,
                      seed: int = 0) -> Dict[str, Tuple[float, float]]:
    """The interval from an evaluation table's per-sample count columns
    (``kind`` "pixel" or "object")."""
    cols, fn = ((PIXEL_COUNT_COLS, metrics_from_counts) if kind == "pixel"
                else (OBJECT_COUNT_COLS, object_metrics_from_counts))
    missing = [c for c in cols if c not in table.columns]
    if missing:
        raise ValueError(
            f"table lacks count columns {missing}; re-run evaluate_model "
            "(older reports predate the per-sample counts)")
    i_name = table.columns.index("name")
    idx = [table.columns.index(c) for c in cols]
    counts = np.array([[r[i] for i in idx] for r in table.rows
                       if r[i_name] not in AGGREGATE_NAMES])
    return bootstrap_ci(counts, fn, n_boot=n_boot, seed=seed)


def _host(probs) -> np.ndarray:
    if isinstance(probs, torch.Tensor):
        return probs.detach().cpu().numpy()
    return np.asarray(probs)


def inference_prob_pairs(infer: Callable, variables,
                         model_data_dir: str) -> ProbPairs:
    """(name, probability map, true bool mask) of every model-ready sample
    through ``infer(variables, channels) -> (probs, _)``."""
    for name, path in load_model_data(model_data_dir):
        with np.load(path) as data:
            channels = data["channels"]
            true = data["mask"].astype(bool)
        probs = _host(infer(variables, channels)[0])
        yield name, probs, true


def evaluate_model_data(infer: Callable, variables, model_data_dir: str,
                        threshold: float = 0.5) -> Table:
    """Every model-ready sample through ``infer``, scored at
    ``threshold``."""
    return _score_rows(
        (name, probs > threshold, true)
        for name, probs, true in inference_prob_pairs(
            infer, variables, model_data_dir))


def prediction_prob_pairs(predictions_dir: str,
                          model_data_dir: str) -> ProbPairs:
    """(name, probability map, true bool mask) of saved ``predict_model``
    NPZs (uint8 ones decoded to [0, 1]) matched to model-ready labels.

    Predictions are per granule, from its first orbit layer, so a granule
    scores against one sample: its ``layer0`` sample, or its only sample. A
    multi-orbit granule whose samples all carry real timestamps is skipped
    with a warning, and so is a sample without a prediction."""
    from plumekit_torch.io.granule import LAYER0_SENTINEL
    from plumekit_torch.ops.quant import dequantize_probs_uint8

    samples = load_model_data(model_data_dir)
    preds: Dict[str, str] = {
        fname[:-len("_pred.npz")]: os.path.join(predictions_dir, fname)
        for fname in sorted(os.listdir(predictions_dir))
        if fname.endswith("_pred.npz")
    }
    if not preds:
        raise FileNotFoundError(
            f"no *_pred.npz predictions in {predictions_dir}; run "
            "'plumekit-torch predict_model' first")

    # the LAST "__" separates the granule's name from the timestamp
    by_base: Dict[str, List[Tuple[str, str, str]]] = {}
    for name, path in samples:
        base, _, ts = name.rpartition("__")
        if not base:
            base, ts = ts, LAYER0_SENTINEL
        by_base.setdefault(base, []).append((name, ts, path))

    matched = 0
    for base, group in by_base.items():
        if base not in preds:
            for name, _, _ in group:
                logger.warning("no prediction for sample %s — skipped",
                               name)
            continue
        chosen = [g for g in group if g[1] == LAYER0_SENTINEL]
        if not chosen and len(group) == 1:
            chosen = group
        if not chosen:
            logger.warning(
                "%s has %d orbit-layer samples (%s) but predictions "
                "are per granule (first layer) — cannot pick a layer; "
                "skipped. Use inference mode (no --predictions) to "
                "score every layer sample.", base, len(group),
                ", ".join(g[1] for g in group))
            continue
        for name, _, path in chosen[:1]:
            if len(group) > 1:
                logger.warning(
                    "%s: scoring only %s against the granule "
                    "prediction; %d other layer sample(s) skipped",
                    base, name, len(group) - 1)
            matched += 1
            with np.load(preds[base]) as pdata:
                probs = pdata["probs"]
                if probs.dtype == np.uint8:
                    probs = dequantize_probs_uint8(probs)
            with np.load(path) as data:
                true = data["mask"].astype(bool)
            yield name, probs, true
    if not matched:
        raise ValueError(
            f"none of the {len(samples)} samples in {model_data_dir} "
            f"match a prediction in {predictions_dir}")


def evaluate_predictions(predictions_dir: str, model_data_dir: str,
                         threshold: float = 0.5) -> Table:
    """Saved predictions scored at ``threshold`` (matching rules of
    :func:`prediction_prob_pairs`)."""
    return _score_rows(
        (name, probs > threshold, true)
        for name, probs, true in prediction_prob_pairs(
            predictions_dir, model_data_dir))


def default_thresholds() -> np.ndarray:
    """0.05..0.95 in steps of 0.05, float64."""
    return np.round(np.arange(0.05, 0.951, 0.05), 2)


def sweep_thresholds(prob_pairs: ProbPairs,
                     thresholds: Optional[np.ndarray] = None) -> Table:
    """Pooled pixel metrics at every candidate threshold, in one pass:
    each map's per-threshold counts come from one sort and
    ``searchsorted(side="right")``, so a probability equal to a threshold
    never counts as above it."""
    ts = (default_thresholds() if thresholds is None
          else np.asarray(thresholds, np.float64))
    if ts.size == 0:
        raise ValueError("no thresholds to sweep")
    if not (np.diff(ts) > 0).all():
        raise ValueError("thresholds must be strictly increasing")

    def above(values: np.ndarray) -> np.ndarray:
        v = np.sort(values, kind="stable")
        return (v.size - np.searchsorted(v, ts, side="right")).astype(
            np.int64)

    counts = np.zeros((ts.size, 4), dtype=np.int64)
    n = 0
    for _name, probs, true in prob_pairs:
        n += 1
        if probs.shape != true.shape:
            raise ValueError(
                f"prediction shape {probs.shape} != label shape "
                f"{true.shape}")
        p = np.asarray(probs).ravel()
        t = np.asarray(true, dtype=bool).ravel()
        tp = above(p[t])
        fp = above(p[~t])
        npos, nneg = int(t.sum()), int((~t).sum())
        counts[:, 0] += tp
        counts[:, 1] += fp
        counts[:, 2] += npos - tp
        counts[:, 3] += nneg - fp
    if n == 0:
        raise ValueError("nothing to sweep: no (probability, label) pairs")
    return Table(("threshold",) + METRIC_KEYS,
                 [(float(t),) + tuple(metrics_from_counts(c).values())
                  for t, c in zip(ts, counts)])


def label_stack(masks: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Label each level of a (T, H, W) bool stack, 8-connected, in one K2
    call on the stack's device; returns the host's (T, H, W) int32 labels
    numbered 1..n in first-encounter raster order and the (T,) counts n.

    K2's label of a pixel is its component's smallest flat index + 1, so a
    component's root is the pixel whose label is its own index + 1, and a
    running count of roots in raster order renumbers every label."""
    from plumekit_torch.ops.kernels.ccl_sweep import multi_threshold_ccl

    labels = multi_threshold_ccl(masks.contiguous(), connectivity=2)
    flat = labels.reshape(labels.shape[0], -1).long()
    index1 = torch.arange(1, flat.shape[1] + 1, device=flat.device)
    rank = torch.cumsum(flat == index1, dim=1)
    renum = torch.where(flat > 0,
                        torch.gather(rank, 1, (flat - 1).clamp_(min=0)), 0)
    return (renum.to(torch.int32).reshape(labels.shape).cpu().numpy(),
            rank[:, -1].cpu().numpy())


def object_counts_from_labels(pl: np.ndarray, np_: int, tl: np.ndarray,
                              nt: int, match_iou: float = 0.5,
                              min_size: int = 1) -> np.ndarray:
    """``[tp, fp, fn]`` of :func:`object_counts` from the two masks'
    labels 1..n (modified in place): predicted components under
    ``min_size`` pruned, true ones ignored (with the predictions mostly
    on them), then the greedy one-to-one match by IoU, highest first, a
    hit at ``IoU >= match_iou``."""
    np_, nt = int(np_), int(nt)
    if min_size > 1:
        psizes = np.bincount(pl.ravel(), minlength=np_ + 1)
        small_p = psizes < min_size
        small_p[0] = False
        pl[small_p[pl]] = 0
        tsizes = np.bincount(tl.ravel(), minlength=nt + 1)
        small_t = tsizes < min_size
        small_t[0] = False
        if small_t.any():
            ignore = small_t[tl]
            if pl.max() > 0:
                # a correct find of a sub-floor plume is not an FP
                area = np.bincount(pl.ravel(), minlength=int(pl.max()) + 1)
                on_ign = np.bincount(pl[ignore].ravel(),
                                     minlength=int(pl.max()) + 1)
                drop = on_ign * 2 > area
                drop[0] = False
                pl[drop[pl]] = 0
            tl[ignore] = 0
        # surviving labels are not contiguous: count the distinct ones
        np_ = int(np.count_nonzero(np.unique(pl)))
        nt = int(np.count_nonzero(np.unique(tl)))
    if np_ == 0 or nt == 0:
        return np.array([0, np_, nt], dtype=np.int64)
    # intersection area of every (pred, true) label pair in one bincount
    joint = np.bincount(
        (pl.ravel().astype(np.int64) * (tl.max() + 1) + tl.ravel()),
        minlength=(pl.max() + 1) * (tl.max() + 1),
    ).reshape(pl.max() + 1, tl.max() + 1)
    pred_area = joint.sum(axis=1)
    true_area = joint.sum(axis=0)
    inter = joint[1:, 1:].astype(np.float64)
    union = (pred_area[1:, None] + true_area[None, 1:] - inter)
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    tp = 0
    used_p: set = set()
    used_t: set = set()
    order = np.argsort(iou, axis=None)[::-1]
    for flat in order:
        i, j = divmod(int(flat), iou.shape[1])
        if iou[i, j] < match_iou:
            break
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        tp += 1
    n_pred = int((pred_area[1:] > 0).sum())
    n_true = int((true_area[1:] > 0).sum())
    return np.array([tp, n_pred - tp, n_true - tp], dtype=np.int64)


def _check_objects(pred_shape, true_shape, match_iou: float) -> None:
    if pred_shape != true_shape:
        raise ValueError(
            f"prediction shape {pred_shape} != label shape {true_shape}")
    if not 0.0 < match_iou <= 1.0:
        raise ValueError(f"match_iou must be in (0, 1], got {match_iou}")


def object_counts(pred_mask: np.ndarray, true_mask: np.ndarray,
                  match_iou: float = 0.5, min_size: int = 1,
                  device="cuda") -> np.ndarray:
    """Plume-level tallies ``[tp, fp, fn]`` (int64) of two (H, W) masks:
    both labelled in one K2 call on ``device``, then
    :func:`object_counts_from_labels`."""
    _check_objects(pred_mask.shape, true_mask.shape, match_iou)
    stack = np.stack([np.asarray(pred_mask, bool), np.asarray(true_mask,
                                                              bool)])
    labels, n = label_stack(torch.from_numpy(stack).to(
        resolve_device(device)))
    return object_counts_from_labels(labels[0], n[0], labels[1], n[1],
                                     match_iou, min_size)


def object_metrics_from_counts(counts: np.ndarray) -> Dict[str, float]:
    """Plume-level precision, recall and F1 from pooled ``[tp, fp, fn]``."""
    tp, fp, fn = (float(c) for c in counts)
    return {"obj_precision": _ratio(tp, tp + fp),
            "obj_recall": _ratio(tp, tp + fn),
            "obj_f1": _ratio(2 * tp, 2 * tp + fp + fn)}


def _object_row(name: str, c: np.ndarray) -> tuple:
    m = object_metrics_from_counts(c)
    return ((name, int(c[0] + c[1]), int(c[0] + c[2]))
            + tuple(m[k] for k in OBJECT_METRIC_KEYS)
            + tuple(int(v) for v in c))


def evaluate_objects(prob_pairs: ProbPairs, threshold: float = 0.5,
                     match_iou: float = 0.5, min_size: int = 1,
                     device="cuda") -> Table:
    """Per-sample and pooled (micro) plume-level detection table."""
    rows, counts = [], []
    for name, probs, true in prob_pairs:
        c = object_counts(probs > threshold, true, match_iou, min_size,
                          device=device)
        rows.append(_object_row(name, c))
        counts.append(c)
    if not rows:
        raise ValueError("nothing to evaluate: no (prediction, label) pairs")
    return Table(OBJECT_COLUMNS,
                 rows + [_object_row("micro", np.sum(counts, axis=0))])


def objects_csv_path(evaluation_csv: str) -> str:
    """The plume-level report beside the pixel-level one."""
    return os.path.join(os.path.dirname(evaluation_csv) or ".",
                        "evaluation_objects.csv")


def sweep_object_thresholds(prob_pairs: ProbPairs,
                            thresholds: Optional[np.ndarray] = None,
                            match_iou: float = 0.5, min_size: int = 1,
                            device="cuda") -> Table:
    """Pooled plume-level metrics at every candidate threshold. Per sample,
    the masks ``probs > t`` of every threshold (compared in float64, as
    numpy compares a float32 map with a float64 threshold) and the true
    mask are labelled as one stack in one K2 call on ``device``."""
    ts = (default_thresholds() if thresholds is None
          else np.asarray(thresholds, np.float64))
    if ts.size == 0:
        raise ValueError("no thresholds to sweep")
    pairs = list(prob_pairs)
    if not pairs:
        raise ValueError("nothing to sweep: no (probability, label) pairs")
    device = resolve_device(device)
    levels = torch.from_numpy(ts).to(device)[:, None, None]
    pooled = np.zeros((ts.size, 3), dtype=np.int64)
    for _n, probs, true in pairs:
        _check_objects(probs.shape, true.shape, match_iou)
        p = torch.from_numpy(np.asarray(probs)).to(device, torch.float64)
        t = torch.from_numpy(np.asarray(true, bool)).to(device)
        labels, n = label_stack(torch.cat([p[None] > levels, t[None]]))
        for i in range(ts.size):
            pooled[i] += object_counts_from_labels(
                labels[i], n[i], labels[-1].copy(), n[-1], match_iou,
                min_size)
    return Table(("threshold",) + OBJECT_METRIC_KEYS,
                 [(float(t),) + tuple(object_metrics_from_counts(c).values())
                  for t, c in zip(ts, pooled)])


def best_threshold(sweep: Table, metric: str = "iou"
                   ) -> Tuple[float, float]:
    """(threshold, value) maximising ``metric`` over a sweep table; ties go
    to the threshold nearest 0.5."""
    if metric not in sweep.columns:
        raise ValueError(f"metric {metric!r} not in sweep table")
    vals = np.asarray(sweep.column(metric))
    best = vals.max()
    cand = np.asarray(sweep.column("threshold"))[vals == best]
    t = float(cand[np.argmin(np.abs(cand - 0.5))])
    return t, float(best)


def at_threshold(sweep: Table, metric: str, t: float = 0.5) -> float:
    """``metric`` at the swept threshold nearest ``t`` (the first of a
    tie)."""
    ts = np.asarray(sweep.column("threshold"))
    return float(sweep.column(metric)[int(np.argmin(np.abs(ts - t)))])


def write_report(table: Table, out_csv: Optional[str]) -> Dict:
    """Write the per-sample table (if ``out_csv``) and return the micro
    summary the CLI prints."""
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        table.to_csv(out_csv)
        logger.info("wrote %s (%d rows)", out_csv, len(table))
    micro = dict(zip(table.columns, next(
        r for r in table.rows if r[table.columns.index("name")] == "micro")))
    return {"samples": int(len(table) - 2),
            **{k: round(float(micro[k]), 4) for k in METRIC_KEYS}}


__all__ = ["METRIC_KEYS", "OBJECT_COUNT_COLS", "OBJECT_METRIC_KEYS",
           "PIXEL_COUNT_COLS", "at_threshold", "best_threshold",
           "bootstrap_ci", "bootstrap_from_df", "confusion_counts",
           "default_thresholds", "evaluate_model_data", "evaluate_objects",
           "evaluate_predictions", "inference_prob_pairs", "label_stack",
           "load_model_data", "metrics_from_counts", "object_counts",
           "object_counts_from_labels", "object_metrics_from_counts",
           "objects_csv_path", "prediction_prob_pairs", "sweep_thresholds",
           "sweep_object_thresholds", "write_report"]
