"""Campaign report (``plumekit/viz/report.py``): ``report`` walks a
workspace root and writes ``reports/report.md`` (and
``reports/figures/``) over whatever stages have run: raw data, identify,
curation, model-ready samples, training (with a loss and IoU figure),
predictions, evaluation (with the bootstrap interval where the table has
the counts), plume-level detection and the serving threshold. Every
section is optional.

The CSVs are read with the port's row tables, not pandas. The training
figure needs matplotlib; where it is absent the figure's line is left out
and the rest of the report is the same.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import List, Optional

import numpy as np

from plumekit_torch.config import PathsConfig
from plumekit_torch.io.tables import Table, is_missing
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)
_ORBAX_STEP = re.compile(r"step_(\d+)$")


def _count_files(d: str, suffixes) -> List[str]:
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.endswith(tuple(suffixes)))


def _distinct(values) -> int:
    """Distinct values, missing ones left out (``Series.nunique``)."""
    return len({v for v in values if not is_missing(v)})


def _hull_stats(hull_dir: str):
    """(files, plume rows, distinct plumes) over ``*_extent.csv``: plumes
    by (datetime, id) where the table has both, else by id or by the basic
    detector's ``plume_id``; missing keys count no plume, as pandas'
    groupby drops them."""
    files = _count_files(hull_dir, ["_extent.csv"])
    rows = plumes = 0
    for f in files:
        try:
            t = Table.read_csv(os.path.join(hull_dir, f))
        except Exception as e:  # noqa: BLE001
            logger.warning("unreadable hull CSV %s: %s", f, e)
            continue
        rows += len(t)
        if "id" in t.columns and "datetime" in t.columns:
            plumes += len({k for k in zip(t.column("datetime"), t.column("id"))
                           if not any(map(is_missing, k))})
        elif "id" in t.columns:
            plumes += _distinct(t.column("id"))
        elif "plume_id" in t.columns:
            plumes += _distinct(t.column("plume_id"))
    return len(files), rows, plumes


def _latest_step(ckpt_dir: str) -> Optional[int]:
    """The port's newest step checkpoint, else the newest orbax ``step_*``
    directory of the JAX trainer (``.tmp`` ones ignored)."""
    from plumekit_torch.train.checkpoint import latest_step

    last = latest_step(ckpt_dir)
    if last is not None or not os.path.isdir(ckpt_dir):
        return last
    steps = [int(m.group(1)) for m in map(_ORBAX_STEP.match,
                                          os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def _cell(table: Table, row: tuple, name: str, default=math.nan):
    return row[table.columns.index(name)] if name in table.columns \
        else default


def _micro(table: Table) -> Optional[tuple]:
    if "name" not in table.columns:
        return None
    i = table.columns.index("name")
    return next((r for r in table.rows if r[i] == "micro"), None)


def build_report(root: str, out_dir: Optional[str] = None) -> str:
    """Write ``<out_dir or root/reports>/report.md`` (and its figures) and
    return its path."""
    from plumekit_torch.io.granule import GRANULE_EXTENSIONS

    paths = PathsConfig(root=root)
    out_dir = out_dir or os.path.join(root, "reports")
    fig_dir = os.path.join(out_dir, "figures")
    os.makedirs(fig_dir, exist_ok=True)
    lines: List[str] = ["# plumekit campaign report", ""]

    # --- raw data --------------------------------------------------------
    granules = _count_files(paths.resolve("maiac_dir"), GRANULE_EXTENSIONS)
    fire_csvs = _count_files(paths.resolve("fires_dir"), [".csv"])
    lines += ["## Data", ""]
    lines.append(f"* granules: **{len(granules)}** in `{paths.maiac_dir}`")
    for f in fire_csvs:
        try:
            count = "{} detections".format(len(Table.read_csv(
                os.path.join(paths.resolve("fires_dir"), f))))
        except Exception:  # noqa: BLE001
            count = "unreadable"
        lines.append(f"* fire table `{f}`: {count}")
    viirs_aod = _count_files(paths.resolve("viirs_aod_dir"), [".h5"])
    if viirs_aod:
        lines.append(f"* VIIRS IVAOT granules: {len(viirs_aod)}")
    lines.append("")

    # --- identify (build_features) ---------------------------------------
    nf, nrows, nplumes = _hull_stats(paths.resolve("hull_df_dir"))
    if nf:
        lines += ["## Identify (weak labeller)", "",
                  f"* hull CSVs: **{nf}** granules, {nplumes} plumes "
                  f"({nrows} hull rows)"]
        masks = _count_files(paths.resolve("plume_mask_dir"), ["_masks.npz"])
        if masks:
            lines.append(f"* per-plume device masks: {len(masks)} granules")
        lines.append("")

    # --- curation --------------------------------------------------------
    kept_dir = paths.resolve("reduced_plume_hull_dir")
    rej_dir = paths.resolve("reduced_not_plume_hull_dir")
    kf, _, kp = _hull_stats(kept_dir)
    rf, _, rp = _hull_stats(rej_dir)
    if kf or rf:
        total = kp + rp
        pct = 100.0 * kp / total if total else 0.0
        # the union of names: a granule may have kept or rejected plumes
        # only
        n_gran = len(set(_count_files(kept_dir, ["_extent.csv"]))
                     | set(_count_files(rej_dir, ["_extent.csv"])))
        lines += ["## Curation", "",
                  f"* kept **{kp}** / rejected {rp} plumes "
                  f"({pct:.0f}% acceptance) across {n_gran} granules", ""]

    # --- model data ------------------------------------------------------
    md = _count_files(paths.resolve("model_data_dir"), [".npz"])
    if md:
        frac = []
        for f in md:
            with np.load(os.path.join(paths.resolve("model_data_dir"),
                                      f)) as z:
                frac.append(float(z["mask"].mean()))
        lines += ["## Model-ready data", "",
                  f"* samples: **{len(md)}**, mean plume coverage "
                  f"{100 * float(np.mean(frac)):.2f}% of pixels", ""]

    # --- training --------------------------------------------------------
    ckpt_dir = os.path.join(root, paths.model_dir, "checkpoints")
    last = _latest_step(ckpt_dir)
    metrics_csv = ckpt_dir.rstrip("/") + "_metrics.csv"
    if last is not None or os.path.exists(metrics_csv):
        lines += ["## Training", ""]
        if last is not None:
            lines.append(f"* latest checkpoint: step **{last}** "
                         f"(`{os.path.relpath(ckpt_dir, root)}`)")
        if os.path.exists(metrics_csv):
            m = Table.read_csv(metrics_csv)
            if len(m):
                tail = m.rows[-1]
                lines.append(
                    f"* {len(m)} logged steps; last: loss "
                    f"{_cell(m, tail, 'loss'):.4f}, IoU "
                    f"{_cell(m, tail, 'iou'):.3f}")
                if _plot_metrics(m, os.path.join(fig_dir, "training.png")):
                    lines.append("* ![training curves](figures/training.png)")
        lines.append("")

    # --- predictions -----------------------------------------------------
    pred_dir = paths.resolve("predictions_dir")
    preds = _count_files(pred_dir, ["_pred.npz"])
    if preds:
        cov = []
        for f in preds:
            with np.load(os.path.join(pred_dir, f)) as z:
                cov.append(float((z["probs"] > 0.5).mean()))
        lines += ["## Predictions", "",
                  f"* granule predictions: **{len(preds)}**, mean plume "
                  f"coverage {100 * float(np.mean(cov)):.2f}%", ""]

    # --- evaluation ------------------------------------------------------
    from plumekit_torch.train.evaluate import (bootstrap_from_df,
                                               objects_csv_path)

    eval_csv = paths.resolve("evaluation_csv")
    if os.path.exists(eval_csv):
        ev = Table.read_csv(eval_csv)
        r = _micro(ev)
        if r is not None:
            # the scene-level interval where the table has the per-sample
            # count columns (older tables have none)
            ci = {}
            try:
                ci = bootstrap_from_df(ev, n_boot=1000)
            except (ValueError, KeyError):
                pass
            lines += ["## Evaluation", "",
                      "| metric | value |" + (" 95% CI |" if ci else ""),
                      "|---|---|" + ("---|" if ci else "")]
            for k in ("iou", "dice", "precision", "recall", "accuracy"):
                if k in ev.columns:
                    row = f"| {k} | {float(_cell(ev, r, k)):.4f} |"
                    if ci:
                        lo, hi = ci.get(k, (math.nan,) * 2)
                        row += f" [{lo:.4f}, {hi:.4f}] |"
                    lines.append(row)
            lines += ["",
                      f"(pooled over {len(ev) - 2} samples; per-sample "
                      f"rows in `{paths.evaluation_csv}`"
                      + ("; CI = scene-level bootstrap, 1000 resamples"
                         if ci else "") + ")", ""]

    obj_csv = objects_csv_path(eval_csv)
    if os.path.exists(obj_csv):
        ob = Table.read_csv(obj_csv)
        r = _micro(ob)
        if r is not None:
            lines += ["## Plume-level detection", "",
                      f"- plumes found: **{int(_cell(ob, r, 'pred_plumes'))}**"
                      f" predicted vs {int(_cell(ob, r, 'true_plumes'))} "
                      "labelled",
                      f"- precision {float(_cell(ob, r, 'obj_precision')):.3f}"
                      f" / recall {float(_cell(ob, r, 'obj_recall')):.3f} / "
                      f"F1 **{float(_cell(ob, r, 'obj_f1')):.3f}** "
                      f"(`evaluate_model --objects`)", ""]

    tpath = os.path.join(root, paths.model_dir, "threshold.json")
    if os.path.exists(tpath):
        try:
            with open(tpath) as f:
                tp = json.load(f)
            # valid JSON need not be an object
            if isinstance(tp, dict):
                lines += ["## Serving calibration", "",
                          f"- decision threshold **{tp.get('threshold')}** "
                          f"(dev {tp.get('metric')}={tp.get('value')}, "
                          f"measured {tp.get('measured_utc', '?')}) — "
                          "served automatically by predict/serve/export",
                          ""]
        except (ValueError, OSError):
            pass

    if len(lines) <= 6:
        lines += ["*(empty workspace: run `plumekit make_dataset` / "
                  "`build_features` / `train_model` first)*", ""]
    out = os.path.join(out_dir, "report.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    logger.info("wrote %s", out)
    return out


def _plot_metrics(m: Table, out_path: str) -> bool:
    """Loss and IoU curves of the metrics CSV; False when the CSV lacks
    ``step`` or ``loss``, or where matplotlib is absent (logged)."""
    if "step" not in m.columns or "loss" not in m.columns:
        return False
    from plumekit_torch.viz.plots import _plt, matplotlib_present

    if not matplotlib_present():
        logger.info("report: matplotlib is not installed — the training "
                    "figure is left out")
        return False
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(7, 3.2))
    ax1.plot(m.column("step"), m.column("loss"), color="#4477aa",
             label="loss")
    ax1.set_xlabel("step")
    ax1.set_ylabel("loss", color="#4477aa")
    if "iou" in m.columns:
        ax2 = ax1.twinx()
        ax2.plot(m.column("step"), m.column("iou"), color="#cc6677",
                 label="IoU")
        ax2.set_ylabel("train IoU", color="#cc6677")
        ax2.set_ylim(0, 1)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return True
