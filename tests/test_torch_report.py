"""``plumekit_torch/viz/report.py`` and the ``report`` command against
``plumekit/viz/report.py`` on the workspaces of ``tests/test_report.py``
(empty, full, partial, evaluation CI, objects and calibration):
``report.md`` equal line for line, the training figure equal pixel for
pixel; a root that the port trained (its step files) and one that the JAX
trainer wrote (orbax step directories) both name their latest step; without
matplotlib only the figure's line is missing. The port reads the CSVs with
its row tables, not pandas."""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from plumekit.viz.report import build_report as jax_build_report
from plumekit_torch import cli
from plumekit_torch.viz.report import build_report

from test_report import _make_workspace

FIGURE_LINE = "* ![training curves](figures/training.png)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(root, tmp_path):
    """(port lines, JAX lines) of one root, each report in a directory of
    its own."""
    port = build_report(root, out_dir=str(tmp_path / "port_report"))
    ref = jax_build_report(root, out_dir=str(tmp_path / "jax_report"))
    with open(port) as f, open(ref) as g:
        return f.read().split("\n"), g.read().split("\n")


def _ci_table(root):
    rows = []
    for i, (tp, fp, fn) in enumerate([(80, 10, 10), (40, 30, 30),
                                      (60, 20, 20)]):
        rows.append({"name": f"g{i}", "plume_px": tp + fn,
                     "iou": tp / (tp + fp + fn), "dice": 0.9,
                     "precision": 0.9, "recall": 0.9, "accuracy": 0.99,
                     "tp": tp, "fp": fp, "fn": fn, "tn": 900})
    rows += [{**rows[0], "name": "micro"}, {**rows[0], "name": "macro"}]
    pd.DataFrame(rows).to_csv(
        os.path.join(root, "processed", "evaluation.csv"), index=False)


def _objects_and_threshold(root):
    proc = os.path.join(root, "processed")
    os.makedirs(proc, exist_ok=True)
    pd.DataFrame([{"name": "g", "pred_plumes": 3, "true_plumes": 4,
                   "obj_precision": 1.0, "obj_recall": 0.75, "obj_f1": 0.857},
                  {"name": "micro", "pred_plumes": 3, "true_plumes": 4,
                   "obj_precision": 1.0, "obj_recall": 0.75,
                   "obj_f1": 0.857}]).to_csv(
        os.path.join(proc, "evaluation_objects.csv"), index=False)
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    with open(os.path.join(root, "models", "threshold.json"), "w") as f:
        json.dump({"threshold": 0.7, "metric": "iou", "value": 0.77,
                   "measured_utc": "2026-08-20T00:00:00Z"}, f)


def _partial(root):
    from plumekit.config import PathsConfig

    gd = PathsConfig(root=root).ensure("maiac_dir")
    np.savez_compressed(os.path.join(gd, "g.npz"),
                        layer_layer0=np.zeros((4, 4), np.float32),
                        lat=np.zeros((4, 4)), lon=np.zeros((4, 4)))


WORKSPACES = {
    "empty": lambda root: None,
    "full": _make_workspace,
    "partial": _partial,
    "evaluation_ci": lambda root: (_make_workspace(root), _ci_table(root)),
    "objects_and_calibration": _objects_and_threshold,
    "everything": lambda root: (_make_workspace(root), _ci_table(root),
                                _objects_and_threshold(root)),
}


@pytest.mark.parametrize("workspace", sorted(WORKSPACES))
def test_report_equals_the_jax_report_line_for_line(tmp_path, workspace):
    root = str(tmp_path / "root")
    os.makedirs(root)
    WORKSPACES[workspace](root)
    got, want = _both(root, tmp_path)
    assert got == want
    if workspace == "empty":
        assert any("empty workspace" in line for line in got)
    if workspace in ("full", "everything"):
        assert FIGURE_LINE in got
        import matplotlib.image as mpimg

        np.testing.assert_array_equal(
            mpimg.imread(str(tmp_path / "port_report/figures/training.png")),
            mpimg.imread(str(tmp_path / "jax_report/figures/training.png")))
    if workspace == "evaluation_ci":
        assert "| metric | value | 95% CI |" in got


def test_report_sections_of_a_port_trained_root(tmp_path):
    """The port's step files name the latest step, as the JAX trainer's
    orbax directories do; hull tables with NaN ids count no plume for them,
    as pandas' groupby drops them."""
    root = str(tmp_path / "root")
    _make_workspace(root)
    ckpt = os.path.join(root, "models", "checkpoints")
    os.rmdir(os.path.join(ckpt, "step_00000020"))
    jax_root = str(tmp_path / "jax_root")
    _make_workspace(jax_root)
    for step in (10, 30):
        with open(os.path.join(ckpt, f"step_{step:08d}.pt"), "wb"):
            pass
    os.makedirs(os.path.join(jax_root, "models", "checkpoints",
                             "step_00000030"))
    os.makedirs(os.path.join(jax_root, "models", "checkpoints",
                             "step_00000040.tmp"))
    hulls = os.path.join("raw", "plume_identification", "dataframes", "full",
                         "hull", "granB_extent.csv")
    for r in (root, jax_root):
        pd.DataFrame({"id": [1.0, np.nan, 3.0], "datetime": ["a", "a", None],
                      "hull_x": [1.0] * 3, "hull_y": [1.0] * 3}).to_csv(
            os.path.join(r, hulls), index=False)
    port_md = open(build_report(root)).read()
    jax_md = open(jax_build_report(jax_root)).read()
    assert port_md == jax_md
    assert "step **30**" in port_md and "3 plumes (6 hull rows)" in port_md


def test_report_without_matplotlib_leaves_out_the_figure_line(tmp_path,
                                                              monkeypatch,
                                                              caplog):
    import logging

    root = str(tmp_path / "root")
    _make_workspace(root)
    _, want = _both(root, tmp_path)
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.INFO, logger="plumekit_torch.viz.report"):
        out = build_report(root, out_dir=str(tmp_path / "bare"))
    with open(out) as f:
        got = f.read().split("\n")
    assert got == [line for line in want if line != FIGURE_LINE]
    assert FIGURE_LINE in want
    assert not os.path.exists(tmp_path / "bare" / "figures" / "training.png")
    assert "matplotlib is not installed" in caplog.text


def test_report_command_prints_the_path(tmp_path, capsys):
    root = str(tmp_path / "root")
    _make_workspace(root)
    assert cli.main(["report", "--root", root]) == 0
    printed = capsys.readouterr().out.strip()
    assert printed == os.path.join(root, "reports", "report.md")
    assert os.path.exists(printed)
    out = str(tmp_path / "elsewhere")
    assert cli.main(["report", "--root", root, "--out", out]) == 0
    assert capsys.readouterr().out.strip() == os.path.join(out, "report.md")
