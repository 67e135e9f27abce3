"""``plumekit_torch/viz/plots.py`` and ``--plot`` against ``plumekit/viz``
and the JAX CLI: every plot function's PNG, read back with
``matplotlib.image.imread``, equals the JAX one pixel for pixel;
``build_features --plot`` (rg, basic, gaussian) writes the JAX CLI's
``<plot_dir>/<base>_plot.png`` for each granule with plumes, equal to the
JAX plot of the same tables; ``predict_model --plot`` and ``serve --once
--plot`` write the same ``<name>_pred.png`` files as the JAX CLI; without
matplotlib (in a subprocess) each exits 1 before any work; and
``label/selector.interactive_review`` driven headless, as
``tests/test_label_cli.py:78-112`` drives the JAX one."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from plumekit import viz as jax_viz  # noqa: E402
from plumekit.cli import main as jax_main  # noqa: E402
from plumekit.io.granule import load_granule as jax_load_granule  # noqa
from plumekit_torch import cli, viz  # noqa: E402
from plumekit_torch.io.tables import Table  # noqa: E402

from test_torch_cli import SERVE, _identify_root, _root  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLOT_DIR = os.path.join("raw", "plume_identification", "plots")
PRED_DIR = os.path.join("processed", "predictions")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(df, tmp_path, name):
    """The frame as the port reads it: through its CSV."""
    path = str(tmp_path / f"{name}.csv")
    df.to_csv(path, index=False)
    return Table.read_csv(path)


def _same_png(got_path, want_path):
    got, want = mpimg.imread(got_path), mpimg.imread(want_path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _square_hull(cy, cx, r, pid, dt="t0"):
    ys = [cy - r, cy - r, cy + r, cy + r]
    xs = [cx - r, cx + r, cx + r, cx - r]
    return pd.DataFrame({"id": float(pid), "hull_lats": [float(cy)] * 4,
                         "hull_lons": [float(cx)] * 4, "hull_x": xs,
                         "hull_y": ys, "datetime": dt})


def test_every_plot_function_draws_the_jax_png(tmp_path):
    rng = np.random.default_rng(0)
    aod = rng.random((48, 64)).astype(np.float32)
    probs = rng.random((48, 64)).astype(np.float32)
    boxes = pd.DataFrame({"id": [0, 1], "plume_min_row": [3, 20],
                          "plume_max_row": [15, 40], "plume_min_col": [5, 30],
                          "plume_max_col": [25, 60]})
    hulls = pd.concat([_square_hull(20, 20, 6, 0), _square_hull(30, 45, 4, 1),
                       _square_hull(10, 50, 3, 1, dt="t1")],
                      ignore_index=True)
    history = {"loss": [0.9, 0.6, 0.5], "iou": [0.1, 0.3, 0.4],
               "eval_iou": [0.2, 0.35]}
    cases = [
        ("bboxes", jax_viz.plot_identify_bboxes, viz.plot_identify_bboxes,
         (aod, boxes), (aod, _table(boxes, tmp_path, "boxes")), {}),
        ("hulls", jax_viz.plot_identify_hulls, viz.plot_identify_hulls,
         (aod, hulls), (aod, _table(hulls, tmp_path, "hulls")),
         {"vmax": 0.8}),
        ("prediction", jax_viz.plot_prediction, viz.plot_prediction,
         (aod, probs), (aod, probs), {"threshold": 0.3}),
        ("history", jax_viz.plot_training_history, viz.plot_training_history,
         (history,), (history,), {}),
    ]
    for name, jax_fn, fn, jax_args, args, kw in cases:
        want, got = str(tmp_path / f"{name}_jax.png"), \
            str(tmp_path / f"{name}_port.png")
        jax_fn(*jax_args, want, **kw)
        fn(*args, got, **kw)
        _same_png(got, want)
    assert not plt.get_fignums()


@pytest.mark.parametrize("detector,root_kw", [
    ("rg", {}),
    ("basic", dict(seeds=(61, 62), background_level=0.05,
                   background_noise=0.02, plume_amplitude=(0.5, 0.8),
                   plume_sigma_minor=(2.0, 3.0))),
    ("gaussian", dict(seeds=(31,), n_layers=2, fires_per_plume=(7, 9),
                      extra_fires=6, null_blobs=2))])
def test_build_features_plot_writes_the_jax_cli_files(tmp_path, detector,
                                                      root_kw):
    """The port's ``--plot`` files are the JAX CLI's: one per granule with
    plumes, named ``<base>_plot.png`` under the plot dir, each equal to the
    JAX plot of the tables the run wrote (the JAX CLI's own tables equal
    them: ``tests/test_torch_cli.py``)."""
    root = _identify_root(tmp_path, **root_kw)
    assert cli.main(["build_features", "--root", root, "--detector",
                     detector, "--device", "cpu", "--plot"]) == 0
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    frames = os.path.join(root, "raw", "plume_identification", "dataframes",
                          "full")
    want_files = []
    for fname in sorted(os.listdir(maiac)):
        base = os.path.splitext(fname)[0]
        table = os.path.join(frames, "aod" if detector == "rg" else "hull",
                             base + ("_aod.csv" if detector == "rg"
                                     else "_extent.csv"))
        df = pd.read_csv(table, dtype={"datetime": str})
        if not len(df):
            continue
        want_files.append(base + "_plot.png")
        granule = jax_load_granule(os.path.join(maiac, fname))
        want = str(tmp_path / f"{base}_jax.png")
        if detector == "gaussian":
            jax_viz.plot_identify_hulls(granule.first_layer(), df, want)
        else:
            aod = granule.first_layer().copy()
            if detector == "basic":
                aod[aod < 0] = 0.0
            jax_viz.plot_identify_bboxes(aod, df, want)
        _same_png(os.path.join(root, PLOT_DIR, base + "_plot.png"), want)
    assert want_files, "no granule with plumes"
    assert sorted(os.listdir(os.path.join(root, PLOT_DIR))) == want_files


def test_predict_model_and_serve_plot_write_the_jax_cli_files(tmp_path):
    """Both CLIs with ``--plot`` on copies of one root: the same
    ``<name>_pred.png`` files beside the predictions (the untrained
    weights differ, so the probability panels do; the AOD panel is drawn
    from the same granule)."""
    import shutil

    root, _ckpt = _root(tmp_path)
    jax_root = str(tmp_path / "jax_root")
    shutil.copytree(root, jax_root)
    assert jax_main(["predict_model", "--root", jax_root, "--plot"]
                    + SERVE) == 0
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--plot"] + SERVE) == 0
    pngs = sorted(f for f in os.listdir(os.path.join(root, PRED_DIR))
                  if f.endswith(".png"))
    assert pngs == ["g0_pred.png", "g1_pred.png"] == sorted(
        f for f in os.listdir(os.path.join(jax_root, PRED_DIR))
        if f.endswith(".png"))
    for f in pngs:
        assert mpimg.imread(os.path.join(root, PRED_DIR, f)).shape == \
            mpimg.imread(os.path.join(jax_root, PRED_DIR, f)).shape
    served = str(tmp_path / "served")
    shutil.copytree(root, served, ignore=lambda d, files: [
        f for f in files if f == "processed"])
    assert cli.main(["serve", "--root", served, "--device", "cpu", "--once",
                     "--settle", "0", "--plot"] + SERVE) == 0
    out = sorted(os.listdir(os.path.join(served, PRED_DIR)))
    assert [f for f in out if f.endswith(".png")] == pngs
    for f in pngs:
        _same_png(os.path.join(served, PRED_DIR, f),
                  os.path.join(root, PRED_DIR, f))


NO_MATPLOTLIB = """
import os, sys
sys.modules["matplotlib"] = None
from plumekit_torch import cli
root = sys.argv[1]
rcs = [cli.main(argv) for argv in (
    ["build_features", "--root", root, "--device", "cpu", "--plot"],
    ["predict_model", "--root", root, "--device", "cpu", "--plot"],
    ["serve", "--root", root, "--device", "cpu", "--once", "--settle", "0",
     "--plot"],
    ["build_features", "--root", root, "--device", "cpu"])]
print("RCS", rcs, sorted(os.listdir(root)), sorted(os.listdir(os.path.join(
    root, "raw", "plume_identification"))))
"""


def test_plot_without_matplotlib_exits_1_before_any_work(tmp_path):
    root = _identify_root(tmp_path, seeds=(22,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", NO_MATPLOTLIB, root],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RCS"))
    # the three --plot calls refuse; the plain build_features then works
    assert line.startswith("RCS [1, 1, 1, 0]"), line
    # nothing was written by the refusals: no predictions, no plot dir
    assert "'processed'" not in line and "'plots'" not in line, line
    assert proc.stderr.count("needs matplotlib") == 3, proc.stderr


def test_interactive_review_headless(tmp_path, monkeypatch):
    """The blocking key loop without a GUI: ``plt.show`` replaced by key
    events through the real callback registry. '1' keeps, '0' rejects,
    other keys are ignored, closing without a key rejects; the same split
    as the JAX package's on the same plumes and keys."""
    from matplotlib.backend_bases import KeyEvent

    from plumekit.io.granule import Granule as JaxGranule
    from plumekit.label.selector import interactive_review as jax_review
    from plumekit_torch.io.granule import Granule
    from plumekit_torch.label import interactive_review

    aod = np.full((128, 128), 0.05, np.float32)
    aod[40:60, 40:60] = 0.8
    lat, lon = np.mgrid[0:128, 0:128].astype(np.float64)
    df = pd.concat([_square_hull(50, 50, 10, 0), _square_hull(100, 20, 8, 1),
                    _square_hull(20, 100, 8, 2)], ignore_index=True)
    splits = {}
    for name, review, granule, plumes in (
            ("jax", jax_review, JaxGranule({"t0": aod}, lat, lon, name="toy"),
             df),
            ("port", interactive_review,
             Granule({"t0": aod}, lat, lon, name="toy"),
             _table(df, tmp_path, "plumes"))):
        scripts = iter([["x", "1"], ["0"], [None]])

        def fake_show(*args, **kwargs):
            fig = plt.gcf()
            for key in next(scripts):
                if key is None:
                    plt.close(fig)
                    return
                fig.canvas.callbacks.process(
                    "key_press_event",
                    KeyEvent("key_press_event", fig.canvas, key))
                if not plt.fignum_exists(fig.number):
                    return

        monkeypatch.setattr(plt, "show", fake_show)
        kept, rejected = review(plumes, granule)
        ids = (lambda t: sorted(set(t.id))) if name == "jax" else \
            (lambda t: sorted(set(t.column("id"))))
        splits[name] = (ids(kept), ids(rejected))
        assert not plt.get_fignums()
    assert splits["port"] == splits["jax"] == ([0.0], [1.0, 2.0])
