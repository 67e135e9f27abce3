"""The port's evaluation (``plumekit_torch/train/evaluate.py`` and
``evaluate_model``) against the JAX package's on the same seeded inputs:
every integer count and every table row equal (the tables compared as the
CSV text each package writes), the plume components labelled through K2's
plain version on the CPU and renumbered as the host CCL numbers them, and
the two CLIs' reports, sweeps and ``threshold.json`` on one model-data
directory."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.native import ccl_label
from plumekit.train import evaluate as jev
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.models import build_model
from plumekit_torch.train import evaluate as tev
from plumekit_torch.train.checkpoint import save_model_config, save_weights

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
PROB_ATOL = 1e-5      # fp32 forwards and stitching, sums in another order
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(rng, shape, n, small=False):
    """A bool mask of ``n`` random rectangles and discs (small ones when
    ``small``)."""
    h, w = shape
    m = np.zeros(shape, bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        r = int(rng.integers(1, 3 if small else 9))
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        if rng.random() < 0.5:
            m[max(cy - r, 0):cy + r, max(cx - 2 * r, 0):cx + r] = True
        else:
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m


def _pair(seed, shape=(64, 80)):
    """A true mask, and a prediction that moves, drops, adds and fragments
    its plumes, with small components on both sides."""
    rng = np.random.default_rng(seed)
    true = _blobs(rng, shape, 6) | _blobs(rng, shape, 5, small=True)
    pred = np.roll(true, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))),
                   axis=(0, 1))
    pred &= rng.random(shape) > 0.08
    pred |= _blobs(rng, shape, 3) | _blobs(rng, shape, 4, small=True)
    return pred, true


def _text(obj, path):
    """The CSV a port table or a JAX frame writes."""
    if hasattr(obj, "rows"):
        obj.to_csv(str(path))
    else:
        obj.to_csv(str(path), index=False)
    with open(path) as f:
        return f.read()


def _same_table(tmp_path, got, want):
    assert _text(got, tmp_path / "got.csv") == _text(want, tmp_path /
                                                      "want.csv")


@pytest.mark.parametrize("seed", range(4))
def test_label_stack_numbers_components_as_the_host_ccl(seed):
    """K2's labels renumbered: the host CCL's labels 1..n, bit for bit."""
    masks = [_pair(seed)[0], _pair(seed)[1], np.zeros((64, 80), bool),
             np.ones((64, 80), bool)]
    labels, counts = tev.label_stack(torch.from_numpy(np.stack(masks)))
    assert labels.dtype == np.int32
    for m, lab, n in zip(masks, labels, counts):
        want, n_want = ccl_label(m)
        np.testing.assert_array_equal(lab, want)
        assert int(n) == n_want


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("match_iou", [0.3, 0.5])
@pytest.mark.parametrize("min_size", [1, 12])
def test_object_counts_match_jax(seed, match_iou, min_size):
    pred, true = _pair(seed)
    got = tev.object_counts(pred, true, match_iou, min_size, device="cpu")
    want = jev.object_counts(pred, true, match_iou, min_size)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _tied_cases():
    """Masks whose greedy match depends on the order of tied IoUs: P
    covers 5 columns of X and 5 of Y (IoU 1/3 with each), R covers 2
    columns of X; turned every way, so that the numbering changes."""
    true = np.zeros((40, 60), bool)
    pred = np.zeros((40, 60), bool)
    true[10:20, 10:20] = True          # X
    true[10:20, 30:40] = True          # Y
    pred[10:20, 15:35] = True          # P
    pred[12:18, 0:12] = True           # R: touches X
    pred[0:8, 50:52] = True            # a speckle near nothing
    out = []
    for k in range(4):
        for flip in (False, True):
            p, t = np.rot90(pred, k), np.rot90(true, k)
            if flip:
                p, t = np.fliplr(p), np.fliplr(t)
            out.append((np.ascontiguousarray(p), np.ascontiguousarray(t)))
    return out


@pytest.mark.parametrize("match_iou", [0.1, 0.2, 1 / 3])
def test_object_counts_tied_ious_match_jax(match_iou):
    for p, t in _tied_cases():
        np.testing.assert_array_equal(
            tev.object_counts(p, t, match_iou, device="cpu"),
            jev.object_counts(p, t, match_iou))


def test_object_counts_validation():
    a = np.zeros((8, 8), bool)
    with pytest.raises(ValueError, match="shape"):
        tev.object_counts(a, np.zeros((8, 9), bool), device="cpu")
    with pytest.raises(ValueError, match="match_iou"):
        tev.object_counts(a, a, match_iou=0.0, device="cpu")
    np.testing.assert_array_equal(tev.object_counts(a, a, device="cpu"),
                                  [0, 0, 0])


def _probs(seed, shape=(48, 64), ties=True):
    """Probabilities with plumes, and (``ties``) many pixels exactly at
    the swept thresholds in float32, and at 0.5."""
    rng = np.random.default_rng(seed)
    true = _blobs(rng, shape, 5)
    p = np.clip(0.7 * true + rng.normal(0.15, 0.2, shape), 0, 1)
    if ties:
        grid = np.round(np.arange(0.05, 0.951, 0.05), 2).astype(np.float32)
        pick = rng.random(shape) < 0.3
        p[pick] = rng.choice(grid, size=int(pick.sum()))
    return p.astype(np.float32), true


def _pairs(n=3, **kw):
    return [(f"g{i}__layer0",) + _probs(i, **kw) for i in range(n)]


def test_sweep_thresholds_match_jax_with_exact_ties(tmp_path):
    pairs = _pairs()
    _same_table(tmp_path, tev.sweep_thresholds(iter(pairs)),
                jev.sweep_thresholds(iter(pairs)))
    ts = np.array([0.1, 0.5, 0.7])
    _same_table(tmp_path, tev.sweep_thresholds(iter(pairs), ts),
                jev.sweep_thresholds(iter(pairs), ts))
    for bad in (np.array([]), np.array([0.5, 0.5])):
        with pytest.raises(ValueError):
            tev.sweep_thresholds(iter(pairs), bad)


@pytest.mark.parametrize("match_iou, min_size", [(0.5, 1), (0.3, 1),
                                                 (0.5, 20)])
def test_sweep_object_thresholds_match_jax(tmp_path, match_iou, min_size):
    pairs = _pairs()
    _same_table(tmp_path,
                tev.sweep_object_thresholds(iter(pairs), None, match_iou,
                                            min_size, device="cpu"),
                jev.sweep_object_thresholds(iter(pairs), None, match_iou,
                                            min_size))


def test_sweep_object_thresholds_one_label_call_per_sample(monkeypatch):
    from plumekit_torch.ops.kernels import ccl_sweep

    calls = []
    real = ccl_sweep.multi_threshold_ccl

    def counted(masks, *a, **kw):
        calls.append(tuple(masks.shape))
        return real(masks, *a, **kw)

    monkeypatch.setattr(ccl_sweep, "multi_threshold_ccl", counted)
    tev.sweep_object_thresholds(iter(_pairs(2)), device="cpu")
    assert calls == [(20, 48, 64)] * 2


@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("min_size", [1, 15])
def test_evaluate_objects_matches_jax(tmp_path, threshold, min_size):
    pairs = _pairs()
    _same_table(tmp_path,
                tev.evaluate_objects(iter(pairs), threshold, 0.5, min_size,
                                     device="cpu"),
                jev.evaluate_objects(iter(pairs), threshold, 0.5, min_size))


def _write_samples(d, shapes=((48, 64), (48, 80), (40, 64))):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(7)
    for i, shape in enumerate(shapes):
        mask = _blobs(rng, shape, 4).astype(np.float32)
        np.savez_compressed(os.path.join(d, f"g{i}__layer0.npz"),
                            channels=rng.random(shape + (2,),
                                                np.float32) + mask[..., None],
                            mask=mask)


def test_evaluate_model_data_matches_jax(tmp_path):
    data = str(tmp_path / "md")
    _write_samples(data)

    def infer(_v, channels):
        return channels[..., 0] / 2.0, None

    for t in (0.5, 0.7):
        _same_table(tmp_path, tev.evaluate_model_data(infer, None, data, t),
                    jev.evaluate_model_data(infer, None, data, t))
    # the port's inference hands back tensors
    got = tev.evaluate_model_data(
        lambda v, c: (torch.from_numpy(c[..., 0] / 2.0), None), None, data)
    _same_table(tmp_path, got, jev.evaluate_model_data(infer, None, data))


def _write_predictions(pred_dir, data_dir):
    """Predictions for g0 (float32), g1 (uint8) and none for g2, plus a
    second orbit sample of g0 that must not be scored."""
    os.makedirs(pred_dir, exist_ok=True)
    for i, quant in ((0, False), (1, True)):
        with np.load(os.path.join(data_dir, f"g{i}__layer0.npz")) as d:
            p = np.clip(d["channels"][..., 0] / 2.0, 0, 1).astype(np.float32)
        if quant:
            p = np.round(p * 255).astype(np.uint8)
        np.savez_compressed(os.path.join(pred_dir, f"g{i}_pred.npz"),
                            probs=p, mask=p > 0)
    with np.load(os.path.join(data_dir, "g0__layer0.npz")) as d:
        np.savez_compressed(os.path.join(data_dir, "g0__2017200000A.npz"),
                            channels=d["channels"], mask=1.0 - d["mask"])


def test_prediction_pairs_and_evaluate_predictions_match_jax(tmp_path):
    data, preds = str(tmp_path / "md"), str(tmp_path / "pred")
    _write_samples(data)
    _write_predictions(preds, data)
    got = list(tev.prediction_prob_pairs(preds, data))
    want = list(jev.prediction_prob_pairs(preds, data))
    assert [g[0] for g in got] == [w[0] for w in want] == ["g0__layer0",
                                                           "g1__layer0"]
    for (_, gp, gt), (_, wp, wt) in zip(got, want):
        assert gp.dtype == wp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gt, wt)
    _same_table(tmp_path, tev.evaluate_predictions(preds, data, 0.4),
                jev.evaluate_predictions(preds, data, 0.4))
    with pytest.raises(FileNotFoundError):
        list(tev.prediction_prob_pairs(str(tmp_path / "md"), data))


def test_bootstrap_matches_jax(tmp_path):
    pairs = _pairs(4)
    pix = tev._score_rows((n, p > 0.5, t) for n, p, t in pairs)
    obj = tev.evaluate_objects(iter(pairs), device="cpu")
    jpix = jev._score_rows((n, p > 0.5, t) for n, p, t in pairs)
    jobj = jev.evaluate_objects(iter(pairs))
    for seed in (0, 3):
        assert tev.bootstrap_from_df(pix, n_boot=64, seed=seed) == \
            jev.bootstrap_from_df(jpix, n_boot=64, seed=seed)
        assert tev.bootstrap_from_df(obj, "object", 64, seed) == \
            jev.bootstrap_from_df(jobj, "object", 64, seed)
    counts = np.array([[3, 1, 2, 10], [0, 0, 4, 7]])
    assert tev.bootstrap_ci(counts, tev.metrics_from_counts, 9, 1) == \
        jev.bootstrap_ci(counts, jev.metrics_from_counts, 9, 1)
    with pytest.raises(ValueError, match="n_boot"):
        tev.bootstrap_ci(counts, tev.metrics_from_counts, 0)
    with pytest.raises(ValueError, match="count columns"):
        tev.bootstrap_from_df(tev.sweep_thresholds(iter(pairs)))
    assert tev.write_report(pix, None) == jev.write_report(jpix, None)


@pytest.mark.parametrize("counts", [[2, 1, 1, 2], [0, 0, 0, 100],
                                    [0, 0, 50, 50], [0, 3, 0, 0]])
def test_metrics_and_confusion_match_jax(counts):
    assert tev.metrics_from_counts(np.array(counts)) == \
        jev.metrics_from_counts(np.array(counts))
    assert tev.object_metrics_from_counts(np.array(counts[:3])) == \
        jev.object_metrics_from_counts(np.array(counts[:3]))
    pred, true = _pair(sum(counts))
    np.testing.assert_array_equal(tev.confusion_counts(pred, true),
                                  jev.confusion_counts(pred, true))


def test_best_threshold_ties_go_nearest_half():
    pairs = _pairs()
    for metric in ("iou", "recall", "accuracy"):
        assert tev.best_threshold(tev.sweep_thresholds(iter(pairs)),
                                  metric) == \
            jev.best_threshold(jev.sweep_thresholds(iter(pairs)), metric)
    from plumekit_torch.io.tables import Table

    flat = Table(("threshold", "iou"), [(0.3, 0.8), (0.45, 0.8),
                                        (0.6, 0.8), (0.7, 0.1)])
    assert tev.best_threshold(flat) == (0.45, 0.8)
    with pytest.raises(ValueError, match="not in sweep"):
        tev.best_threshold(flat, "dice")


# ------------------------------------------------------------- the CLIs


def _eval_root(tmp_path):
    root = str(tmp_path / "root")
    data = os.path.join(root, "processed", "model_data")
    _write_samples(data)
    preds = os.path.join(root, "processed", "predictions")
    _write_predictions(preds, data)
    return root, preds


def _outputs(root):
    out = {}
    for sub in ("processed", "models"):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith((".csv", ".json")):
                with open(os.path.join(d, f)) as fh:
                    out[f] = fh.read()
                os.remove(os.path.join(d, f))
    if "threshold.json" in out:
        payload = json.loads(out["threshold.json"])
        assert payload.pop("measured_utc")
        out["threshold.json"] = payload
    return out


def _both(root, capsys, argv, port_argv=()):
    """The JAX CLI, then the port's, on ``root``: (printed JSON, files)
    of each."""
    res = []
    for main, extra in ((jax_main, []), (cli.main, CPU + list(port_argv))):
        capsys.readouterr()
        assert main(["evaluate_model", "--root", root, *argv, *extra]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        res.append((json.loads(line), _outputs(root)))
    return res


@pytest.mark.parametrize("flags", [
    [], ["--threshold", "0.3", "--bootstrap", "40"],
    ["--objects", "--min-size", "12", "--bootstrap", "40"],
    ["--objects", "--match-iou", "0.3"],
    ["--sweep-threshold"], ["--sweep-threshold", "dice"],
    ["--sweep-threshold", "obj_f1", "--write-threshold"],
    ["--sweep-threshold", "obj_recall", "--min-size", "12"],
], ids=lambda f: "_".join(a.strip("-") for a in f) or "plain")
def test_evaluate_model_predictions_mode_matches_jax_cli(tmp_path, capsys,
                                                         flags):
    root, preds = _eval_root(tmp_path)
    (want, want_files), (got, got_files) = _both(
        root, capsys, ["--predictions", preds, *flags])
    assert got == want
    assert got_files == want_files and got_files


def _carried_root(tmp_path):
    """A model-data root and a checkpoint dir holding the JAX trainer's
    initial weights (PRNGKey(0), what the JAX CLI serves with no step
    checkpoint), carried over to the port's weights.pt."""
    root = str(tmp_path / "root")
    data = os.path.join(root, "processed", "model_data")
    _write_samples(data, shapes=((64, 64), (64, 96)))
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, UNetConfig(**KW))
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(variables))
    save_weights(ckpt, model)
    return root, data, variables


SERVE = ["--tile", "32", "--overlap", "8"]


def test_evaluate_model_inference_mode_matches_jax_cli(tmp_path, capsys):
    """Probabilities within PROB_ATOL of the JAX CLI's; the report and the
    sweep equal wherever no probability lies that close to a threshold."""
    from plumekit.config.train import InferConfig as JaxInferConfig
    from plumekit.infer import make_sliding_infer as jax_sliding
    from plumekit.models import build_model as jax_build_model

    root, data, variables = _carried_root(tmp_path)
    args = cli.build_parser().parse_args(
        ["evaluate_model", "--root", root, *CPU, *SERVE])
    cfg, model = cli._restore_model(args, torch.device("cpu"))
    infer = cli._evaluation_infer(args, cfg, torch.device("cpu"))
    jinfer = jax_sliding(jax_build_model(JaxUNetConfig(**KW)).apply,
                         JaxInferConfig(tile_size=32, overlap=8), channels=2)
    got = list(tev.inference_prob_pairs(infer, model, data))
    want = list(jev.inference_prob_pairs(jinfer, variables, data))
    near = set()
    for (n, p, t), (wn, wp, wt) in zip(got, want):
        assert n == wn and p.shape == wp.shape == t.shape
        np.testing.assert_allclose(p, wp, atol=PROB_ATOL, rtol=0)
        near |= {float(th) for th in np.append(tev.default_thresholds(), 0.5)
                 if (np.abs(wp - th) <= PROB_ATOL).any()}

    (want_json, want_files), (got_json, got_files) = _both(
        root, capsys, SERVE + ["--sweep-threshold", "--write-threshold"])
    sweep_rows = [r.split(",") for r in
                  got_files["threshold_sweep.csv"].splitlines()]
    want_rows = [r.split(",") for r in
                 want_files["threshold_sweep.csv"].splitlines()]
    assert sweep_rows[0] == want_rows[0]
    compared = 0
    for g, w in zip(sweep_rows[1:], want_rows[1:]):
        if float(w[0]) not in near:
            assert g == w
            compared += 1
    assert compared >= 15
    if not near:
        assert got_json == want_json
        assert got_files == want_files
    (want_json, want_files), (got_json, got_files) = _both(root, capsys,
                                                           SERVE)
    if 0.5 not in near:
        assert got_json == want_json and got_files == want_files


def test_evaluate_model_serves_a_use_mega_checkpoint_through_k7(
        tmp_path, caplog, monkeypatch):
    """A use_mega checkpoint evaluates through K7 (its plain version on the
    CPU) once per forward, within PROB_ATOL of the plain forward; a bad
    --prune-level exits 1 before any inference."""
    from plumekit_torch.models.kernels import unet_mega

    root, data, _v = _carried_root(tmp_path)
    ckpt = os.path.join(root, "models", "checkpoints")
    args = cli.build_parser().parse_args(
        ["evaluate_model", "--root", root, *CPU, *SERVE])
    cfg, model = cli._restore_model(args, torch.device("cpu"))
    plain = list(tev.inference_prob_pairs(
        cli._evaluation_infer(args, cfg, torch.device("cpu")), model, data))
    save_model_config(ckpt, UNetConfig(**KW, use_mega=True))
    calls = []
    real = unet_mega.mega_forward_ref

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(unet_mega, "mega_forward_ref", counted)
    cfg, model = cli._restore_model(args, torch.device("cpu"))
    assert cfg.use_mega
    mega = list(tev.inference_prob_pairs(
        cli._evaluation_infer(args, cfg, torch.device("cpu")), model, data))
    assert len(calls) == 2          # one forward per sample at 64 tiles
    for (_, p, _), (_, q, _) in zip(mega, plain):
        np.testing.assert_allclose(p, q, atol=PROB_ATOL, rtol=0)
    assert cli.main(["evaluate_model", "--root", root, *CPU, *SERVE]) == 0
    with caplog.at_level(logging.ERROR):
        assert cli.main(["evaluate_model", "--root", root, *CPU, *SERVE,
                         "--prune-level", "1"]) == 1
    assert "--prune-level" in caplog.text


@pytest.mark.parametrize("flags, message", [
    (["--match-iou", "0"], "--match-iou"),
    (["--min-size", "0"], "--min-size"),
    (["--bootstrap", "-1"], "--bootstrap"),
    (["--objects", "--sweep-threshold"], "exclusive"),
    (["--bootstrap", "5", "--sweep-threshold"], "exclusive"),
    (["--sweep-threshold", "nope"], "unknown metric"),
])
def test_evaluate_model_refusals_exit_1_in_both_clis(tmp_path, caplog,
                                                     flags, message):
    root, preds = _eval_root(tmp_path)
    argv = ["evaluate_model", "--root", root, "--predictions", preds, *flags]
    with caplog.at_level(logging.ERROR):
        assert jax_main(argv) == 1
        caplog.clear()
        assert cli.main(argv + CPU) == 1
    assert message in caplog.text
    assert _outputs(root) == {}


def test_evaluate_model_without_a_card_exits_1(tmp_path, caplog,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, preds = _eval_root(tmp_path)
    with caplog.at_level(logging.ERROR):
        assert cli.main(["evaluate_model", "--root", root,
                         "--predictions", preds]) == 1
    assert "--device cpu" in caplog.text
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.object_counts(np.zeros((4, 4), bool), np.zeros((4, 4), bool))
