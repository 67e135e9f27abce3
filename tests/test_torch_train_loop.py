"""The port's training loop, step checkpoints and the ``make_dataset`` /
``train_model`` commands against the JAX package's: three loop steps from
carried-over parameters against ``make_train_step`` over the JAX
``tile_batches``, resume, early stopping with the best state restored,
``make_dataset``'s files, and the quick-start chain on a tiny root."""

import csv
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.cli import main as jax_main
from plumekit.config.train import DataConfig as JaxDataConfig
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.train import data as jax_data
from plumekit.train.state import create_state as jax_create_state
from plumekit.train.step import make_train_step as jax_make_train_step
from plumekit_torch import cli
from plumekit_torch.config import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.io.granule import load_granule
from plumekit_torch.models import UNet
from plumekit_torch.train import checkpoint as ckpt
from plumekit_torch.train.loop import chunk_schedule, train
from plumekit_torch.train.state import create_state

SMALL = dict(in_channels=2, base_features=8, depth=2,
             compute_dtype="float32")
DATA = dict(granule_size=64, n_train_granules=1, n_eval_granules=1)
LOSS_RTOL = 1e-5     # fp32, sums in another order
PARAM_ATOL = 1e-6    # 1e-3 of the peak lr (see test_torch_train_step.py)
STAT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _tcfg(tmp_path, **kw):
    base = dict(batch_size=2, tile_size=32, total_steps=3, warmup_steps=1,
                learning_rate=1e-3, log_every=1, checkpoint_every=1000,
                augment=False, checkpoint_dir=str(tmp_path / "ckpt"))
    return {**base, **kw}


def test_loop_three_steps_match_jax_steps_over_jax_tile_stream(tmp_path):
    """The host-iterator loop (augmentation off, fp32) from parameters
    carried over from a JAX state equals ``make_train_step`` driven over
    the JAX ``tile_batches`` from ``default_rng((seed, 0))``: the loss and
    IoU of every step, and the parameters and running buffers saved at the
    end."""
    kw = _tcfg(tmp_path)
    jstate = jax_create_state(jax.random.PRNGKey(0), JaxUNetConfig(**SMALL),
                              JaxTrainConfig(**kw))
    # a step-0 checkpoint of the carried-over weights: the loop resumes
    # from it
    start = create_state(UNetConfig(**SMALL), TrainConfig(**kw), "cpu")
    start.model.load_state_dict(from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})))
    ckpt.save_checkpoint(kw["checkpoint_dir"], start, 0)
    hist = train(UNetConfig(**SMALL), TrainConfig(**kw), DataConfig(**DATA),
                 device="cpu")

    samples = jax_data.make_synthetic_dataset(JaxDataConfig(**DATA))
    stream = jax_data.tile_batches(samples, 32, 2,
                                   np.random.default_rng((0, 0)))
    jstep = jax_make_train_step(0.5, augment=False)
    losses, ious = [], []
    for i in range(3):
        xs, ys = next(stream)
        jstate, m = jstep(jstate, jnp.asarray(xs), jnp.asarray(ys),
                          jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        ious.append(float(m["iou"]))
    np.testing.assert_allclose(hist["loss"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(hist["iou"], ious, atol=1e-6)

    assert ckpt.latest_step(kw["checkpoint_dir"]) == 3
    assert sorted(os.listdir(kw["checkpoint_dir"]))[1:3] == [
        "step_00000000.pt", "step_00000003.pt"]
    got = torch.load(os.path.join(kw["checkpoint_dir"], "weights.pt"))
    want = from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = STAT_TOL if "running" in name else PARAM_ATOL
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol,
                                   rtol=STAT_TOL if "running" in name else 0,
                                   err_msg=name)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """With the device-resident data (draws and codes counter-based in
    (seed, step)) a run that lost everything after its step-3 checkpoint
    and was started again ends where the uninterrupted run ends, bit for
    bit."""
    kw = dict(device_data=True, augment=True, total_steps=6, log_every=3,
              checkpoint_every=3)
    whole = _tcfg(tmp_path / "a", **kw)
    crashed = _tcfg(tmp_path / "b", **kw)
    for cfg in (whole, crashed):
        train(UNetConfig(**SMALL), TrainConfig(**cfg), DataConfig(**DATA),
              device="cpu")
    ckpt.prune_after(crashed["checkpoint_dir"], 3)
    assert ckpt.latest_step(crashed["checkpoint_dir"]) == 3
    train(UNetConfig(**SMALL), TrainConfig(**crashed), DataConfig(**DATA),
          device="cpu")
    a = torch.load(os.path.join(whole["checkpoint_dir"], "step_00000006.pt"))
    b = torch.load(os.path.join(crashed["checkpoint_dir"],
                                "step_00000006.pt"))
    assert a["step"] == b["step"] == 6
    assert a["optimizer"]["state"][0]["step"] == b["optimizer"]["state"][0][
        "step"]
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name


def test_host_resume_reseeds_the_tile_stream(tmp_path):
    """On the host iterator a resume at step k draws from
    ``default_rng((seed, k))``, as the JAX loop does: resuming twice from
    the same checkpoint gives the same state, and the metrics CSV of the
    resumed run continues the first run's rows."""
    kw = _tcfg(tmp_path / "a", total_steps=2, checkpoint_every=2)
    train(UNetConfig(**SMALL), TrainConfig(**kw), DataConfig(**DATA),
          device="cpu")
    metrics = kw["checkpoint_dir"] + "_metrics.csv"
    first = _csv_rows(metrics)
    other = tmp_path / "b" / "ckpt"
    os.makedirs(other)
    for name in os.listdir(kw["checkpoint_dir"]):
        with open(os.path.join(kw["checkpoint_dir"], name), "rb") as f, \
                open(other / name, "wb") as g:
            g.write(f.read())
    for d in (kw["checkpoint_dir"], str(other)):
        train(UNetConfig(**SMALL),
              TrainConfig(**dict(kw, total_steps=4, checkpoint_dir=d)),
              DataConfig(**DATA), device="cpu")
    a = torch.load(os.path.join(kw["checkpoint_dir"], "weights.pt"))
    b = torch.load(other / "weights.pt")
    assert all(torch.equal(a[k], b[k]) for k in a)
    rows = _csv_rows(metrics)
    assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
    assert rows[:2] == first


def test_early_stop_restores_best_and_prunes(tmp_path):
    """A frozen model (lr 0) stops after two evals without improvement,
    restores the step-5 state, keeps it as the newest checkpoint at its own
    step and in ``weights.pt``, and drops the step-10 checkpoint, as the
    JAX loop does (tests/test_model_train.py)."""
    kw = _tcfg(tmp_path, total_steps=40, log_every=10, eval_every=5,
               early_stop_patience=2, checkpoint_every=10, learning_rate=0.0)
    hist = train(UNetConfig(**SMALL), TrainConfig(**kw), DataConfig(**DATA),
                 device="cpu")
    d = kw["checkpoint_dir"]
    assert hist["eval_steps"] == [5, 10, 15]
    assert hist["best_dev_step"] == [5.0]
    assert hist["eval_iou"] == pytest.approx(hist["best_dev_iou"])
    assert sorted(os.listdir(d)) == ["model_config.json", "step_00000005.pt",
                                     "weights.pt"]
    saved = torch.load(os.path.join(d, "step_00000005.pt"))
    weights = torch.load(os.path.join(d, "weights.pt"))
    assert saved["step"] == 5
    assert all(torch.equal(saved["model"][k], weights[k]) for k in weights)


def test_chunk_schedule_stops_at_every_boundary():
    sizes = list(chunk_schedule(3, 25, 10, [10, 4, 0]))
    assert sizes == [1, 4, 2, 2, 4, 4, 4, 1]
    assert sum(sizes) == 22
    assert list(chunk_schedule(0, 7, 1, [5])) == [1] * 7


def test_chunks_do_not_change_the_run(tmp_path):
    """``steps_per_dispatch`` only groups steps: the same losses as one
    step per chunk."""
    runs = [train(UNetConfig(**SMALL),
                  TrainConfig(**_tcfg(tmp_path / str(k), total_steps=4,
                                      log_every=2, steps_per_dispatch=k,
                                      augment=True)),
                  DataConfig(**DATA), device="cpu")
            for k in (1, 3)]
    assert runs[0]["loss"] == runs[1]["loss"]


def test_step_checkpoints_are_not_orbax(tmp_path):
    """``has_orbax_steps`` tells the JAX trainer's orbax step directories
    from the port's step files, so a port checkpoint directory is never
    refused as a JAX one."""
    port = tmp_path / "port"
    train(UNetConfig(**SMALL), TrainConfig(**_tcfg(tmp_path / "p",
                                                   total_steps=1,
                                                   checkpoint_dir=str(port))),
          DataConfig(**DATA), device="cpu")
    assert ckpt.latest_step(str(port)) == 1
    assert not ckpt.has_orbax_steps(str(port))
    orbax = tmp_path / "orbax"
    os.makedirs(orbax / "step_00000200")
    os.makedirs(orbax / "step_00000400.tmp")
    assert ckpt.has_orbax_steps(str(orbax))
    assert ckpt.latest_step(str(orbax)) is None
    os.remove(port / "weights.pt")     # served from no weights: a warning
    assert not ckpt.has_orbax_steps(str(port))


def test_model_config_of_live_checkpoints_is_kept(tmp_path):
    """A directory with step checkpoints refuses another config."""
    kw = _tcfg(tmp_path, total_steps=1)
    train(UNetConfig(**SMALL), TrainConfig(**kw), DataConfig(**DATA),
          device="cpu")
    with pytest.raises(ValueError, match="step-1 checkpoints"):
        train(UNetConfig(**dict(SMALL, base_features=4)),
              TrainConfig(**kw), DataConfig(**DATA), device="cpu")
    assert ckpt.load_model_config(kw["checkpoint_dir"]) == UNetConfig(**SMALL)


def _read_fires(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in r[:3]] + [r[3]] for r in rows[1:]]


def test_make_dataset_writes_the_jax_commands_files(tmp_path):
    args = ["--n-granules", "2", "--size", "64", "--seed", "3"]
    assert cli.main(["make_dataset", "--root", str(tmp_path / "t"),
                     *args]) == 0
    assert jax_main(["make_dataset", "--root", str(tmp_path / "j"),
                     *args]) == 0
    maiac = os.path.join("raw", "plume_identification", "maiac")
    names = sorted(os.listdir(tmp_path / "t" / maiac))
    assert names == sorted(os.listdir(tmp_path / "j" / maiac))
    assert len(names) == 2
    for name in names:
        a = load_granule(str(tmp_path / "t" / maiac / name))
        b = load_granule(str(tmp_path / "j" / maiac / name))
        assert a.name == b.name and list(a.layers) == list(b.layers)
        for x, y in [(a.lat, b.lat), (a.lon, b.lon),
                     *zip(a.layers.values(), b.layers.values())]:
            assert np.array_equal(x, y)
    fires = os.path.join("raw", "fires", "fires.csv")
    assert _read_fires(tmp_path / "t" / fires) == \
        _read_fires(tmp_path / "j" / fires)


def test_make_dataset_module_entry(tmp_path):
    from plumekit_torch.data.make_dataset import main

    assert main(["--root", str(tmp_path), "--n-granules", "1",
                 "--size", "32"]) == 0
    assert os.path.exists(tmp_path / "raw" / "fires" / "fires.csv")


def test_quick_start_chain_on_the_cpu(tmp_path, caplog):
    """make_dataset → build_features --detector rg → train_model
    --weak-labels → predict_model, all with ``--device cpu``:
    ``train_model`` writes ``model_config.json``, ``weights.pt`` and the
    metrics CSV, and ``predict_model`` serves them."""
    root = str(tmp_path)
    dev = ["--root", root, "--device", "cpu"]
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "2",
                     "--size", "64"]) == 0
    assert cli.main(["build_features", *dev, "--detector", "rg"]) == 0
    with caplog.at_level(logging.INFO):
        assert cli.main(["train_model", *dev, "--weak-labels",
                         "--granule-size", "64", "--tile", "32",
                         "--batch-size", "2", "--steps", "20"]) == 0
    assert "step 20 loss=" in caplog.text
    ck = os.path.join(root, "models", "checkpoints")
    assert ckpt.load_model_config(ck) == UNetConfig()
    assert sorted(os.listdir(ck)) == ["model_config.json",
                                      "step_00000020.pt", "weights.pt"]
    rows = _csv_rows(ck + "_metrics.csv")
    assert [r["step"] for r in rows] == ["20"]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert cli.main(["predict_model", *dev, "--tile", "32",
                         "--overlap", "8"]) == 0
    assert "restored weights" in caplog.text
    out = os.path.join(root, "processed", "predictions")
    preds = sorted(os.listdir(out))
    assert preds == ["SYNTH.00000000_pred.npz", "SYNTH.00000001_pred.npz"]
    with np.load(os.path.join(out, preds[0])) as d:
        assert d["probs"].shape == (64, 64)
        assert np.isfinite(d["probs"]).all()


def test_train_model_data_parallel_on_the_cpu(tmp_path, monkeypatch):
    """``train_model --device cpu --data-parallel 2``: two gloo ranks, each
    with half of every batch; rank 0 alone writes, so the checkpoint
    directory is the one-process call's, and the weights and running
    buffers equal its within the step tolerances. A
    small float64 config stands in for ``UNetConfig()`` (the ranks receive
    the config the command built), as in ``tests/test_torch_train_dp.py``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(cli, "UNetConfig", lambda **kw: UNetConfig(
        **{**SMALL, "compute_dtype": "float64", **kw}))
    argv = ["train_model", "--device", "cpu", "--granule-size", "64",
            "--tile", "32", "--batch-size", "4", "--steps", "3"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    assert cli.main(argv + ["--root", dp, "--data-parallel", "2"]) == 0
    assert cli.main(argv + ["--root", one]) == 0
    dirs = [os.path.join(r, "models", "checkpoints") for r in (dp, one)]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == [
        "model_config.json", "step_00000003.pt", "weights.pt"]
    assert sorted(os.listdir(os.path.join(dp, "models"))) \
        == sorted(os.listdir(os.path.join(one, "models")))
    models = []
    for d in dirs:
        net = UNet(cli.UNetConfig())
        assert ckpt.load_weights(d, net)
        models.append(net.state_dict())
    for name, want in models[1].items():
        got = models[0][name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=STAT_TOL, atol=STAT_TOL,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            assert (got - want).abs().max() <= PARAM_ATOL, name


def test_train_model_data_parallel_refuses_more_ranks_than_cards(
        tmp_path, caplog, monkeypatch):
    """More ranks than visible cards: the JAX CLI's mesh error (its 8
    virtual CPU devices; the port seeing 8 cards), exit 1, nothing
    written."""
    from plumekit_torch.parallel import mesh as mesh_mod

    with pytest.raises(ValueError) as want:
        jax_main(["train_model", "--root", str(tmp_path / "jax"),
                  "--data-parallel", "9"])
    monkeypatch.setattr(cli, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [
        torch.device("cuda", i) for i in range(8)])
    with caplog.at_level(logging.ERROR):
        assert cli.main(["train_model", "--root", str(tmp_path / "port"),
                         "--data-parallel", "9"]) == 1
    assert [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR] == [str(want.value)]
    assert not os.path.exists(tmp_path / "port")


@pytest.mark.parametrize("flag", ["--viirs-swaths", "--viirs-aod-pairs"])
def test_unported_make_dataset_flags_exit_1(flag, caplog, tmp_path,
                                            monkeypatch):
    """The VIIRS flags, refused until the port had them, now exit 1 only
    where the h5 pairs cannot be written: without h5py, before anything
    is written (the swaths too, when they ride with the pairs)."""
    argv = ["make_dataset", "--n-granules", "1", "--size", "64", flag, "1"]
    if flag == "--viirs-swaths":
        argv += ["--viirs-aod-pairs", "1"]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with caplog.at_level(logging.ERROR):
            assert cli.main([*argv, "--root", str(tmp_path / "a")]) == 1
        assert "requires h5py" in caplog.text
        assert not os.path.exists(tmp_path / "a")
    pytest.importorskip("h5py")
    assert cli.main([*argv, "--root", str(tmp_path / "b")]) == 0
    sub = "sdr" if flag == "--viirs-swaths" else "aod"
    assert os.listdir(tmp_path / "b" / "raw" / "viirs" / sub)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_train_model_without_a_card_exits_1(tmp_path, caplog):
    """The default device is the card; without one the command exits 1
    instead of training on the CPU."""
    with caplog.at_level(logging.ERROR):
        assert cli.main(["train_model", "--root", str(tmp_path)]) == 1
    assert "CUDA is not available" in caplog.text
    assert not os.path.exists(tmp_path / "models")
