"""plumekit_torch's data-parallel training: two ranks of a gloo group on
the CPU (``parallel/launch.launch``), each with its half of every global
batch.

* Three steps, augmentation off, against the JAX package's
  ``make_train_step(mesh=make_mesh(MeshConfig(data=2)))`` on its virtual
  CPU mesh from the same parameters (``convert.from_flax``), at the
  tolerances of ``tests/test_torch_train_step.py``: the loss and IoU, the
  gradients, the parameters and the running buffers after each step.
* Without and with augmentation against the port's one-process step on
  the global batch with the same generator (the JAX package draws other
  codes), both in float64 compute: in fp32 the two batch norms round the
  variance differently (``F.batch_norm`` in one process; E[x²] − E[x]²,
  as flax, over the ranks), and a max-pool or ReLU at a near-tie can then
  move a few gradients by percents, either way as near to the float64
  gradient.
* The parameters equal on both ranks after the steps.
* ``train`` under ``mesh_cfg`` (host stream, ``quantize_transfer``,
  ``device_data``, a resume) against the one-process ``train``: the
  histories, the checkpoint files, rank 0's metrics rows alone, the final
  weights.
* Batch norm over a one-rank group against flax's train-mode batch norm.

The ranks run ``tests/torch_dp_worker.py``, which imports no JAX."""

import csv
import os
import socket
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import MeshConfig as JaxMeshConfig
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import UNet as JaxUNet
from plumekit.models.losses import dice_bce_loss as jax_dice_bce
from plumekit.parallel import make_mesh as jax_make_mesh
from plumekit.train.state import create_state as jax_create_state
from plumekit.train.step import make_train_step as jax_make_train_step
from plumekit.train.step import shard_batch as jax_shard_batch
from plumekit_torch.config import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.models import UNet
from plumekit_torch.parallel.launch import launch
from plumekit_torch.train import checkpoint as ckpt
from plumekit_torch.train.loop import train
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step, step_generator

sys.path.insert(0, os.path.dirname(__file__))
import torch_dp_worker  # noqa: E402

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
TCFG = dict(batch_size=4, tile_size=32, learning_rate=1e-3,
            weight_decay=1e-2, warmup_steps=1, total_steps=4, augment=False)
# the tolerances of tests/test_torch_train_step.py: fp32 on both sides,
# sums in another order (here also split over two ranks)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4     # max|Δg| per tensor, relative to max|g| of the tensor
STAT_TOL = 1e-5     # running buffers, rtol and atol
PARAM_TOL = 1e-3    # max|Δp| relative to the peak lr
SEED = 11
#: the data-parallel runs: name → augmentation, compute dtype
STEP_RUNS = {"plain": (False, "float32"), "plain64": (False, "float64"),
             "augment64": (True, "float64")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_thread_ranks(monkeypatch):
    """The spawned ranks start with one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(4, 32, 32, 2)).astype(np.float32),
             (rng.random((4, 32, 32, 1)) < 0.3).astype(np.float32))
            for _ in range(3)]


@pytest.fixture(scope="module")
def dp_run():
    """The JAX initial state and three data-parallel steps of two ranks
    from it, with and without augmentation (one launch for every test)."""
    jstate = jax_create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                              JaxTrainConfig(**TCFG))
    sd = from_flax(_numpy({"params": jstate.params,
                           "batch_stats": jstate.batch_stats}))
    out = launch(torch_dp_worker.steps, ["cpu", "cpu"], args=({
        "kw": KW, "tcfg": TCFG, "seed": SEED, "batches": _batches(),
        "runs": STEP_RUNS, "state": {k: v.numpy() for k, v in sd.items()}},))
    return jstate, sd, out


def _assert_params_close(got: dict, want: dict, lr):
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g, w = np.asarray(got[name]), np.asarray(w)
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=STAT_TOL, atol=STAT_TOL,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= PARAM_TOL * lr, name


def _assert_grads_close(got: dict, want: dict):
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(got[name]) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def test_dp_steps_match_the_jax_mesh_step(dp_run):
    jstate, _, out = dp_run
    mesh = jax_make_mesh(JaxMeshConfig(data=2))
    jstep = jax_make_train_step(0.5, augment=False, mesh=mesh)
    run = out["plain"]
    for i, (xs, ys) in enumerate(_batches()):
        def loss_fn(params):
            logits, _ = jstate.apply_fn(
                {"params": params, "batch_stats": jstate.batch_stats},
                jnp.asarray(xs), train=True, mutable=["batch_stats"])
            return jax_dice_bce(logits, jnp.asarray(ys), 0.5)

        jgrads = from_flax({"params": _numpy(jax.grad(loss_fn)(
            jstate.params))})
        jstate, jm = jstep(jstate, *jax_shard_batch(mesh, xs, ys),
                           jax.random.PRNGKey(i))
        loss, iou = run["metrics"][i]
        assert loss == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
        assert iou == pytest.approx(float(jm["iou"]), abs=1e-6)
        _assert_grads_close(run["grads"][i],
                            {k: v.numpy() for k, v in jgrads.items()})
    want = from_flax(_numpy({"params": jstate.params,
                             "batch_stats": jstate.batch_stats}))
    _assert_params_close(run["state"], want, TCFG["learning_rate"])


@pytest.mark.parametrize("name", ["plain64", "augment64"])
def test_dp_steps_match_the_one_process_step(dp_run, name):
    """The one-process step on each global batch, with the same generator
    for the augmentation codes, both in float64 compute."""
    _, sd, out = dp_run
    run = out[name]
    augment, dtype = STEP_RUNS[name]
    state = create_state(UNetConfig(**{**KW, "compute_dtype": dtype}),
                         TrainConfig(**TCFG), "cpu")
    state.model.load_state_dict(sd)
    step = make_train_step(0.5, augment=augment)
    for i, (xs, ys) in enumerate(_batches()):
        state, m = step(state, torch.from_numpy(xs), torch.from_numpy(ys),
                        step_generator(SEED, i, "cpu"))
        loss, iou = run["metrics"][i]
        assert loss == pytest.approx(float(m["loss"]), rel=LOSS_RTOL)
        assert iou == pytest.approx(float(m["iou"]), abs=1e-6)
        _assert_grads_close(run["grads"][i], {
            n: p.grad.numpy() for n, p in state.model.named_parameters()})
    _assert_params_close(run["state"], state.model.state_dict(),
                         TCFG["learning_rate"])


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_dp_parameters_stay_equal_on_every_rank(dp_run, name):
    assert dp_run[2][name]["same"]


# ------------------------------------------------------------- the loop

RUNS = {"host": {}, "quantize": {"quantize_transfer": True},
        "device_data": {"device_data": True, "steps_per_dispatch": 2},
        "resume": {"resume_from": 2},
        "early_stop": {"eval_every": 1, "early_stop_patience": 1}}
LOOP_KW = dict(KW, compute_dtype="float64")      # as the steps above
LOOP_TCFG = dict(TCFG, augment=True, total_steps=4, log_every=2,
                 checkpoint_every=2, seed=5)
DCFG = dict(granule_size=64, n_train_granules=2, n_eval_granules=1, seed=3)


def _metrics_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_dp_train_loop_equals_the_one_process_loop(tmp_path):
    """Each run of ``RUNS`` on two ranks and in one process: the same
    history (dev evaluations and the early stop included), the same
    checkpoint files, one metrics row per logged step, final weights within
    the step tolerances."""
    hist = launch(torch_dp_worker.loops, ["cpu", "cpu"], args=({
        "kw": LOOP_KW, "tcfg": LOOP_TCFG, "dcfg": DCFG, "runs": RUNS,
        "root": str(tmp_path / "dp")},))
    for name, extra in RUNS.items():
        extra = dict(extra)
        first = extra.pop("resume_from", None)
        tcfg = TrainConfig(**{**LOOP_TCFG, **extra, "checkpoint_dir":
                              str(tmp_path / "one" / name)})
        kwargs = dict(unet_cfg=UNetConfig(**LOOP_KW),
                      data_cfg=DataConfig(**DCFG), device="cpu")
        if first is not None:
            train(train_cfg=TrainConfig(**{**tcfg.__dict__,
                                           "total_steps": first}), **kwargs)
        want = train(train_cfg=tcfg, **kwargs)
        got = hist[name]
        assert sorted(got) == sorted(want), name
        for key in ("loss", "iou", "eval_iou", "eval_steps",
                    "eval_iou_curve"):
            assert len(got[key]) == len(want[key]), (name, key)
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"{name} {key}")
        dp_dir, one_dir = tmp_path / "dp" / name, tmp_path / "one" / name
        assert sorted(os.listdir(dp_dir)) == sorted(os.listdir(one_dir))
        dp_rows = _metrics_rows(f"{dp_dir}_metrics.csv")
        assert [r["step"] for r in dp_rows] == [
            r["step"] for r in _metrics_rows(f"{one_dir}_metrics.csv")]
        models = []
        for d in (dp_dir, one_dir):
            model = UNet(UNetConfig(**LOOP_KW))
            assert ckpt.load_weights(str(d), model)
            models.append(model.state_dict())
        _assert_params_close(models[0], models[1],
                             LOOP_TCFG["learning_rate"])


# ------------------------------------------------- one-rank batch norm


def test_global_batch_norm_of_one_rank_matches_flax():
    """The global path of ``_batch_norm`` over a one-rank gloo group:
    train-mode logits and the running buffers after two forwards equal
    flax's, and the gradient flows through the reduction."""
    import torch.distributed as dist

    from plumekit_torch.parallel.data_parallel import set_batch_stats_group

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        cfg = JaxUNetConfig(**KW)
        rng = np.random.default_rng(9)
        xs = [rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
              for _ in range(2)]
        variables = JaxUNet(cfg).init(jax.random.PRNGKey(4),
                                      jnp.asarray(xs[0]), train=False)
        model = UNet(UNetConfig(**KW))
        model.load_state_dict(from_flax(_numpy(variables)))
        model.train()
        set_batch_stats_group(model, dist.group.WORLD)
        for x in xs:
            logits, upd = JaxUNet(cfg).apply(variables, jnp.asarray(x),
                                             train=True,
                                             mutable=["batch_stats"])
            variables = {"params": variables["params"], **upd}
            got = model(torch.from_numpy(x))
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(logits), rtol=1e-4,
                                       atol=1e-4)
        got.sum().backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters())
        want = from_flax(_numpy(variables))
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           rtol=STAT_TOL, atol=STAT_TOL,
                                           err_msg=name)
    finally:
        dist.destroy_process_group()
