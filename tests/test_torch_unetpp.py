"""plumekit_torch's UNet++ (``models/unetpp.py``) against the JAX package's
(``plumekit/models/unetpp.py``) on the same numpy inputs and weights: the
fp32 eval forward with and without deep supervision, the train-mode forward
and its batch statistics, the converter, serving-time pruning, the config
checks, the checkpoint record, the bf16 layout, and the CLI chain
(``tests/test_unetpp.py``'s contracts, held on the port).

The weights come from the port's seeded init carried to flax by
``convert.to_flax`` (a flax init of the grid costs 15-40 s on the CPU);
``test_carried_variables_have_flax_layout`` holds their tree against the
flax module's own."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models.losses import dice_bce_loss as jax_dice_bce
from plumekit.models.unetpp import UNetPP as JaxUNetPP
from plumekit_torch import cli
from plumekit_torch.config import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax, to_flax
from plumekit_torch.models import UNet, UNetPP, build_model, effective_level
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step

from test_torch_unet import F32_TOL

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32",
          arch="unetpp")
DS_KW = dict(KW, depth=3, deep_supervision=True)
STAT_TOL = 1e-5     # batch statistics and running buffers, rtol and atol
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(kw, seed=0, norm="batch"):
    """flax UNetPP variables of ``kw`` with nontrivial norm parameters and
    running statistics, as numpy."""
    cfg = UNetConfig(**kw, norm=norm)
    model = build_model(cfg, torch.Generator().manual_seed(seed))
    v = to_flax(model.state_dict(), norm)
    return jax.tree.map(
        lambda a: a + 0.03 * np.arange(a.size, dtype=a.dtype).reshape(
            a.shape) if a.ndim == 1 else a, v)


def _port(kw, variables, **extra):
    model = UNetPP(UNetConfig(**kw, **extra))
    model.load_state_dict(from_flax(variables))
    return model.eval()


def _x(seed=0, n=2, size=32):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 2)).astype(np.float32)


def _jax_apply(kw, variables, x, **extra):
    return np.asarray(jax.jit(JaxUNetPP(JaxUNetConfig(**kw, **extra)).apply)(
        variables, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [KW, DS_KW], ids=["plain", "ds"])
def test_carried_variables_have_flax_layout(kw):
    want = jax.eval_shape(
        lambda: JaxUNetPP(JaxUNetConfig(**kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)), train=False))
    got = _variables(kw)
    flat_w = {p: (leaf.shape, leaf.dtype)
              for p, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {p: (leaf.shape, leaf.dtype)
              for p, leaf in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w


@pytest.mark.parametrize("kw", [KW, DS_KW], ids=["plain", "ds"])
def test_eval_forward_matches_flax(kw):
    variables = _variables(kw)
    x = _x()
    with torch.no_grad():
        got = _port(kw, variables)(torch.from_numpy(x))
    want = _jax_apply(kw, variables, x)
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kw", [KW, DS_KW], ids=["plain", "ds"])
def test_train_mode_forward_stats_and_step_loss_match_flax(kw):
    """Two train-mode forwards: the logits of each and the running mean
    and biased variance after both equal flax's ``mutable=["batch_stats"]``
    updates; then one train step's loss, which reads the (averaged) logits
    only, equals the JAX package's dice + BCE of them."""
    cfg = JaxUNetConfig(**kw)
    variables = _variables(kw, seed=1)
    model = _port(kw, variables).train()
    apply = jax.jit(lambda v, x: JaxUNetPP(cfg).apply(
        v, x, train=True, mutable=["batch_stats"]))
    for seed in (0, 1):
        xs = _x(seed, n=4)
        logits, upd = apply(variables, jnp.asarray(xs))
        variables = {"params": variables["params"],
                     **jax.tree.map(np.asarray, upd)}
        with torch.no_grad():
            got = model(torch.from_numpy(xs))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
    want = from_flax(variables)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=STAT_TOL, atol=STAT_TOL,
                                       err_msg=name)

    xs = _x(2, n=4)
    ys = (np.random.default_rng(3).random((4, 32, 32, 1)) < 0.3).astype(
        np.float32)
    logits, _ = apply(variables, jnp.asarray(xs))
    state = create_state(UNetConfig(**kw), TrainConfig(batch_size=4,
                                                       tile_size=32), "cpu")
    state.model.load_state_dict(from_flax(variables))
    _, metrics = make_train_step(0.5, augment=False)(
        state, torch.from_numpy(xs), torch.from_numpy(ys), None)
    assert float(metrics["loss"]) == pytest.approx(
        float(jax_dice_bce(logits, jnp.asarray(ys), 0.5)), rel=LOSS_RTOL)


@pytest.mark.parametrize("kw,norm", [(KW, "batch"), (DS_KW, "batch"),
                                     (DS_KW, "group"), (KW, "none")],
                         ids=["plain", "ds", "ds-group", "plain-none"])
def test_from_flax_to_flax_round_trip(kw, norm):
    variables = _variables(kw, norm=norm)
    sd = from_flax(variables)
    model = UNetPP(UNetConfig(**kw, norm=norm))
    model.load_state_dict(sd)                      # strict: every key
    back = to_flax(model.state_dict(), norm=norm)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_prune_level_at_depth_is_bitexact():
    """L = depth reproduces the full deep-supervised model exactly, on the
    port, and matches the JAX package's pruned forward."""
    variables = _variables(DS_KW)
    x = _x(4, size=64)
    with torch.no_grad():
        full = _port(DS_KW, variables)(torch.from_numpy(x))
        pruned = _port(DS_KW, variables,
                       prune_level=DS_KW["depth"])(torch.from_numpy(x))
    assert torch.equal(full, pruned)
    want = _jax_apply(DS_KW, variables, x, prune_level=DS_KW["depth"])
    np.testing.assert_allclose(pruned.numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("level", [1, 2])
def test_prune_level_equals_restricted_depth_model(level):
    """Head j reads only nodes X[i][k] with i + k <= j, so the depth-3
    checkpoint pruned at L (the full grid, loaded strictly) equals a
    depth-L UNet++ on the same weights, bit for bit, and the JAX package's
    pruned forward within F32_TOL."""
    variables = _variables(DS_KW)
    x = _x(5, size=64)
    pruned = build_model(UNetConfig(**DS_KW, prune_level=level))
    pruned.load_state_dict(from_flax(variables))   # strict: the full grid
    small = UNetPP(UNetConfig(**{**DS_KW, "depth": level}))
    keys = small.state_dict().keys()
    small.load_state_dict({k: v for k, v in from_flax(variables).items()
                           if k in keys})
    with torch.no_grad():
        got = pruned.eval()(torch.from_numpy(x))
        restricted = small.eval()(torch.from_numpy(x))
    assert torch.equal(got, restricted)
    want = _jax_apply(DS_KW, variables, x, prune_level=level)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_effective_level_and_build_model_validation(tmp_path):
    """tests/test_unetpp.py:139-141, 226-240: the arch is selected and
    checked, deep supervision needs UNet++, a prune level needs deep
    supervision and 1 <= L <= depth, and training a pruned grid is
    refused."""
    from plumekit_torch.train.loop import train

    assert isinstance(build_model(UNetConfig(arch="unet")), UNet)
    assert isinstance(build_model(UNetConfig(arch="unetpp")), UNetPP)
    with pytest.raises(ValueError, match="arch"):
        build_model(UNetConfig(arch="resnet"))
    with pytest.raises(ValueError, match="deep_supervision"):
        build_model(UNetConfig(deep_supervision=True))
    ds = UNetConfig(**DS_KW)
    assert effective_level(ds) == 3
    assert effective_level(dataclasses.replace(ds, prune_level=2)) == 2
    for bad in (dict(prune_level=0), dict(prune_level=4),
                dict(arch="unet", deep_supervision=False, prune_level=2),
                dict(deep_supervision=False, prune_level=2)):
        with pytest.raises(ValueError):
            build_model(dataclasses.replace(ds, **bad))
    with pytest.raises(ValueError, match="serving-only"):
        train(unet_cfg=dataclasses.replace(ds, prune_level=1),
              train_cfg=TrainConfig(total_steps=1,
                                    checkpoint_dir=str(tmp_path / "c")),
              device="cpu")


def test_model_config_record_and_resume_mismatch_refusal(tmp_path):
    """tests/test_unetpp.py:97-136: the loop records the UNet++ config and
    rebuilds it; resuming the directory with another config is refused
    before the record is overwritten."""
    from plumekit_torch.train.checkpoint import load_model_config
    from plumekit_torch.train.loop import train

    ck = str(tmp_path / "ckpt")
    cfg = UNetConfig(**KW)
    kwargs = dict(
        train_cfg=TrainConfig(total_steps=2, batch_size=2, tile_size=32,
                              log_every=0, eval_every=0, checkpoint_dir=ck,
                              checkpoint_every=2),
        data_cfg=DataConfig(granule_size=64, n_train_granules=1,
                            n_eval_granules=1), device="cpu")
    train(unet_cfg=cfg, **kwargs)
    assert load_model_config(ck) == cfg
    assert load_model_config(str(tmp_path / "nope")) is None
    with pytest.raises(ValueError, match="matching config"):
        train(unet_cfg=UNetConfig(in_channels=2, base_features=8, depth=2,
                                  compute_dtype="float32"), **kwargs)
    with open(os.path.join(ck, "model_config.json")) as f:
        record = json.load(f)
    assert record["arch"] == "unetpp"                  # untouched


def test_bf16_nodes_stay_channels_last():
    """Every node of the bf16 forward, the dense concats' convs included,
    keeps the channels-last layout (a concat that lost it would make cuDNN
    transpose every node)."""
    cfg = UNetConfig(**{**DS_KW, "compute_dtype": "bfloat16"})
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    seen = {}

    def hook(name):
        def record(_module, args, out):
            seen[name] = (args[0].is_contiguous(
                memory_format=torch.channels_last), out.is_contiguous(
                memory_format=torch.channels_last), out.dtype)
        return record

    for name, node in model.nodes.items():
        node.register_forward_hook(hook(name))
    with torch.no_grad():
        out = model(torch.from_numpy(_x(6)))
    assert out.dtype == torch.float32
    assert len(seen) == 10
    assert all(v == (True, True, torch.bfloat16) for v in seen.values()), seen


def test_cli_chain_train_and_serve_unetpp(tmp_path, caplog):
    """tests/test_unetpp.py:155-190, 243-270 on the port: make_dataset →
    train_model --arch unetpp --deep-supervision → predict_model plain,
    --int8 and --prune-level 1, all on the CPU; an out-of-range level and
    --fused exit 1."""
    import logging

    from plumekit_torch.train.checkpoint import load_model_config

    root = str(tmp_path)
    dev = ["--root", root, "--device", "cpu"]
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64"]) == 0
    assert cli.main(["train_model", *dev, "--steps", "2", "--batch-size",
                     "2", "--tile", "32", "--granule-size", "64", "--arch",
                     "unetpp", "--deep-supervision"]) == 0
    recorded = load_model_config(os.path.join(root, "models", "checkpoints"))
    assert recorded == UNetConfig(arch="unetpp", deep_supervision=True)
    out = os.path.join(root, "processed", "predictions")
    serve = [*dev, "--tile", "32", "--overlap", "8"]
    probs = {}
    for label, flags in (("plain", []), ("int8", ["--int8"]),
                         ("pruned", ["--prune-level", "1"])):
        assert cli.main(["predict_model", *serve, *flags]) == 0
        with np.load(os.path.join(out, "SYNTH.00000000_pred.npz")) as d:
            probs[label] = d["probs"]
        assert probs[label].shape == (64, 64)
        assert np.isfinite(probs[label]).all()
    assert not np.array_equal(probs["pruned"], probs["plain"])
    with caplog.at_level(logging.ERROR):
        assert cli.main(["predict_model", *serve, "--prune-level", "7"]) == 1
        assert "--prune-level" in caplog.text
        assert cli.main(["predict_model", *serve, "--fused"]) == 1
        assert "unet architecture only" in caplog.text
