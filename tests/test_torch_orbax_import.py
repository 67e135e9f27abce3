"""``tools/orbax_to_torch.py``, the orbax checkpoint import: the JAX
trainer's state at a tiny config (base 8, depth 2, fp32), two train steps
in, so that the batch statistics are not their initial values, saved by
``plumekit.train.checkpoint.save_checkpoint``, converted by the tool, for
the U-Net and the UNet++. The port's forward on the converted weights is
within 1e-4 of the JAX apply of the restored state, and ``predict_model
--device cpu`` on the converted directory within 1e-4 of the JAX
``predict_model`` on the orbax directory, on a 64² granule."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import build_model as jax_build_model
from plumekit.train.checkpoint import save_checkpoint as jax_save_checkpoint
from plumekit.train.checkpoint import \
    save_model_config as jax_save_model_config
from plumekit.train.state import create_state as jax_create_state
from plumekit.train.step import make_train_step as jax_make_train_step
from plumekit_torch import cli
from plumekit_torch.models import build_model
from plumekit_torch.train.checkpoint import (WEIGHTS_BASENAME,
                                             load_model_config, load_weights)

from test_torch_cli import SERVE, _granule, _predictions
from plumekit_torch.io import granule as torch_granule

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "orbax_to_torch.py")
KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
TCFG = dict(batch_size=2, tile_size=32, learning_rate=1e-3, warmup_steps=1,
            total_steps=4, augment=False)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _trained_jax_root(tmp_path, arch):
    """A root whose checkpoint directory the JAX trainer wrote: the
    model config, an orbax step 1 and step 2 (two train steps)."""
    cfg = JaxUNetConfig(**KW, arch=arch)
    state = jax_create_state(jax.random.PRNGKey(0), cfg,
                             JaxTrainConfig(**TCFG))
    step = jax_make_train_step(0.5, augment=False)
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    torch_granule.save_granule(os.path.join(maiac, "g0.npz"),
                               _granule(5, "g0"))
    ckpt = os.path.join(root, "models", "checkpoints")
    jax_save_model_config(ckpt, cfg)
    rng = np.random.default_rng(0)
    for i in range(2):
        xs = jnp.asarray(rng.normal(size=(2, 32, 32, 2)).astype(np.float32))
        ys = jnp.asarray((rng.random((2, 32, 32, 1)) < 0.3).astype(
            np.float32))
        state, _ = step(state, xs, ys, jax.random.PRNGKey(i))
        jax_save_checkpoint(ckpt, state, i + 1)
    return root, ckpt, cfg, state


@pytest.mark.parametrize("arch", ["unet", "unetpp"])
def test_converted_checkpoint_serves_as_the_jax_one(tmp_path, tool, arch):
    root, ckpt, cfg, state = _trained_jax_root(tmp_path, arch)
    before = sorted(os.listdir(ckpt))
    out = str(tmp_path / "converted")
    assert tool.main([ckpt, out]) == 0
    assert sorted(os.listdir(ckpt)) == before      # nothing written there
    assert sorted(os.listdir(out)) == ["model_config.json", WEIGHTS_BASENAME]
    assert load_model_config(out).arch == arch
    stats = jax.tree.leaves(state.batch_stats)
    assert any(np.abs(np.asarray(s)).max() > 1e-3 for s in stats)

    model = build_model(load_model_config(out))
    assert load_weights(out, model)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 2)).astype(
        np.float32)
    want = np.asarray(jax_build_model(cfg).apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    jax_root = str(tmp_path / "jax_root")
    shutil.copytree(root, jax_root)
    assert jax_main(["predict_model", "--root", jax_root] + SERVE) == 0
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--checkpoint", out] + SERVE) == 0
    got, want = _predictions(root), _predictions(jax_root)
    assert sorted(got) == sorted(want) == ["g0_pred.npz"]
    np.testing.assert_allclose(got["g0_pred.npz"]["probs"],
                               want["g0_pred.npz"]["probs"], rtol=0, atol=TOL)


def test_an_earlier_step_and_the_refusals(tmp_path, tool, capsys):
    """``--step 1`` converts the first step (other weights than the
    latest); a step that is not there, a directory without orbax steps and
    ``OUT_DIR == CKPT_DIR`` exit 1; the help says what is not carried."""
    _root, ckpt, _cfg, _state = _trained_jax_root(tmp_path, "unet")
    latest, first = str(tmp_path / "latest"), str(tmp_path / "first")
    assert tool.main([ckpt, latest]) == 0
    assert tool.main([ckpt, first, "--step", "1"]) == 0
    a = torch.load(os.path.join(latest, WEIGHTS_BASENAME))
    b = torch.load(os.path.join(first, WEIGHTS_BASENAME))
    assert any(not torch.equal(a[k], b[k]) for k in a)
    capsys.readouterr()
    for argv in ([ckpt, str(tmp_path / "x"), "--step", "7"],
                 [str(tmp_path / "first"), str(tmp_path / "y")],
                 [ckpt, ckpt]):
        assert tool.main(argv) == 1
    assert capsys.readouterr().err.count("orbax_to_torch:") == 3
    with pytest.raises(SystemExit):
        tool.main(["--help"])
    assert "optimizer state is not carried" in " ".join(
        capsys.readouterr().out.split())
