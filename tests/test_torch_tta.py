"""plumekit_torch.infer.tta against plumekit.infer.tta.make_tta_apply on the
same numpy inputs (``tests/test_tta.py`` for the JAX package): exact on an
equivariant apply, the mean probability over the 8 views, non-square tiles
refused, through sliding inference on carried weights, and ``predict_model
--tta`` against the JAX CLI's; with ``--fused``, ``--int8`` and a
``use_mega`` checkpoint each forward runs once at 8× the batch."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.cli import main as jax_main
from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer.sliding import make_sliding_infer as jax_sliding_infer
from plumekit.infer.tta import make_tta_apply as jax_tta_apply
from plumekit.models import UNet as JaxUNet
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.infer.sliding import make_multi_granule_infer
from plumekit_torch.infer.tta import make_tta_apply
from plumekit_torch.models import UNet, build_model
from plumekit_torch.train.checkpoint import save_model_config, save_weights
from test_torch_cli import SERVE, _predictions, _root

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
PROB_TOL = 1e-4     # fp32 forwards and stitching, sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rot90_turns_as_jax_rot90():
    x = np.arange(2 * 3 * 3 * 2, dtype=np.float32).reshape(2, 3, 3, 2)
    for k in (-3, -1, 1, 2, 3):
        np.testing.assert_array_equal(
            torch.rot90(torch.from_numpy(x), k, dims=(1, 2)).numpy(),
            np.asarray(jnp.rot90(jnp.asarray(x), k=k, axes=(1, 2))))


def test_tta_is_exact_on_an_equivariant_apply():
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 2)).astype(
        np.float32)
    out = make_tta_apply(lambda v, t: t[..., :1])({}, torch.from_numpy(x))
    assert out.shape == (3, 16, 16, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), x[..., :1], rtol=0, atol=1e-5)


def test_tta_is_the_mean_probability_over_the_views_as_in_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, 1)).astype(np.float32)
    x = rng.normal(size=(2, 12, 12, 2)).astype(np.float32)

    def apply_port(v, t):
        # orientation-sensitive: a channel map plus a row ramp
        ramp = torch.arange(t.shape[1], dtype=torch.float32)[None, :, None,
                                                             None]
        return t @ v + 0.1 * ramp

    def apply_jax(v, t, train=False):
        ramp = jnp.arange(t.shape[1], dtype=jnp.float32)[None, :, None, None]
        return t @ v["w"] + 0.1 * ramp

    got = torch.sigmoid(make_tta_apply(apply_port)(
        torch.from_numpy(w), torch.from_numpy(x))).numpy()
    want = np.asarray(jax.nn.sigmoid(jax_tta_apply(apply_jax)(
        {"w": jnp.asarray(w)}, jnp.asarray(x))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    views = []
    for f in (False, True):
        for k in range(4):
            v = np.flip(x, axis=2) if f else x
            y = apply_jax({"w": w}, jnp.asarray(np.rot90(v, k, axes=(1, 2))))
            y = np.rot90(np.asarray(y), -k, axes=(1, 2))
            views.append(1 / (1 + np.exp(-(np.flip(y, axis=2) if f else y))))
    np.testing.assert_allclose(got, np.mean(views, axis=0), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 16, 8, 2), (16, 16, 2)])
def test_tta_refuses_non_square_tiles(shape):
    with pytest.raises(ValueError, match="square"):
        make_tta_apply(lambda v, t: t[..., :1])({}, torch.zeros(shape))


def test_tta_through_sliding_inference_matches_jax():
    jax_model = JaxUNet(JaxUNetConfig(**KW))
    variables = jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 2)), train=False)
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    icfg = dict(tile_size=32, overlap=8, batch_tiles=4)
    image = np.random.default_rng(2).random((64, 64, 2), np.float32)
    want, _ = jax_sliding_infer(jax_tta_apply(jax_model.apply),
                                JaxInferConfig(**icfg), channels=2)(
        variables, jnp.asarray(image))
    infer = make_multi_granule_infer(make_tta_apply(lambda m, t: m(t)),
                                     InferConfig(**icfg))
    plain = make_multi_granule_infer(lambda m, t: m(t), InferConfig(**icfg))
    with torch.inference_mode():
        got, _ = infer(model.eval(), torch.from_numpy(image)[None])
        ref, _ = plain(model, torch.from_numpy(image)[None])
    got = got[0].numpy()
    assert got.shape == (64, 64) and np.isfinite(got).all()
    assert (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=PROB_TOL, rtol=0)
    # an untrained net is not D4-equivariant
    assert not np.allclose(got, ref[0].numpy())


def _carried_weights(ckpt):
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})))
    save_weights(ckpt, model)


def test_predict_model_tta_matches_jax_cli(tmp_path):
    """Both CLIs serve the JAX trainer's initial weights with ``--tta``."""
    root, ckpt = _root(tmp_path)
    assert jax_main(["predict_model", "--root", root, "--tta"] + SERVE) == 0
    want = _predictions(root)
    _carried_weights(ckpt)
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--tta"] + SERVE) == 0
    got = _predictions(root)
    assert sorted(got) == sorted(want) == ["g0_pred.npz", "g1_pred.npz"]
    for f in got:
        p, q = got[f]["probs"], want[f]["probs"]
        assert p.shape == q.shape == (64, 64) and p.dtype == np.float32
        np.testing.assert_allclose(p, q, atol=PROB_TOL, rtol=0)
        sure = np.abs(q - 0.5) > PROB_TOL
        np.testing.assert_array_equal(got[f]["mask"][sure],
                                      want[f]["mask"][sure])


def test_tta_wraps_the_fused_int8_and_megakernel_forwards(tmp_path,
                                                          monkeypatch):
    """Each forward's plain version runs once per tile batch at 8× its
    tiles: K6's per block, Q1's per conv and K7's per forward."""
    from plumekit_torch.models import fused_forward
    from plumekit_torch.models.kernels import int8_conv, unet_mega

    root, ckpt = _root(tmp_path)
    _carried_weights(ckpt)
    batches = []

    def spy(module, name):
        real = getattr(module, name)

        def counted(*args, **kw):
            batches.append((name, next(a.shape[0] for a in args
                                       if isinstance(a, torch.Tensor)
                                       and a.ndim == 4)))
            return real(*args, **kw)

        monkeypatch.setattr(module, name, counted)

    spy(fused_forward, "_double_conv")
    spy(int8_conv, "int8_conv3x3_ref")
    spy(unet_mega, "mega_forward_ref")
    # 64² granules at tile 32, overlap 8: 9 tiles each, 3 per granule and
    # forward; 8 views × 2 granules per group × 3 tiles
    tiles = 8 * 2 * 3
    for flags, name, per_forward in (
            (["--fused"], "_double_conv", 2 * KW["depth"] + 1),
            (["--int8"], "int8_conv3x3_ref", 2 * (2 * KW["depth"] + 1)),
            (["--checkpoint", "mega"], "mega_forward_ref", 1)):
        if flags[0] == "--checkpoint":
            mega = os.path.join(tmp_path, "mega")
            save_model_config(mega, UNetConfig(**KW, use_mega=True))
            _carried_weights(mega)
            flags = ["--checkpoint", mega]
        batches.clear()
        assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                         "--tta"] + SERVE + flags) == 0
        served = [n for n, b in batches if n == name and b == tiles]
        assert len(served) == 3 * per_forward, (name, batches[:3])
        for pred in _predictions(root).values():
            assert np.isfinite(pred["probs"]).all()
