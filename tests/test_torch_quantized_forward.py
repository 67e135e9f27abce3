"""plumekit_torch's int8 forward (``models/quantized_forward.py``) against
the JAX package's (``plumekit/models/quantized_forward.py``) on the same
numpy inputs and the same weights, carried over by ``convert.from_flax``
(and the JAX quantized state by ``convert.qvars_from_flax``): the pieces,
the calibration and the quantization, the apply; then the JAX file's own
contracts (``tests/test_quantized_forward.py``) held on the port. On the
CPU every 3×3 conv runs Q1's plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import UNet as JaxUNet
from plumekit.models import quantized_forward as jq
from plumekit_torch.config import InferConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax, qvars_from_flax
from plumekit_torch.infer import make_multi_granule_infer
from plumekit_torch.models import UNet, build_model
from plumekit_torch.models import quantized_forward as tq

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
CFG = UNetConfig(**KW)
# the JAX quantized state through the port's apply: the same int8 planes
# but where XLA's CPU contracts acc·a + b into an FMA and a quotient lands
# on the other side of a rounding boundary (a tiny share), which the convs
# after it carry to the logits
APPLY_RTOL, APPLY_MIN_CORR = 1e-3, 0.99999
SCALE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(seed=0):
    """flax U-Net variables with nontrivial running statistics (as the JAX
    test's ``_init_variables``), as numpy."""
    x = jnp.zeros((2, 32, 32, 2), jnp.float32)
    v = JaxUNet(JaxUNetConfig(**KW)).init(jax.random.PRNGKey(seed), x,
                                          train=False)
    v = jax.tree.map(lambda a: a + 0.03 * jnp.arange(a.size, dtype=a.dtype)
                     .reshape(a.shape) if a.ndim == 1 else a, v)
    return jax.tree.map(np.asarray, v)


def _port(variables):
    model = UNet(CFG)
    model.load_state_dict(from_flax(variables))
    return model.eval()


def _numpy_qvars(qvars):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), qvars,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def carried():
    """JAX variables, the port's model of them, a calibration batch, and
    each package's quantized state."""
    variables = _variables()
    rng = np.random.default_rng(1)
    calib = rng.random((4, 32, 32, 2), np.float32)
    model = _port(variables)
    return {"variables": variables, "model": model, "calib": calib,
            "jax": _numpy_qvars(jq.quantize_unet(
                variables, JaxUNetConfig(**KW), jnp.asarray(calib))),
            "port": tq.quantize_unet(model, CFG, calib)}


# ------------------------------------------------------------- the pieces

def test_quant_act_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 19, 5)) * 4).astype(np.float32)
    s = np.float32(3.7 / 127)
    want = np.asarray(jq._quant_act(jnp.asarray(x), s))
    got = tq._quant_act(torch.from_numpy(x), torch.tensor(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_quant_weight_matches_jax():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((3, 3, 24, 16)) * 0.2).astype(np.float32)
    s_in = rng.uniform(0.001, 0.05, 24).astype(np.float32)
    wq_j, sw_j = jq._quant_weight(jnp.asarray(w), jnp.asarray(s_in))
    wq_t, sw_t = tq._quant_weight(torch.from_numpy(w), torch.from_numpy(s_in))
    np.testing.assert_allclose(sw_t.numpy(), np.asarray(sw_j),
                               rtol=SCALE_RTOL)
    d = np.abs(wq_t.numpy().astype(int) - np.asarray(wq_j).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_max_pool2_q_matches_jax():
    x = np.random.default_rng(2).integers(-127, 128, (2, 8, 6, 3),
                                          dtype=np.int8)
    np.testing.assert_array_equal(
        tq._max_pool2_q(torch.from_numpy(x)).numpy(),
        np.asarray(jq._max_pool2_q(jnp.asarray(x))))


def test_upsample_q_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 128, (2, 5, 6, 16), dtype=np.int8)
    k = rng.integers(-127, 128, (2, 2, 16, 8), dtype=np.int8)
    sw = rng.uniform(1e-4, 1e-3, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    want = np.asarray(jq._upsample_q(*[jnp.asarray(a)
                                       for a in (x, k, sw, bias)]))
    got = tq._upsample_q(*[torch.from_numpy(a) for a in (x, k, sw, bias)])
    assert got.shape == want.shape == (2, 10, 12, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_folded_block_matches_jax(carried):
    v = carried["variables"]
    want = jq._folded_block(v["params"]["DoubleConv_3"],
                            v["batch_stats"]["DoubleConv_3"])
    got = tq._folded_block(carried["model"].blocks[3])
    for w_pair, g_pair in zip(want, got):
        for a, b in zip(w_pair, g_pair):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------- calibration and quantization

def test_calibrate_unet_matches_jax(carried):
    want = jq.calibrate_unet(carried["variables"], JaxUNetConfig(**KW),
                             jnp.asarray(carried["calib"]))
    got = tq.calibrate_unet(carried["model"], CFG, carried["calib"])
    assert sorted(got) == sorted(want)
    assert "b4_out" not in got and {"b0_out", "b1_out", "up0"} <= set(got)
    for k in want:
        assert got[k].shape == () and got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=SCALE_RTOL)


def test_quantize_unet_matches_jax(carried):
    """Scales within rtol 1e-5; int8 weights equal in at least 99.9% of
    their elements and never more than one step apart."""
    want, got = carried["jax"], carried["port"]
    np.testing.assert_allclose(float(got["s_in"]), want["s_in"],
                               rtol=SCALE_RTOL)
    pairs = [(g, w) for g, w in zip(got["blocks"], want["blocks"])]
    pairs += [(g, w) for g, w in zip(got["ups"], want["ups"])]
    pairs += [(got["head"], want["head"])]
    n_equal = n_total = 0
    for g, w in pairs:
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k] is None:
                assert g[k] is None
                continue
            a, b = np.asarray(w[k]), g[k].numpy()
            assert a.shape == b.shape, k
            if a.dtype == np.int8:
                assert b.dtype == np.int8
                d = np.abs(a.astype(int) - b.astype(int))
                assert d.max() <= 1, k
                n_equal += int((d == 0).sum())
                n_total += d.size
            else:
                np.testing.assert_allclose(b, a, rtol=SCALE_RTOL,
                                           atol=SCALE_RTOL * np.abs(a).max())
    assert n_equal >= 0.999 * n_total


def test_qvars_from_flax_carries_every_leaf(carried):
    want = carried["jax"]
    got = qvars_from_flax(want)
    assert float(got["s_in"]) == float(want["s_in"])
    assert len(got["blocks"]) == len(want["blocks"]) == 2 * CFG.depth + 1
    assert got["blocks"][-1]["s_out"] is None
    for g, w in zip(got["blocks"] + got["ups"], want["blocks"] + want["ups"]):
        for k, v in w.items():
            if v is not None:
                assert g[k].dtype == (torch.int8 if v.dtype == np.int8
                                      else torch.float32)
                np.testing.assert_array_equal(g[k].numpy(), v)
    with pytest.raises(ValueError, match="A.13"):
        qvars_from_flax({"s_in": 1.0, "blocks": {}, "ups": {}, "heads": {}})


# ---------------------------------------------------------------- the apply

def _compare(got, want, rtol, min_corr):
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    assert np.corrcoef(got, want)[0, 1] > min_corr


def test_apply_on_carried_jax_qvars_matches_jax(carried):
    x = np.random.default_rng(4).random((2, 32, 32, 2), np.float32)
    want = jq.make_quantized_apply(JaxUNetConfig(**KW))(
        jax.tree.map(jnp.asarray, carried["jax"]), jnp.asarray(x))
    got = tq.make_quantized_apply(CFG)(qvars_from_flax(carried["jax"]),
                                       torch.from_numpy(x))
    assert got.shape == want.shape == (2, 32, 32, 1)
    _compare(got, want, APPLY_RTOL, APPLY_MIN_CORR)


def test_apply_on_its_own_qvars_matches_jax(carried):
    x = np.random.default_rng(5).random((2, 32, 32, 2), np.float32)
    want = jq.make_quantized_apply(JaxUNetConfig(**KW))(
        jax.tree.map(jnp.asarray, carried["jax"]), jnp.asarray(x))
    got = tq.make_quantized_apply(CFG)(carried["port"], torch.from_numpy(x))
    _compare(got, want, APPLY_RTOL, APPLY_MIN_CORR)


def test_apply_keeps_every_int8_plane_in_its_debug_form(carried):
    x = torch.from_numpy(np.random.default_rng(6).random((1, 32, 32, 2),
                                                         np.float32))
    apply = tq.make_quantized_apply(CFG)
    planes = []
    got = apply(carried["port"], x, planes=planes)
    assert torch.equal(got, apply(carried["port"], x))
    # input; per encoder block mid, out, pool; bottleneck mid, out; per
    # decoder block up, mid, out (but the last block's fp32 out)
    depth = CFG.depth
    assert len(planes) == 1 + 3 * depth + 2 + 3 * depth - 1
    assert all(p.dtype == torch.int8 for p in planes)


# ------------------------------------ the JAX file's contracts, on the port

def test_quantized_logits_track_fp32(carried):
    """tests/test_quantized_forward.py:57-70: correlation > 0.99, max|Δ| <
    0.15 of the fp32 logits' span."""
    rng = np.random.default_rng(1)
    rng.random((4, 32, 32, 2), np.float32)
    x = torch.from_numpy(rng.random((2, 32, 32, 2), np.float32))
    with torch.no_grad():
        ref = carried["model"](x).numpy().ravel()
    got = tq.make_quantized_apply(CFG)(carried["port"], x).numpy().ravel()
    assert np.corrcoef(got, ref)[0, 1] > 0.99
    assert np.abs(got - ref).max() < 0.15 * (ref.max() - ref.min())


def _jax_trained(steps=40):
    """The JAX test's ``_trained_variables``: the flax U-Net quickly fit
    to mask = channel0 > 0.5 (40 steps, batch 4 × 32², lr 3e-3), so that
    its logits are decisive; as numpy."""
    from plumekit.config.train import TrainConfig as JaxTrainConfig
    from plumekit.train import create_state, make_train_step

    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         JaxTrainConfig(batch_size=4, tile_size=32,
                                        warmup_steps=5, learning_rate=3e-3))
    step = make_train_step(dice_weight=0.5, augment=False)
    rng = np.random.default_rng(0)
    xs = rng.random((4, 32, 32, 2)).astype(np.float32)
    ys = (xs[..., :1] > 0.5).astype(np.float32)
    for i in range(steps):
        state, metrics = step(state, jnp.asarray(xs), jnp.asarray(ys),
                              jax.random.PRNGKey(i))
    assert float(metrics["iou"]) > 0.6
    return (jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats}),
            xs, ys)


@pytest.fixture(scope="module")
def trained():
    """The JAX test's trained weights, carried over to the port."""
    variables, xs, ys = _jax_trained()
    return _port(variables), xs, ys


def test_quantized_mask_parity_on_trained_model(trained):
    """tests/test_quantized_forward.py:73-91: mask flips < 5e-3, task IoU
    within 0.01 of fp32's."""
    model, xs, ys = trained
    x = torch.from_numpy(xs)
    with torch.no_grad():
        ref_mask = model(x).numpy() > 0.0
    qvars = tq.quantize_unet(model, CFG, xs)
    q_mask = tq.make_quantized_apply(CFG)(qvars, x).numpy() > 0.0
    assert (ref_mask != q_mask).mean() < 5e-3

    def task_iou(mask):
        gt = ys[..., 0] > 0.5
        m = mask[..., 0]
        return (m & gt).sum() / max(1, (m | gt).sum())

    assert task_iou(q_mask) >= task_iou(ref_mask) - 0.01


def test_quantized_apply_under_sliding_infer(trained):
    """tests/test_quantized_forward.py:112-132: the int8 forward as the
    sliding inference's apply_fn, stitched masks within 1e-2 flips of the
    fp32 pipeline's."""
    model, _xs, _ys = trained
    image = np.random.default_rng(3).random((96, 96, 2)).astype(np.float32)
    icfg = InferConfig(tile_size=32, overlap=8, batch_tiles=4)
    ref_infer = make_multi_granule_infer(lambda m, t: m(t), icfg, channels=2)
    ref_probs, ref_mask = ref_infer(model, torch.from_numpy(image)[None])
    qvars = tq.quantize_unet(model, CFG, image[None, :32, :32, :])
    q_infer = make_multi_granule_infer(tq.make_quantized_apply(CFG), icfg,
                                       channels=2)
    q_probs, q_mask = q_infer(qvars, torch.from_numpy(image)[None])
    assert q_probs.shape == ref_probs.shape == (1, 96, 96)
    assert (ref_mask != q_mask).float().mean() < 1e-2


def test_quantized_guards(carried):
    """tests/test_quantized_forward.py:326-335, and UNet++ named as not
    ported."""
    with pytest.raises(ValueError, match="arch"):
        tq.make_quantized_apply(UNetConfig(arch="nonsense"))
    with pytest.raises(ValueError, match="batch"):
        tq.make_quantized_apply(UNetConfig(norm="group"))
    with pytest.raises(ValueError, match="A.13"):
        tq.make_quantized_apply(UNetConfig(arch="unetpp"))
    with pytest.raises(ValueError, match="A.13"):
        tq.quantize_unet(build_model(CFG), UNetConfig(**KW, prune_level=1),
                         np.zeros((1, 32, 32, 2), np.float32))
    calib = np.zeros((1, 32, 32, 2), np.float32)
    qvars = tq.quantize_unet(carried["model"], CFG, calib)
    with pytest.raises(ValueError, match="inference-only"):
        tq.make_quantized_apply(CFG)(qvars, torch.from_numpy(calib),
                                     train=True)


def test_port_trained_flips_equal_jax_int8_flips():
    """Trained by the port's own step instead (same recipe, the port's
    initial weights), the model is less decisive and int8 flips about 1% of
    its masks; the JAX package's int8 forward on the same weights flips the
    same pixels, so the share is the weights', not the port's."""
    from plumekit_torch.convert import to_flax
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_train_step

    state = create_state(CFG, TrainConfig(batch_size=4, tile_size=32,
                                          warmup_steps=5, learning_rate=3e-3),
                         "cpu")
    step = make_train_step(dice_weight=0.5, augment=False)
    rng = np.random.default_rng(0)
    xs = rng.random((4, 32, 32, 2)).astype(np.float32)
    ys = (xs[..., :1] > 0.5).astype(np.float32)
    for _ in range(40):
        state, _m = step(state, torch.from_numpy(xs), torch.from_numpy(ys),
                         None)
    model = state.model.eval()
    x = torch.from_numpy(xs)
    with torch.no_grad():
        ref = model(x).numpy() > 0.0
    port = tq.make_quantized_apply(CFG)(tq.quantize_unet(model, CFG, xs),
                                        x).numpy() > 0.0
    variables = jax.tree.map(jnp.asarray, to_flax(model.state_dict()))
    jcfg = JaxUNetConfig(**KW)
    jax_ref = np.asarray(JaxUNet(jcfg).apply(variables, jnp.asarray(xs),
                                             train=False)) > 0.0
    jax_q = np.asarray(jq.make_quantized_apply(jcfg)(
        jq.quantize_unet(variables, jcfg, jnp.asarray(xs)),
        jnp.asarray(xs))) > 0.0
    assert np.array_equal(ref, jax_ref)
    assert (port != jax_q).sum() <= 2
    assert abs(int((port != ref).sum()) - int((jax_q != jax_ref).sum())) <= 2
