"""plumekit_torch's int8 forward (``models/quantized_forward.py``) against
the JAX package's (``plumekit/models/quantized_forward.py``) on the same
numpy inputs and the same weights, carried over by ``convert.from_flax``
(and the JAX quantized state by ``convert.qvars_from_flax``): the pieces,
the calibration and the quantization, the apply; then the JAX file's own
contracts (``tests/test_quantized_forward.py``) held on the port. On the
CPU every 3×3 conv runs Q1's plain version."""

import dataclasses

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
from plumekit_torch.models import UNet, build_model, effective_level
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


def _leaves(tree, path=()):
    """(path, leaf) of a quantized state, dicts and lists walked."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_qvars_close(got, want):
    """The same structure; the input scale ``s_in`` within SCALE_RTOL, the
    other scales and fp32 vectors within SCALE_RTOL with an absolute floor
    of SCALE_RTOL times their largest magnitude; int8 weights equal in at
    least 99.9% of their elements and never more than one step apart."""
    flat_w, flat_g = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(flat_g, key=str) == sorted(flat_w, key=str)
    n_equal = n_total = 0
    for k, w in flat_w.items():
        g = flat_g[k]
        if w is None:
            assert g is None, k
            continue
        a, b = np.asarray(w), g.numpy()
        assert a.shape == b.shape, k
        if a.dtype == np.int8:
            assert b.dtype == np.int8
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1, k
            n_equal += int((d == 0).sum())
            n_total += d.size
        elif k == ("s_in",):
            np.testing.assert_allclose(b, a, rtol=SCALE_RTOL)
        else:
            np.testing.assert_allclose(b, a, rtol=SCALE_RTOL,
                                       atol=SCALE_RTOL * np.abs(a).max(),
                                       err_msg=str(k))
    assert n_equal >= 0.999 * n_total


def test_quantize_unet_matches_jax(carried):
    """Scales within rtol 1e-5; int8 weights equal in at least 99.9% of
    their elements and never more than one step apart."""
    _assert_qvars_close(carried["port"], carried["jax"])


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
    # the UNet++ structure (dicts of blocks, ups and heads) carries too
    pp = qvars_from_flax({"s_in": np.float32(0.5), "blocks": {}, "ups": {},
                          "heads": {"head": {"bias": np.ones(1)}}})
    assert float(pp["s_in"]) == 0.5 and pp["blocks"] == pp["ups"] == {}
    assert pp["heads"]["head"]["bias"].dtype == torch.float32


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
    """tests/test_quantized_forward.py:326-335: the arch and norm checks,
    UNet++ taken, and a prune level checked as the JAX package checks
    it."""
    with pytest.raises(ValueError, match="arch"):
        tq.make_quantized_apply(UNetConfig(arch="nonsense"))
    with pytest.raises(ValueError, match="batch"):
        tq.make_quantized_apply(UNetConfig(norm="group"))
    assert callable(tq.make_quantized_apply(UNetConfig(arch="unetpp")))
    with pytest.raises(ValueError, match="serving-time mode"):
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


# ------------------------------------------------------------------ UNet++
# plumekit/models/quantized_forward.py:391-557 against the port's UNet++
# half (tests/test_quantized_forward.py:279-437 at the JAX side): base 8,
# depth 3, with and without deep supervision, and pruned at 1 and 2. The
# weights come from the port's seeded init carried to flax by to_flax (a
# flax init of the grid costs 15-40 s on the CPU); the JAX package's
# quantization and apply run under jit.

PP_KW = dict(in_channels=2, base_features=8, depth=3,
             compute_dtype="float32", arch="unetpp")
PP_CASES = {"plain": (False, None), "ds": (True, None), "ds-L1": (True, 1),
            "ds-L2": (True, 2)}


def _pp_cfgs(case):
    ds, level = PP_CASES[case]
    kw = dict(PP_KW, deep_supervision=ds, prune_level=level)
    return UNetConfig(**kw), JaxUNetConfig(**kw)


def _pp_model(ds):
    from plumekit_torch.convert import to_flax

    cfg = UNetConfig(**PP_KW, deep_supervision=ds)
    model = build_model(cfg, torch.Generator().manual_seed(2))
    v = jax.tree.map(lambda a: a + 0.03 * np.arange(a.size, dtype=a.dtype)
                     .reshape(a.shape) if a.ndim == 1 else a,
                     to_flax(model.state_dict()))
    model.load_state_dict(from_flax(v))
    return model.eval(), v


@pytest.fixture(scope="module")
def pp_carried():
    """Per case: the port's model, the flax variables of the same weights,
    a calibration batch, and each package's quantized state (built once,
    on first use)."""
    models = {ds: _pp_model(ds) for ds in (False, True)}
    calib = np.random.default_rng(8).random((4, 32, 32, 2), np.float32)
    quantize = jax.jit(jq.quantize_unet, static_argnums=1)
    cache = {}

    def get(case):
        if case not in cache:
            cfg, jcfg = _pp_cfgs(case)
            model, v = models[cfg.deep_supervision]
            cache[case] = {
                "cfg": cfg, "jcfg": jcfg, "model": model, "variables": v,
                "jax": _numpy_qvars(quantize(v, jcfg, jnp.asarray(calib))),
                "port": tq.quantize_unet(model, cfg, calib)}
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(PP_CASES))
def test_unetpp_quantize_matches_jax(pp_carried, case):
    """Scales within SCALE_RTOL, int8 weights as the U-Net case holds
    them; every concat participant at its own scale, X[0][L] head-only."""
    c = pp_carried(case)
    got, level = c["port"], effective_level(c["cfg"])
    _assert_qvars_close(got, c["jax"])
    nodes = [f"x{i}_{j}" for j in range(level + 1)
             for i in range(level + 1 - j)]
    assert sorted(got["blocks"]) == sorted(nodes)
    assert len(got["ups"]) == level * (level + 1) // 2
    assert [k for k, b in got["blocks"].items() if b["s_out"] is None] \
        == [f"x0_{level}"]
    assert sorted(got["heads"]) == (
        [f"head_{j}" for j in range(1, level + 1)]
        if c["cfg"].deep_supervision else ["head"])
    # X[0][2]'s first conv reads X[0][0], X[0][1] and up0_2, each at its
    # own scale folded into its weight rows
    if level >= 2:
        wq1 = got["blocks"]["x0_2"]["wq1"]
        assert wq1.shape == (3, 3, 3 * 8, 8)


@pytest.mark.parametrize("case", list(PP_CASES))
def test_unetpp_qvars_from_flax_carries_every_leaf(pp_carried, case):
    want = pp_carried(case)["jax"]
    got = qvars_from_flax(want)
    flat_w, flat_g = dict(_leaves(want)), dict(_leaves(got))
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        if w is None:
            assert flat_g[k] is None
            continue
        assert flat_g[k].dtype == (torch.int8 if w.dtype == np.int8
                                   else torch.float32)
        np.testing.assert_array_equal(flat_g[k].numpy(), w)


@pytest.mark.parametrize("case", list(PP_CASES))
def test_unetpp_apply_matches_jax(pp_carried, case):
    """The port's apply on the carried JAX state against the JAX package's
    ``make_quantized_apply``, under the file's ``_compare``; Q1 twice per
    node, Q2 once per upsample."""
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    c = pp_carried(case)
    x = np.random.default_rng(9).random((2, 32, 32, 2), np.float32)
    want = np.asarray(jax.jit(jq.make_quantized_apply(c["jcfg"]))(
        jax.tree.map(jnp.asarray, c["jax"]), jnp.asarray(x)))
    apply = tq.make_quantized_apply(c["cfg"])
    calls = {"q1": 0, "q2": 0}
    real_conv, real_up = int8_conv.conv_op, int8_upsample.upsample_op

    def conv(*a, **k):
        calls["q1"] += 1
        return real_conv(*a, **k)

    def up(*a, **k):
        calls["q2"] += 1
        return real_up(*a, **k)

    int8_conv.conv_op, int8_upsample.upsample_op = conv, up
    try:
        got = apply(qvars_from_flax(c["jax"]), torch.from_numpy(x))
    finally:
        int8_conv.conv_op, int8_upsample.upsample_op = real_conv, real_up
    level = effective_level(c["cfg"])
    assert calls == {"q1": (level + 1) * (level + 2),
                     "q2": level * (level + 1) // 2}
    assert got.shape == want.shape == (2, 32, 32, 1)
    _compare(got, want, APPLY_RTOL, APPLY_MIN_CORR)


def test_unetpp_pruned_at_depth_is_the_unpruned_artifact(pp_carried):
    c = pp_carried("ds")
    cfg = dataclasses.replace(c["cfg"], prune_level=PP_KW["depth"])
    calib = np.random.default_rng(8).random((4, 32, 32, 2), np.float32)
    at_depth = tq.quantize_unet(c["model"], cfg, calib)
    flat_a, flat_b = dict(_leaves(at_depth)), dict(_leaves(c["port"]))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_b.items():
        assert (v is None and flat_a[k] is None) or torch.equal(flat_a[k], v)
    x = torch.from_numpy(calib[:2])
    assert torch.equal(tq.make_quantized_apply(cfg)(at_depth, x),
                       tq.make_quantized_apply(c["cfg"])(c["port"], x))


def _plain_unetpp(qvars, cfg, x):
    """The UNet++ int8 forward from Q1's and Q2's plain versions alone,
    every node with Q1's fused requant and each side head on a second, fp32
    run of its node's last conv: the plain version of the deep-supervised
    top row's fp32-then-``quant_act`` path."""
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    level = effective_level(cfg)

    def node(xq, blk, skip=None, fp32=False):
        mq = int8_conv.int8_conv3x3_ref(xq, blk["wq1"], blk["a1"], blk["b1"],
                                        blk["s_mid"], skip)
        return int8_conv.int8_conv3x3_ref(mq, blk["wq2"], blk["a2"],
                                          blk["b2"],
                                          None if fp32 else blk["s_out"])

    g, top = {}, {}
    h = int8_conv.quant_act(x, qvars["s_in"])
    for i in range(level + 1):
        if i:
            h = tq._max_pool2_q(g[(i - 1, 0)])
        g[(i, 0)] = node(h, qvars["blocks"][f"x{i}_0"])
    for j in range(1, level + 1):
        for i in range(level + 1 - j):
            up = qvars["ups"][f"up{i}_{j}"]
            u = int8_upsample.int8_upsample2x2_ref(
                g[(i + 1, j - 1)], up["kq"], up["sw"], up["bias"],
                up["s_up"])
            skip = torch.cat([g[(i, k)] for k in range(j)], dim=-1)
            blk = qvars["blocks"][f"x{i}_{j}"]
            if i == 0:
                top[j] = node(u, blk, skip, fp32=True)
            if blk["s_out"] is not None:
                g[(i, j)] = node(u, blk, skip)
    heads = ({j: f"head_{j}" for j in range(1, level + 1)}
             if cfg.deep_supervision else {level: "head"})
    outs = [top[j] @ qvars["heads"][n]["kernel"][0, 0]
            + qvars["heads"][n]["bias"] for j, n in heads.items()]
    return sum(outs) / len(outs)


@pytest.mark.parametrize("case", ["ds", "ds-L2", "plain"])
def test_unetpp_side_heads_match_the_plain_version(pp_carried, case):
    """On the CPU the apply (the top row's nodes written fp32 for their
    heads, then ``quant_act`` for the later concats) equals the forward of
    Q1's and Q2's plain versions with the fused requant everywhere, bit for
    bit; its debug form keeps every int8 plane: the input, the pools, two
    per node (one for the head-only X[0][L]) and the upsamples."""
    c = pp_carried(case)
    x = torch.from_numpy(np.random.default_rng(10).random(
        (2, 32, 32, 2), np.float32))
    planes = []
    got = tq.make_quantized_apply(c["cfg"])(c["port"], x, planes=planes)
    assert torch.equal(got, _plain_unetpp(c["port"], c["cfg"], x))
    level = effective_level(c["cfg"])
    nodes, ups = (level + 1) * (level + 2) // 2, level * (level + 1) // 2
    assert len(planes) == 1 + level + 2 * nodes - 1 + ups
    assert all(p.dtype == torch.int8 for p in planes)
