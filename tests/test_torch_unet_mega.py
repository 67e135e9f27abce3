"""plumekit_torch's whole-forward kernel module (K7) against the JAX package's
Pallas megakernel, run in interpret mode on the CPU as tests/test_unet_mega.py
runs it, on the same numpy inputs and the same weights (carried over by
``convert.from_flax``). On the CPU the port runs the kernel's plain version,
``mega_forward_ref``; the CUDA kernel is held against that plain version on
the card by tests/test_torch_kernels_cuda.py and ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import UNet as JaxUNet
from plumekit.models.pallas.unet_mega import (
    make_mega_apply as jax_mega_apply,
    mega_eligible as jax_mega_eligible,
)
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.models import UNet, build_model
from plumekit_torch.models.kernels import unet_mega

# the three geometries of tests/test_unet_mega.py: (h, w, depth), base 8
GEOMETRIES = [(32, 32, 2), (64, 48, 3), (64, 64, 4)]
# fp32: the same arithmetic, sums in another order
F32_TOL = 2e-4
# bf16 against the JAX megakernel: both round at the same points, only the
# fp32 summation order differs, so a rare rounding flips and spreads
MEGA_RTOL = 2e-2
# bf16 against the flax forward (BatchNorm not folded, the last block
# rounded): the JAX test's own bound (tests/test_unet_mega.py:48-49)
FLAX_RTOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(h, w, depth, dtype, seed=0, **extra):
    """Config keywords, flax variables with nontrivial running statistics
    (as numpy) and an input."""
    kw = dict(in_channels=2, base_features=8, depth=depth, norm="batch",
              compute_dtype=dtype, **extra)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, 2)).astype(np.float32)
    plain = {k: v for k, v in kw.items() if k != "use_mega"}
    variables = jax.tree.map(np.asarray, JaxUNet(JaxUNetConfig(**plain)).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    stats = jax.tree.map(
        lambda a: a + 0.3 * rng.normal(size=a.shape).astype(np.float32) ** 2,
        variables["batch_stats"])
    # a bias on the transposed convs and the head, which flax starts at 0
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if path[-1].key == "bias" else a, variables["params"])
    return kw, {"params": params, "batch_stats": stats}, x


def _port(kw, variables):
    model = UNet(UNetConfig(**kw))
    model.load_state_dict(from_flax(variables))
    return model.eval()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("h,w,depth", GEOMETRIES)
def test_mega_apply_matches_jax_megakernel_fp32(h, w, depth):
    kw, variables, x = _case(h, w, depth, "float32")
    want = np.asarray(jax_mega_apply(JaxUNetConfig(**kw))(
        variables, jnp.asarray(x)))
    got = unet_mega.make_mega_apply(UNetConfig(**kw))(
        _port(kw, variables), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("h,w,depth", GEOMETRIES)
def test_mega_apply_matches_jax_megakernel_and_flax_bf16(h, w, depth):
    kw, variables, x = _case(h, w, depth, "bfloat16", seed=1)
    jcfg = JaxUNetConfig(**kw)
    want = np.asarray(jax_mega_apply(jcfg)(variables, jnp.asarray(x)),
                      np.float32)
    flax = np.asarray(JaxUNet(jcfg).apply(variables, jnp.asarray(x)),
                      np.float32)
    got = unet_mega.make_mega_apply(UNetConfig(**kw))(
        _port(kw, variables), torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= MEGA_RTOL
    assert _rel_err(got, flax) < FLAX_RTOL


@pytest.mark.parametrize("h,w,depth", GEOMETRIES[1:])
def test_last_block_stays_fp32_and_skip_comes_before_up(h, w, depth):
    """The plain version keeps the last decoder block's result in fp32 into
    the head and reads the skip half of a decoder's first conv before the
    upsampled half. Either mistake moves the logits away from the JAX
    megakernel's by far more than the plain version's own distance to them
    (on these inputs hardly a rounding flips between the two)."""
    kw, variables, x = _case(h, w, depth, "bfloat16", seed=1)
    want = np.asarray(jax_mega_apply(JaxUNetConfig(**kw))(
        variables, jnp.asarray(x)), np.float32)
    weights = unet_mega.fold_weights(_port(kw, variables), torch.bfloat16)

    def forward(round_last: bool, swap: bool):
        blocks, ups = weights["blocks"], weights["ups"]
        y = torch.from_numpy(x).to(torch.bfloat16)
        skips = []
        for blk in blocks[:depth]:
            y = unet_mega.double_conv_ref(y, blk)
            skips.append(y)
            y = unet_mega.max_pool_ref(y)
        y = unet_mega.double_conv_ref(y, blocks[depth])
        for u, skip in enumerate(reversed(skips)):
            up = unet_mega.conv_transpose_ref(y, ups[u])
            y = torch.cat([up, skip] if swap else [skip, up], dim=-1)
            y = unet_mega.double_conv_ref(
                y, blocks[depth + 1 + u],
                out_f32=(u == depth - 1 and not round_last))
        return (y.float() @ weights["head_w"] + weights["head_b"]).numpy()

    right = unet_mega.mega_forward_ref(weights, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(forward(False, False), right)
    own = np.abs(right - want)
    assert own.max() <= 1e-4 * np.abs(want).max()
    rounded = np.abs(forward(True, False) - want)
    assert rounded.mean() > 100 * own.mean()
    assert _rel_err(forward(False, True), want) > 0.1


def test_mega_eligible_matches_jax_apart_from_the_vmem_term():
    """Every gate about the function agrees with the JAX package over a grid
    of configs and shapes small enough for the TPU's memory estimate to
    pass; the one intended difference is a tile that only that estimate
    refuses."""
    base = dict(in_channels=2, base_features=8, depth=2, norm="batch")
    variants = [
        {}, {"depth": 4}, {"depth": 1}, {"depth": 0}, {"norm": "group"},
        {"norm": "none"}, {"compute_dtype": "float32"},
        {"compute_dtype": "float16"}, {"in_channels": 128},
        {"in_channels": 129}, {"out_channels": 8}, {"out_channels": 9},
        {"arch": "unetpp"}, {"base_features": 32, "depth": 4},
    ]
    shapes = [(24, 64), (16, 16), (32, 32), (64, 48), (64, 64), (96, 96),
              (8, 8), (4, 4), (30, 32), (32, 2), (48, 80)]
    seen = set()
    for v in variants:
        kw = {**base, **v}
        for h, w in shapes:
            want = jax_mega_eligible(JaxUNetConfig(**kw), h, w)
            assert unet_mega.mega_eligible(UNetConfig(**kw), h, w) == want, \
                (kw, h, w)
            seen.add(want)
    assert seen == {True, False}
    # tests/test_unet_mega.py:52-57
    cfg = UNetConfig(**{**base, "depth": 4})
    assert not unet_mega.mega_eligible(cfg, 24, 64)
    assert not unet_mega.mega_eligible(cfg, 16, 16)
    assert not unet_mega.mega_eligible(
        UNetConfig(**{**base, "norm": "group"}), 64, 64)
    # the flagship net: 96² is eligible in both, 128² and 288² only here
    flagship, jflagship = UNetConfig(), JaxUNetConfig()
    assert unet_mega.mega_eligible(flagship, 96, 96)
    assert jax_mega_eligible(jflagship, 96, 96)
    for tile in (128, 288):
        assert unet_mega.mega_eligible(flagship, tile, tile)
        assert not jax_mega_eligible(jflagship, tile, tile)


def test_use_mega_routes_through_the_module():
    """``use_mega`` is read inside the module's forward, before
    ``use_pallas``: an eligible batch equals ``make_mega_apply``, the plain
    forward within the bf16 bound, and the JAX module; an ineligible shape
    and the group-norm net fall through to the plain forward."""
    kw, variables, x = _case(32, 32, 2, "bfloat16", seed=2)
    model = _port(kw, variables)
    routed = UNet(UNetConfig(**kw, use_mega=True, use_pallas=True))
    routed.load_state_dict(model.state_dict())
    routed.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = routed(xt)
        plain = model(xt)
        small = routed(xt[:, :4, :4])          # 1-px bottleneck: ineligible
        fused_small = UNet(UNetConfig(**kw, use_pallas=True))
        fused_small.load_state_dict(model.state_dict())
        want_small = fused_small.eval()(xt[:, :4, :4])
    want = unet_mega.make_mega_apply(UNetConfig(**kw))(model, xt)
    assert torch.equal(got, want)
    assert torch.equal(small, want_small)      # fell through to use_pallas
    assert _rel_err(got.numpy(), plain.numpy()) < FLAX_RTOL
    jax_out = np.asarray(JaxUNet(JaxUNetConfig(**kw, use_mega=True)).apply(
        variables, jnp.asarray(x)), np.float32)
    assert _rel_err(got.numpy(), jax_out) <= MEGA_RTOL

    gkw = dict(kw, norm="group", compute_dtype="float32")
    gmodel = build_model(UNetConfig(**gkw, use_mega=True),
                         torch.Generator().manual_seed(0)).eval()
    plain_g = build_model(UNetConfig(**gkw)).eval()
    plain_g.load_state_dict(gmodel.state_dict())
    with torch.no_grad():
        assert torch.equal(gmodel(xt), plain_g(xt))


def test_mega_apply_refuses_training_channels_and_shapes():
    kw, variables, x = _case(32, 32, 2, "float32")
    cfg = UNetConfig(**kw)
    model = _port(kw, variables)
    apply = unet_mega.make_mega_apply(cfg)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="inference-only"):
        apply(model, xt, train=True)
    with pytest.raises(ValueError, match="channels"):
        apply(model, torch.cat([xt, xt[..., :1]], dim=-1))
    with pytest.raises(ValueError, match="ineligible"):
        apply(model, xt[:, :30])
    with pytest.raises(ValueError, match="batch-norm"):
        unet_mega.make_mega_apply(dataclasses.replace(cfg, norm="group"))


def test_weights_are_folded_once_per_model_and_again_after_a_change():
    kw, variables, x = _case(32, 32, 2, "float32")
    model = _port(kw, variables)
    cpu = torch.device("cpu")
    first = unet_mega.weights_of(model, torch.float32, cpu)
    assert unet_mega.weights_of(model, torch.float32, cpu) is first
    apply = unet_mega.make_mega_apply(UNetConfig(**kw))
    before = apply(model, torch.from_numpy(x))
    assert unet_mega.weights_of(model, torch.float32, cpu) is first
    with torch.no_grad():
        model.head.bias.add_(1.0)
    assert unet_mega.weights_of(model, torch.float32, cpu) is not first
    after = apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(after.numpy(), before.numpy() + 1.0,
                               rtol=1e-6, atol=1e-6)


def test_plan_and_packing_cover_every_plane_and_weight_once():
    """The stage table the kernel is launched with, checked here where the
    kernel cannot run: planes do not overlap and chain from block to block,
    and the packed weights read back equal the folded ones."""
    kw, variables, _ = _case(32, 32, 2, "bfloat16")
    kw["base_features"] = 12                 # channel counts that need padding
    model = build_model(UNetConfig(**kw), torch.Generator().manual_seed(0))
    folded = unet_mega.fold_weights(model.eval(), torch.bfloat16)
    blob, stages = unet_mega._pack(folded, torch.device("cpu"))
    # every plane in its own room, as the kernel's per-stage check reads
    # them; the table the forward runs reuses rooms, and
    # tests/test_torch_mega_plan.py holds its liveness
    plan, scratch = unet_mega._plan(stages, 3, 32, 48, reuse=False)
    depth = 2
    assert plan.shape == (2 * depth + 1, unet_mega._PLAN_FIELDS)
    assert [int(k) for k in plan[:, 0]] == [0, 0, 1, 1, 2]
    # planes: (offset, elements) of every out and aux, disjoint, in scratch
    spans = []
    for row in plan:
        kind, h, w, cout, up_cout = (int(row[i]) for i in (0, 1, 2, 10, 22))
        if kind == 0:
            spans += [(int(row[18]), 3 * h * w * cout),
                      (int(row[19]), 3 * (h // 2) * (w // 2) * cout)]
        elif kind == 1:
            spans += [(int(row[18]), 3 * h * w * cout),
                      (int(row[19]), 3 * 4 * h * w * up_cout)]
        else:
            assert row[18] == row[19] == -1
    spans.sort()
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= scratch
    assert all(a % 128 == 0 for a, _ in spans)      # 256-byte aligned
    # the chain: input, pooled planes down, then skip + upsampled planes up
    assert plan[0, 3] == -1 and plan[1, 3] == plan[0, 19]
    assert plan[2, 3] == plan[1, 19] and plan[2, 6] == -1
    assert (plan[3, 3], plan[3, 6]) == (plan[1, 18], plan[2, 19])
    assert (plan[4, 3], plan[4, 6]) == (plan[0, 18], plan[3, 19])
    # weights: w1t of the last decoder block holds the skip half at padded
    # channels [0, 32) and the upsampled half from 32 on
    row, blk = plan[4], folded["blocks"][4]
    cmid_p, kp = int(row[9]), int(row[8])
    assert (cmid_p, kp, int(row[5])) == (32, 64, 32)
    w1t = blob[int(row[12]):int(row[12]) + cmid_p * 9 * kp * 2] \
        .view(torch.bfloat16).reshape(cmid_p, 9, kp)
    hwio = blk["w1"].reshape(9, 24, 12)
    assert torch.equal(w1t[:12, :, :12], hwio[:, :12].permute(2, 0, 1))
    assert torch.equal(w1t[:12, :, 32:44], hwio[:, 12:].permute(2, 0, 1))
    assert not w1t[12:].any() and not w1t[:, :, 12:32].any() \
        and not w1t[:, :, 44:].any()
    # the bottleneck's transposed conv, a one-tap weight stream
    # [pass][chunk][tap][group][n][8]: depth ci = 32·chunk + 8·group + e,
    # column 128·pass + n = tap · Cup_p + co
    row, up = plan[2], folded["ups"][0]
    cup_p, kp = int(row[23]), int(row[31])
    assert (cup_p, kp) == (32, 64)
    stream = blob[int(row[20]):int(row[20]) + kp * 4 * cup_p * 2] \
        .view(torch.bfloat16).reshape(4 * cup_p // 128, kp // 32, 4, 128, 8)
    upw = stream.permute(1, 2, 4, 0, 3).reshape(kp, 4, cup_p)
    for di in range(2):
        for dj in range(2):
            assert torch.equal(upw[:48, 2 * di + dj, :24],
                               up["w"][:, :, di, dj])
    assert not upw[48:].any() and not upw[:, :, 24:].any()
    # every stage of this narrow net takes the mma.sync path on 16 x 16 tiles
    assert [[int(v) for v in r[27:31]] for r in plan] == [[0, 16, 16, 1]] * 5
    head_w = blob[int(plan[4, 24]):int(plan[4, 24]) + 32 * 8 * 4] \
        .view(torch.float32).reshape(32, 8)
    assert torch.equal(head_w[:12, :1], folded["head_w"])
    assert int(plan[4, 26]) == 1


def test_cuda_tensor_without_a_card_raises_and_never_takes_the_plain_version(
        monkeypatch):
    """A tensor that is not on the CPU must reach the kernel or raise: the
    plain version is for CPU tensors only."""
    kw, variables, x = _case(32, 32, 2, "bfloat16")
    model = _port(kw, variables)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(unet_mega, "mega_forward_ref", refuse)
    weights = unet_mega.MegaWeights(unet_mega.fold_weights(model,
                                                           torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel for device"):
        unet_mega.mega_forward(weights, torch.from_numpy(x).to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            unet_mega.make_mega_apply(UNetConfig(**kw))(
                model, torch.from_numpy(x).to("cuda"))


def test_fp32_off_the_cpu_raises_through_the_module(monkeypatch):
    """An fp32 ``use_mega`` module has a kernel on the card (the fp32
    body). Given a tensor that is neither on the CPU nor on a card, it
    reaches the kernel's entry and raises there, alone and with
    ``use_pallas``: the plain version is for CPU tensors only, and no other
    forward runs under the flag."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a tensor off the CPU")

    monkeypatch.setattr(unet_mega, "mega_forward_ref", refuse)
    kw, _variables, x = _case(32, 32, 2, "float32")
    off_cpu = torch.from_numpy(x).to("meta")
    for extra in ({}, {"use_pallas": True}):
        model = UNet(UNetConfig(**kw, use_mega=True, **extra)).eval()
        with pytest.raises(ValueError, match="no kernel for device"):
            model(off_cpu)
        # an ineligible shape still falls through, as in the JAX package
        assert not unet_mega.mega_eligible(model.cfg, 4, 4)
