"""plumekit_torch's U-Net (plain and fused forward) and the weight converter
against the JAX package's flax U-Net and fused forward, on the same numpy
inputs and the same weights."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import UNet as JaxUNet
from plumekit.models.fused_forward import make_fused_apply as jax_fused_apply
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax, to_flax
from plumekit_torch.models import UNet, build_model
from plumekit_torch.models.fused_forward import (
    _conv_transpose2,
    make_fused_apply,
)

# fp32: same arithmetic, sums in another order (test_fused_forward.py:30)
F32_TOL = 2e-4
# bf16: the repo's bound for a bf16 replay against the reference
# (test_fused_forward.py:68-72): 5e-2 absolute and correlation > 0.999
BF16_TOL, BF16_MIN_CORR = 5e-2, 0.999


def _variables(norm="batch", dtype="float32", seed=0):
    """flax U-Net variables (base 8, depth 2) with the nontrivial batch
    statistics of tests/test_fused_forward.py, as numpy, plus an input."""
    kw = dict(in_channels=2, base_features=8, depth=2, compute_dtype=dtype,
              norm=norm)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
    variables = JaxUNet(JaxUNetConfig(**kw)).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    variables = jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
        if a.ndim == 1 else a, variables)
    return kw, jax.tree.map(np.asarray, variables), x


def _port(kw, variables):
    model = UNet(UNetConfig(**kw))
    model.load_state_dict(from_flax(variables))
    return model.eval()


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_plain_forward_matches_flax(norm):
    kw, variables, x = _variables(norm)
    want = JaxUNet(JaxUNetConfig(**kw)).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(kw, variables)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_fused_forward_matches_flax_and_jax_fused():
    kw, variables, x = _variables()
    model = _port(kw, variables)
    got = make_fused_apply(UNetConfig(**kw))(model, torch.from_numpy(x))
    flax_out = JaxUNet(JaxUNetConfig(**kw)).apply(variables, jnp.asarray(x))
    jax_fused = jax_fused_apply(JaxUNetConfig(**kw))(variables,
                                                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(flax_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fused),
                               rtol=F32_TOL, atol=F32_TOL)


def test_bf16_forwards_match_jax():
    kw, variables, x = _variables(dtype="bfloat16", seed=1)
    model = _port(kw, variables)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with torch.no_grad():
        pairs = [
            (model(xt), JaxUNet(JaxUNetConfig(**kw)).apply(variables, xj)),
            (make_fused_apply(UNetConfig(**kw))(model, xt),
             jax_fused_apply(JaxUNetConfig(**kw))(variables, xj)),
        ]
    for got, want in pairs:
        g = got.float().numpy().ravel()
        w = np.asarray(want, np.float32).ravel()
        assert np.abs(g - w).max() <= BF16_TOL
        assert np.corrcoef(g, w)[0, 1] > BF16_MIN_CORR


def test_use_pallas_routes_forward_through_fused_replay():
    kw, variables, x = _variables()
    model = _port(kw, variables)
    routed = UNet(UNetConfig(**kw, use_pallas=True))
    routed.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = routed.eval()(torch.from_numpy(x))
    want = make_fused_apply(UNetConfig(**kw))(model, torch.from_numpy(x))
    assert torch.equal(got, want)


def test_transposed_conv_flip():
    """flax ConvTranspose (2×2, stride 2) == torch conv_transpose2d with the
    converted kernel == the fused forward's matmul + pixel shuffle."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    layer = nn.ConvTranspose(3, (2, 2), strides=(2, 2))
    kernel = rng.normal(size=(2, 2, 4, 3)).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    v = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    want = np.asarray(layer.apply(v, jnp.asarray(x)))
    sd = from_flax({"params": {"ConvTranspose_0": {"kernel": kernel,
                                                   "bias": bias}}})
    w, b = sd["ups.0.weight"], sd["ups.0.bias"]
    xt = torch.from_numpy(x)
    conv_t = F.conv_transpose2d(xt.permute(0, 3, 1, 2), w, b, stride=2)
    np.testing.assert_allclose(conv_t.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_conv_transpose2(xt, w, b).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # the flip is needed: the kernel carried over as it is disagrees
    unflipped = torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())
    conv_u = F.conv_transpose2d(xt.permute(0, 3, 1, 2), unflipped, b, stride=2)
    assert not np.allclose(conv_u.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-3)


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_from_flax_to_flax_round_trip(norm):
    kw, variables, _ = _variables(norm)
    back = to_flax(from_flax(variables), norm=norm)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_build_model_refuses_unported_architectures():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(UNetConfig(arch="unetpp"))
    g = torch.Generator().manual_seed(0)
    a = build_model(UNetConfig(base_features=4, depth=1), g).state_dict()
    b = build_model(UNetConfig(base_features=4, depth=1),
                    torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_receptive_field_matches_jax():
    from plumekit.models import receptive_field as jax_receptive_field
    from plumekit_torch.models import receptive_field

    for depth in range(1, 6):
        assert receptive_field(depth) == jax_receptive_field(depth)
