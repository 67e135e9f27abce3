"""plumekit_torch's sliding-window inference against the JAX package's
``make_sliding_infer(make_fused_apply(cfg), ...)`` with converted weights,
on the same numpy images, over each stitching path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import sliding as jax_sliding
from plumekit.models import UNet as JaxUNet
from plumekit.models.fused_forward import make_fused_apply as jax_fused_apply
from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.infer import sliding
from plumekit_torch.models import UNet
from plumekit_torch.models.fused_forward import make_fused_apply

# fp32 forwards and stitching: the same arithmetic in another order
PROB_TOL = 1e-4
KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    x = jnp.zeros((1, 32, 32, 2), jnp.float32)
    variables = JaxUNet(JaxUNetConfig(**KW)).init(jax.random.PRNGKey(1), x)
    variables = jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
        if a.ndim == 1 else a, variables)
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    return variables, model.eval()


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _check(got, want, threshold):
    (gp, gm), (wp, wm) = got, want
    gp, wp = gp.numpy(), np.asarray(wp)
    assert gp.shape == wp.shape
    np.testing.assert_allclose(gp, wp, atol=PROB_TOL, rtol=0)
    sure = np.abs(wp - threshold) > PROB_TOL
    np.testing.assert_array_equal(gm.numpy()[sure], np.asarray(wm)[sure])


# (image H, W), tile, overlap, batch_tiles: which path each one takes
GEOMETRIES = {
    "parity_fast_path": ((72, 80), 32, 8, 4),
    "overlap_zero": ((64, 96), 32, 0, 4),
    "sub_tile_image": ((20, 24), 32, 8, 4),
    "general_deep_overlap": ((48, 56), 32, 20, 3),
    # 7 tiles in batches of 4: one batch-fill duplicate, counted in the blend
    "general_batch_fill": ((32, 104), 32, 20, 4),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_sliding_infer_matches_jax(weights, name):
    variables, model = weights
    (h, w), tile, overlap, bt = GEOMETRIES[name]
    icfg = dict(tile_size=tile, overlap=overlap, batch_tiles=bt,
                threshold=0.5)
    image = _image((h, w, 2), seed=len(name))
    want = jax_sliding.make_sliding_infer(
        jax_fused_apply(JaxUNetConfig(**KW)), JaxInferConfig(**icfg))(
        variables, jnp.asarray(image))
    got = sliding.make_sliding_infer(
        make_fused_apply(UNetConfig(**KW)), InferConfig(**icfg))(
        model, torch.from_numpy(image))
    _check(got, want, 0.5)


def test_multi_granule_infer_matches_jax(weights):
    variables, model = weights
    icfg = dict(tile_size=32, overlap=8, batch_tiles=4, threshold=0.4)
    images = _image((2, 56, 64, 2), seed=7)
    want = jax_sliding.make_multi_granule_infer(
        jax_fused_apply(JaxUNetConfig(**KW)), JaxInferConfig(**icfg))(
        variables, jnp.asarray(images))
    got = sliding.make_multi_granule_infer(
        make_fused_apply(UNetConfig(**KW)), InferConfig(**icfg))(
        model, torch.from_numpy(images))
    _check(got, want, 0.4)


@pytest.mark.parametrize("overlap", [0, 8])
def test_uint8_emit_matches_jax(weights, overlap):
    variables, model = weights
    icfg = dict(tile_size=32, overlap=overlap, batch_tiles=4, emit="uint8")
    image = _image((64, 64, 2), seed=9)
    wp, wm = jax_sliding.make_sliding_infer(
        jax_fused_apply(JaxUNetConfig(**KW)), JaxInferConfig(**icfg))(
        variables, jnp.asarray(image))
    gp, gm = sliding.make_sliding_infer(
        make_fused_apply(UNetConfig(**KW)), InferConfig(**icfg))(
        model, torch.from_numpy(image))
    assert gp.dtype == torch.uint8
    # a probability within PROB_TOL of a rounding edge may code one apart
    diff = np.abs(gp.numpy().astype(int) - np.asarray(wp).astype(int))
    assert diff.max() <= 1
    same = diff == 0
    np.testing.assert_array_equal(gm.numpy()[same], np.asarray(wm)[same])


def test_geometry_helpers_match_jax():
    for size, tile, stride in [(72, 32, 24), (64, 32, 32), (20, 32, 24),
                               (48, 32, 12), (2048, 288, 256), (1, 8, 8)]:
        np.testing.assert_array_equal(sliding.tile_grid(size, tile, stride),
                                      jax_sliding.tile_grid(size, tile,
                                                            stride))
    for tile, overlap in [(32, 0), (32, 8), (32, 20), (288, 32)]:
        np.testing.assert_array_equal(sliding._taper(tile, overlap),
                                      jax_sliding._taper(tile, overlap))
    for bt in (1, 4, 64, 256):
        for n in (1, 3, 16, 64, 65, 841):
            assert sliding._effective_batch(bt, n) == \
                jax_sliding._effective_batch(bt, n)
    for shape, m in [((30, 45, 2), 16), ((32, 32), 16), ((17, 5), 4)]:
        img = _image(shape, seed=1)
        got, hw = sliding.pad_to_multiple(img, m)
        want, whw = jax_sliding.pad_to_multiple(img, m)
        assert hw == whw
        np.testing.assert_array_equal(got, want)


def test_invalid_geometry_is_refused():
    apply_fn = make_fused_apply(UNetConfig(**KW))
    for kw in (dict(tile_size=32, overlap=32), dict(tile_size=32, overlap=-1),
               dict(emit="uint16")):
        with pytest.raises(ValueError):
            sliding.make_sliding_infer(apply_fn, InferConfig(**kw))
