"""plumekit_torch's granule decode, model-input contract, granule stream and
model-config files against the JAX package's, on the same files."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer.sliding import make_sliding_infer as jax_sliding_infer
from plumekit.infer.streaming import (
    decode_granule_channels as jax_decode,
    stream_inference as jax_stream,
)
from plumekit.models import UNet as JaxUNet
from plumekit.models.fused_forward import make_fused_apply as jax_fused_apply
from plumekit.train import checkpoint as jax_checkpoint
from plumekit.train.data import assemble_channels as jax_assemble
from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.device import resolve_device
from plumekit_torch.infer.sliding import make_multi_granule_infer
from plumekit_torch.infer.streaming import (
    decode_granule_channels,
    stream_inference,
)
from plumekit_torch.io.granule import NULL_VALUE, Granule, save_granule
from plumekit_torch.models import UNet
from plumekit_torch.models.fused_forward import make_fused_apply
from plumekit_torch.train import checkpoint
from plumekit_torch.train.data import assemble_channels

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
PROB_TOL = 1e-4


def _fires(granule):
    """A fire locator: two fixed detections (row, col lists)."""
    return [3, 10], [5, 7]


def _write(path, shape, seed, name):
    rng = np.random.default_rng(seed)
    aod = rng.random(shape).astype(np.float32)
    aod[rng.random(shape) < 0.05] = NULL_VALUE
    z = np.zeros(shape, np.float32)
    save_granule(path, Granule({"2020001A": aod}, z, z, name=name))


def test_assemble_channels_matches_jax():
    rng = np.random.default_rng(0)
    aod = rng.random((30, 40)).astype(np.float32)
    aod[:3] = NULL_VALUE
    for rows, cols in [([], []), ([4, 20], [9, 33])]:
        np.testing.assert_array_equal(assemble_channels(aod, rows, cols),
                                      jax_assemble(aod, rows, cols))


def test_decode_matches_jax(tmp_path):
    path = str(tmp_path / "g.npz")
    _write(path, (70, 61), 1, "g")
    for locator in (None, _fires):
        name, ch, hw = decode_granule_channels(path, 2, locator)
        jname, jch, jhw = jax_decode(path, 2, locator)
        assert (name, hw) == (jname, jhw) == ("g", (70, 61))
        assert ch.shape == (72, 64, 2)
        np.testing.assert_array_equal(ch, jch)


def test_stream_matches_jax_stream(tmp_path):
    """Mixed shapes grouped two at a time: the same granules in the same
    order, with the same probabilities."""
    paths = []
    for i, shape in enumerate([(64, 64), (64, 64), (40, 48), (64, 64),
                               (64, 64), (64, 64)]):
        paths.append(str(tmp_path / f"g{i}.npz"))
        _write(paths[-1], shape, i, f"g{i}")
    variables = JaxUNet(JaxUNetConfig(**KW)).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 2)))
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    icfg = dict(tile_size=32, overlap=8, batch_tiles=4)
    want = list(jax_stream(
        paths, jax_sliding_infer(jax_fused_apply(JaxUNetConfig(**KW)),
                                 JaxInferConfig(**icfg)),
        variables, 2, batch_granules=2, decode_workers=1))
    infer = make_multi_granule_infer(make_fused_apply(UNetConfig(**KW)),
                                     InferConfig(**icfg))
    got = list(stream_inference(paths, infer, model.eval(), 2,
                                torch.device("cpu"), batch_granules=2))
    assert [n for n, _ in got] == [n for n, _ in want] == \
        [f"g{i}" for i in range(6)]
    for (_, p), (_, q) in zip(got, want):
        assert p.shape == np.asarray(q).shape
        np.testing.assert_allclose(p, np.asarray(q), atol=PROB_TOL, rtol=0)


def test_model_config_files_are_shared(tmp_path, caplog):
    cfg = UNetConfig(base_features=16, depth=3, use_pallas=True)
    checkpoint.save_model_config(str(tmp_path), cfg)
    assert checkpoint.load_model_config(str(tmp_path)) == cfg
    assert jax_checkpoint.load_model_config(str(tmp_path)) == \
        JaxUNetConfig(base_features=16, depth=3, use_pallas=True)
    jax_checkpoint.save_model_config(str(tmp_path / "j"),
                                     JaxUNetConfig(norm="group"))
    assert checkpoint.load_model_config(str(tmp_path / "j")) == \
        UNetConfig(norm="group")
    with open(tmp_path / "model_config.json") as f:
        d = json.load(f)
    d["from_the_future"] = 1
    with open(tmp_path / "model_config.json", "w") as f:
        json.dump(d, f)
    assert checkpoint.load_model_config(str(tmp_path)) == cfg
    assert "from_the_future" in caplog.text
    assert checkpoint.load_model_config(str(tmp_path / "none")) is None


def test_weights_round_trip(tmp_path):
    a = UNet(UNetConfig(base_features=4, depth=1))
    checkpoint.save_weights(str(tmp_path), a)
    b = UNet(UNetConfig(base_features=4, depth=1))
    assert checkpoint.load_weights(str(tmp_path), b)
    assert all(torch.equal(a.state_dict()[k], v)
               for k, v in b.state_dict().items())
    assert not checkpoint.load_weights(str(tmp_path / "none"), b)
    assert os.listdir(tmp_path) == [checkpoint.WEIGHTS_BASENAME]


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
