"""The port's data streams against the JAX package's: ``stream_inference``
with its decode pool, stager and quantized transfers on weights carried
over by ``convert.from_flax`` (the JAX package's own bounds,
``tests/test_viz_streaming.py:131-195``), a decode error reaching the
caller, ``predict_model`` with the quantized transfers around the int8 and
fused forwards, and ``build_features`` decoding on the pool to exactly the
serial outputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer.sliding import make_sliding_infer as jax_sliding_infer
from plumekit.infer.streaming import stream_inference as jax_stream
from plumekit.models import UNet as JaxUNet
from plumekit_torch import cli
from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.infer.sliding import make_multi_granule_infer
from plumekit_torch.infer.streaming import stream_inference
from plumekit_torch.io import prefetch
from plumekit_torch.io.granule import Granule, save_granule
from plumekit_torch.models import UNet, build_model
from plumekit_torch.train.checkpoint import save_weights
from test_torch_cli import (SERVE, _assert_same_features, _feature_outputs,
                            _identify_root, _predictions, _root)

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
ICFG = dict(tile_size=32, overlap=8, batch_tiles=4)
PROB_TOL = 1e-4          # fp32 forwards and stitching, sums in another order
QUANT_TOL = 1e-2         # the uint16 upload's step through the forward
OUT_TOL = 1 / 510 + 1e-7  # the uint8 readback's half step
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Five 70 × 90 granules (padded to the U-Net's divisibility and
    cropped back), the JAX variables and the port's model carrying them,
    and both packages' sliding inference."""
    tmp = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        aod = (rng.random((70, 90)) * 2.0).astype(np.float32)
        lat, lon = np.mgrid[0:70, 0:90].astype(np.float32)
        paths.append(str(tmp / f"g{i}.npz"))
        save_granule(paths[-1], Granule({"t0": aod}, lat, lon, name=f"g{i}"))
    jax_model = JaxUNet(JaxUNetConfig(**KW))
    variables = jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 2)), train=False)
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    infer = make_multi_granule_infer(lambda m, x: m(x), InferConfig(**ICFG))
    jax_infer = jax_sliding_infer(jax_model.apply, JaxInferConfig(**ICFG),
                                  channels=2)
    return paths, model.eval(), infer, variables, jax_infer


def _port(served, **kw):
    paths, model, infer, _, _ = served
    with torch.inference_mode():
        return dict(stream_inference(paths, infer, model, 2, CPU, **kw))


def test_pooled_and_prefetched_stream_equals_serial_bit_for_bit(served):
    serial = _port(served, decode_workers=1, buffer_size=1)
    for kw in (dict(decode_workers=4), dict(decode_workers=4,
                                            batch_granules=2)):
        pooled = _port(served, **kw)
        assert list(pooled) == list(serial) == [f"g{i}" for i in range(5)]
        for k in serial:
            assert pooled[k].shape == (70, 90)
            np.testing.assert_array_equal(pooled[k], serial[k])


def test_quantize_lies_near_the_fp32_stream_and_differs(served):
    ref = _port(served)
    q = _port(served, quantize=True)
    assert q.keys() == ref.keys()
    for k in ref:
        assert q[k].dtype == np.float32 and q[k].shape == ref[k].shape
        np.testing.assert_allclose(q[k], ref[k], atol=QUANT_TOL, rtol=0)
    # the upload really was quantized
    assert any(not np.array_equal(q[k], ref[k]) for k in ref)


def test_quantize_output_lies_on_the_uint8_lattice(served):
    ref = _port(served)
    qo = _port(served, quantize_output=True)
    for k in ref:
        assert qo[k].dtype == np.float32
        np.testing.assert_allclose(qo[k], ref[k], atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(qo[k] * 255, np.round(qo[k] * 255),
                                   atol=1e-3)
    all_on = _port(served, quantize=True, quantize_output=True,
                   batch_granules=3)
    for k in ref:
        np.testing.assert_allclose(all_on[k], ref[k],
                                   atol=QUANT_TOL + 1 / 510, rtol=0)


def test_quantized_stream_matches_the_jax_quantized_stream(served):
    paths, _, _, variables, jax_infer = served
    want = dict(jax_stream(paths, jax_infer, variables, 2, quantize=True,
                           batch_granules=2, decode_workers=1))
    got = _port(served, quantize=True, batch_granules=2)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   atol=PROB_TOL, rtol=0)


def test_a_decode_error_reaches_the_caller_after_the_earlier_granules(
        served, tmp_path):
    paths, model, infer, _, _ = served
    broken = paths[:2] + [str(tmp_path / "missing.npz")] + paths[2:]
    got = []
    with pytest.raises(FileNotFoundError):
        with torch.inference_mode():
            for name, _ in stream_inference(broken, infer, model, 2, CPU,
                                            decode_workers=4):
                got.append(name)
    assert got == ["g0", "g1"]


def _serial_pool(items, decode_fn, workers=4, depth=4):
    return map(decode_fn, items)


@pytest.mark.parametrize("flags, root_kw", [
    (["--detector", "rg"], {}),
    (["--detector", "basic"], dict(seeds=(61, 62), background_level=0.05,
                                   background_noise=0.02)),
    (["--detector", "rg", "--batch-scenes", "2"], {}),
])
def test_build_features_on_the_pool_writes_the_serial_outputs(
        tmp_path, monkeypatch, flags, root_kw):
    import shutil

    root = _identify_root(tmp_path, **root_kw)
    serial = str(tmp_path / "serial")
    shutil.copytree(root, serial)
    pools = []
    real = prefetch.decode_pool

    def counted(items, decode_fn, workers, depth):
        pools.append((workers, depth))
        return real(items, decode_fn, workers=workers, depth=depth)

    monkeypatch.setattr(prefetch, "decode_pool", counted)
    assert cli.main(["build_features", "--root", root, "--device", "cpu"]
                    + flags) == 0
    batch = int(flags[-1]) if "--batch-scenes" in flags else 1
    assert pools == [(prefetch.default_decode_workers(),
                      max(2, batch + 1))]
    monkeypatch.setattr(prefetch, "decode_pool", _serial_pool)
    assert cli.main(["build_features", "--root", serial, "--device", "cpu"]
                    + flags) == 0
    got = _feature_outputs(root)
    assert len(got[f"logs/{flags[1]}_log.txt"]) == 2
    _assert_same_features(got, _feature_outputs(serial))


@pytest.mark.parametrize("flags", [["--int8"], ["--fused"]])
def test_predict_model_takes_the_quantized_transfers_with_every_forward(
        tmp_path, flags):
    """``--quantize`` (with ``--int8``, as the JAX CLI allows) and both
    codecs with ``--fused``: the files lie within the JAX package's bounds
    of the same forward's unquantized files."""
    root, ckpt = _root(tmp_path)
    save_weights(ckpt, build_model(UNetConfig(**KW),
                                   torch.Generator().manual_seed(0)))
    base = ["predict_model", "--root", root, "--device", "cpu"] + SERVE
    assert cli.main(base + flags) == 0
    want = _predictions(root)
    quant = ["--quantize"] if flags == ["--int8"] else [
        "--quantize", "--quantize-output"]
    assert cli.main(base + flags + quant) == 0
    got = _predictions(root)
    assert sorted(got) == sorted(want) == ["g0_pred.npz", "g1_pred.npz"]
    for f in got:
        np.testing.assert_allclose(got[f]["probs"], want[f]["probs"],
                                   atol=QUANT_TOL + 1 / 510, rtol=0)
        np.testing.assert_array_equal(got[f]["mask"], got[f]["probs"] > 0.5)
