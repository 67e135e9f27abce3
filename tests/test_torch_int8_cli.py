"""``predict_model --int8`` of plumekit_torch against the JAX CLI's: the
prediction files of a ``make_dataset`` root, the flag guards, the
calibration's all-null skip and refusal (``tests/test_quantized_forward.py``
:135-153, :241-278), and both CLIs serving the same weights to the same
files on the same root, each granule decoded once. On the CPU every 3×3
conv of the int8 forward runs Q1's plain version."""

import logging
import os

import numpy as np
import pytest
import torch

import jax

from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.infer import streaming
from plumekit_torch.io import granule as torch_granule
from plumekit_torch.models import build_model
from plumekit_torch.models.kernels import int8_conv
from plumekit_torch.train.checkpoint import save_model_config, save_weights

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
SERVE = ["--tile", "32", "--overlap", "8", "--batch-tiles", "4"]
# the port's int8 probabilities against the JAX CLI's on the same weights:
# both quantize the same fp32 replay and run the same int8 planes, but
# XLA's CPU may contract acc·a + b into an FMA, which can put a requantized
# value one step away and move the logits after it; the head and the
# stitching sum in another order. Found on this root: max|Δp| 1.2e-7, no
# mask flip in 12,288 pixels
PROB_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _granule(seed, name, size=64, null=False):
    rng = np.random.default_rng(seed)
    aod = rng.random((size, size)).astype(np.float32)
    aod[rng.random((size, size)) < 0.05] = torch_granule.NULL_VALUE
    if null:
        aod[:] = torch_granule.NULL_VALUE
    lat, lon = np.meshgrid(np.linspace(10, 11, size, dtype=np.float32),
                           np.linspace(20, 21, size, dtype=np.float32),
                           indexing="ij")
    return torch_granule.Granule({"2020001A": aod}, lat, lon, name=name)


def _root(tmp_path, names=("g0", "g1"), nulls=()):
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    for i, name in enumerate(names):
        torch_granule.save_granule(os.path.join(maiac, f"{name}.npz"),
                                   _granule(i + 1, name, null=name in nulls))
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, UNetConfig(**KW))
    save_weights(ckpt, build_model(UNetConfig(**KW),
                                   torch.Generator().manual_seed(0)))
    return root, ckpt


def _predictions(root):
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for f in sorted(os.listdir(out)):
        with np.load(os.path.join(out, f)) as d:
            preds[f] = {k: d[k] for k in d.files}
    return preds


def _int8(root, *flags):
    return cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--int8"] + SERVE + list(flags))


def test_predict_model_int8_on_a_make_dataset_root(tmp_path, monkeypatch):
    """tests/test_quantized_forward.py:135-153 on the port: calibrates on
    the first granule and writes valid probability files for every
    granule, through Q1's plain version on every 3×3 conv."""
    root = str(tmp_path)
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "2",
                     "--size", "128", "--plumes", "2"]) == 0
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, UNetConfig(**KW))
    save_weights(ckpt, build_model(UNetConfig(**KW),
                                   torch.Generator().manual_seed(1)))
    calls = []
    real = int8_conv.int8_conv3x3_ref

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(int8_conv, "int8_conv3x3_ref", counted)
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--int8", "--tile", "64"]) == 0
    # 2·(2·depth + 1) convs per forward
    assert calls and len(calls) % (2 * (2 * KW["depth"] + 1)) == 0
    preds = _predictions(root)
    assert len(preds) == 2
    for pred in preds.values():
        probs = pred["probs"]
        assert probs.shape == (128, 128) and probs.dtype == np.float32
        assert np.isfinite(probs).all() and 0 <= probs.min() <= probs.max() \
            <= 1
        np.testing.assert_array_equal(pred["mask"], probs > pred["threshold"])


def test_int8_and_fused_exclude_each_other(tmp_path, caplog):
    root, _ckpt = _root(tmp_path)
    with caplog.at_level(logging.ERROR):
        assert _int8(root, "--fused") == 1
    assert "mutually exclusive" in caplog.text
    assert not os.path.exists(os.path.join(root, "processed", "predictions")) \
        or not os.listdir(os.path.join(root, "processed", "predictions"))


def test_int8_skips_an_all_null_granule_and_refuses_when_all_are(tmp_path,
                                                                 caplog):
    """tests/test_quantized_forward.py:241-278 on the port: an all-null
    first granule is skipped for calibration (with a warning) and still
    served; a root whose granules are all null exits 1 and writes
    nothing."""
    root, _ckpt = _root(tmp_path, names=("a_null", "b_real"),
                        nulls=("a_null",))
    with caplog.at_level(logging.WARNING):
        assert _int8(root) == 0
    assert "a_null.npz is all-null" in caplog.text
    assert sorted(_predictions(root)) == ["a_null_pred.npz", "b_real_pred.npz"]

    out = os.path.join(root, "processed", "predictions")
    for f in os.listdir(out):
        os.remove(os.path.join(out, f))
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.remove(os.path.join(maiac, "b_real.npz"))
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        assert _int8(root) == 1
    assert "no granule with signal" in caplog.text
    assert not os.listdir(out)


def test_int8_looks_at_four_granules_at_most(tmp_path, caplog):
    names = tuple(f"n{i}" for i in range(5)) + ("z_real",)
    root, _ckpt = _root(tmp_path, names=names, nulls=names[:5])
    with caplog.at_level(logging.ERROR):
        assert _int8(root) == 1
    assert "first 4 of 6" in caplog.text


def test_predict_model_int8_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs serve the JAX trainer's initial weights (PRNGKey(0), what
    ``plumekit predict_model`` serves with no checkpoint), carried over to
    the port's weights.pt, through the int8 forward each calibrates on the
    first granule; the port decodes every granule once."""
    root, ckpt = _root(tmp_path, names=("g0", "g1", "g2"))
    assert jax_main(["predict_model", "--root", root, "--int8"] + SERVE) == 0
    want = _predictions(root)
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(variables))
    save_weights(ckpt, model)

    decodes = []
    real = streaming.decode_granule_channels

    def counted(path, *args, **kw):
        decodes.append(os.path.basename(path))
        return real(path, *args, **kw)

    monkeypatch.setattr(streaming, "decode_granule_channels", counted)
    assert _int8(root) == 0
    assert sorted(decodes) == ["g0.npz", "g1.npz", "g2.npz"]
    got = _predictions(root)
    assert sorted(got) == sorted(want) == ["g0_pred.npz", "g1_pred.npz",
                                           "g2_pred.npz"]
    for f in got:
        assert sorted(got[f]) == ["mask", "probs", "threshold"]
        p, q = got[f]["probs"], want[f]["probs"]
        assert p.shape == q.shape == (64, 64) and p.dtype == np.float32
        np.testing.assert_allclose(p, q, atol=PROB_ATOL, rtol=0)
        sure = np.abs(q - 0.5) > PROB_ATOL
        np.testing.assert_array_equal(got[f]["mask"][sure],
                                      want[f]["mask"][sure])
