"""plumekit_torch's granule files and ``predict_model`` against the JAX
package's: files read across packages, and the two CLIs serve the same
weights to the same prediction files."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.io import granule as jax_granule
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.io import granule as torch_granule
from plumekit_torch.models import build_model
from plumekit_torch.train.checkpoint import save_model_config, save_weights

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
SERVE = ["--tile", "32", "--overlap", "8", "--batch-tiles", "4"]
PROB_TOL = 1e-4   # fp32 forwards and stitching, sums in another order


def _granule(seed, name, size=64):
    rng = np.random.default_rng(seed)
    aod = rng.random((size, size)).astype(np.float32)
    aod[rng.random((size, size)) < 0.05] = torch_granule.NULL_VALUE
    lat, lon = np.meshgrid(np.linspace(10, 11, size, dtype=np.float32),
                           np.linspace(20, 21, size, dtype=np.float32),
                           indexing="ij")
    return torch_granule.Granule({"2020001A": aod}, lat, lon, name=name)


def _assert_same_granule(a, b):
    assert a.name == b.name and list(a.layers) == list(b.layers)
    for k in a.layers:
        np.testing.assert_array_equal(a.layers[k], b.layers[k])
    np.testing.assert_array_equal(a.lat, b.lat)
    np.testing.assert_array_equal(a.lon, b.lon)


@pytest.mark.parametrize("ext", [".npz", ".h5"])
def test_granule_files_read_across_packages(tmp_path, ext):
    if ext == ".h5":
        pytest.importorskip("h5py")
    g = _granule(0, "g0")
    path = str(tmp_path / f"port{ext}")
    torch_granule.save_granule(path, g)
    _assert_same_granule(jax_granule.load_granule(path), g)
    path = str(tmp_path / f"jax{ext}")
    jax_granule.save_granule(path, jax_granule.Granule(g.layers, g.lat, g.lon,
                                                       name="g1"))
    back = torch_granule.load_granule(path)
    assert back.name == "g1"
    _assert_same_granule(back, torch_granule.Granule(g.layers, g.lat, g.lon,
                                                     name="g1"))


def _root(tmp_path):
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    for i in range(2):
        torch_granule.save_granule(os.path.join(maiac, f"g{i}.npz"),
                                   _granule(i + 1, f"g{i}"))
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, UNetConfig(**KW))
    return root, ckpt


def _predictions(root):
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for f in sorted(os.listdir(out)):
        with np.load(os.path.join(out, f)) as d:
            preds[f] = {k: d[k] for k in d.files}
    return preds


def test_predict_model_fused_matches_jax_cli(tmp_path):
    """Both CLIs serve the JAX trainer's initial weights (PRNGKey(0), what
    ``plumekit predict_model`` serves with no checkpoint), carried over to
    the port's weights.pt."""
    root, ckpt = _root(tmp_path)
    assert jax_main(["predict_model", "--root", root, "--fused"] + SERVE) == 0
    want = _predictions(root)
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(variables))
    save_weights(ckpt, model)
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--fused"] + SERVE) == 0
    got = _predictions(root)
    assert sorted(got) == ["g0_pred.npz", "g1_pred.npz"] == sorted(want)
    for f in got:
        assert sorted(got[f]) == ["mask", "probs", "threshold"]
        p, q = got[f]["probs"], want[f]["probs"]
        assert p.shape == q.shape == (64, 64) and p.dtype == np.float32
        np.testing.assert_allclose(p, q, atol=PROB_TOL, rtol=0)
        sure = np.abs(q - 0.5) > PROB_TOL
        np.testing.assert_array_equal(got[f]["mask"][sure],
                                      want[f]["mask"][sure])
        assert float(got[f]["threshold"]) == 0.5


def test_predict_model_threshold_resolution(tmp_path):
    root, ckpt = _root(tmp_path)
    save_weights(ckpt, build_model(UNetConfig(**KW),
                                   torch.Generator().manual_seed(0)))
    base = ["predict_model", "--root", root, "--device", "cpu",
            "--batch-granules", "1"] + SERVE
    tpath = os.path.join(root, "models", "threshold.json")
    for payload, flags, want in [
            ({"threshold": 0.3}, [], 0.3),       # calibrated artifact
            ({"threshold": 0.3}, ["--threshold", "0.7"], 0.7),  # flag wins
            ("not json", [], 0.5)]:              # unreadable: default
        with open(tpath, "w") as f:
            f.write(payload if isinstance(payload, str)
                    else json.dumps(payload))
        assert cli.main(base + flags) == 0
        for pred in _predictions(root).values():
            assert float(pred["threshold"]) == pytest.approx(want)
            np.testing.assert_array_equal(pred["mask"],
                                          pred["probs"] > pred["threshold"])


@pytest.mark.parametrize("flags", [
    ["--int8"], ["--exported", "art"], ["--tta"], ["--mesh-devices", "2"],
    ["--tuned"], ["--prune-level", "2"], ["--quantize"],
    ["--quantize-output"], ["--plot"]])
def test_unported_flag_exits_1_naming_its_roadmap_item(tmp_path, caplog,
                                                       flags):
    with caplog.at_level(logging.ERROR):
        rc = cli.main(["predict_model", "--root", str(tmp_path),
                       "--device", "cpu"] + flags)
    assert rc == 1
    assert "not ported" in caplog.text and "ROADMAP.md" in caplog.text


def test_orbax_checkpoint_without_weights_exits_1(tmp_path, caplog):
    root, ckpt = _root(tmp_path)
    os.makedirs(os.path.join(ckpt, "step_00000010"))
    with caplog.at_level(logging.ERROR):
        assert cli.main(["predict_model", "--root", root, "--device",
                         "cpu"]) == 1
    assert "orbax" in caplog.text


def test_missing_cuda_is_an_error_not_a_fallback(tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with caplog.at_level(logging.ERROR):
        assert cli.main(["predict_model", "--root", str(tmp_path)]) == 1
    assert "CUDA is not available" in caplog.text
