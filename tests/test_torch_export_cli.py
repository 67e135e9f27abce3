"""``export_model`` and ``--exported`` of plumekit_torch's CLI on the CPU:
``export_model`` → ``predict_model --exported`` and ``serve --once
--exported`` equal to the live ``predict_model`` bit for bit for every
forward (plain, a ``use_pallas`` and a ``use_mega`` checkpoint, ``--int8``,
``--tta``, a UNet++ at ``--prune-level``) at G = 1 and G = 3, with
``--quantize`` and ``--quantize-output``; an int8 artifact calibrating on
its recorded tile; and every refusal with the JAX CLI's message
(``plumekit/cli.py:511-546``, ``:667-670``)."""

import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.cli import main as jax_main
from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import export as jax_export
from plumekit.models import UNet as JaxUNet
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.infer.export import is_artifact
from plumekit_torch.io import granule as torch_granule
from plumekit_torch.models import build_model
from plumekit_torch.train.checkpoint import save_model_config, save_weights
from test_torch_cli import KW, SERVE, _granule

#: per forward: the checkpoint's config flags and the flags of both
#: export_model and the live predict_model
FORWARDS = {
    "plain": ({}, []),
    "use_pallas": ({"use_pallas": True}, []),
    "use_mega": ({"use_mega": True}, []),
    "int8": ({}, ["--int8"]),
    "tta": ({}, ["--tta"]),
    "unetpp": ({"arch": "unetpp", "deep_supervision": True},
               ["--prune-level", "1"]),
}
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root(tmp_path, **flags):
    """Three 64² granules and a seeded checkpoint of ``KW`` with ``flags``
    in its config."""
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    for i in range(3):
        torch_granule.save_granule(os.path.join(maiac, f"g{i}.npz"),
                                   _granule(i + 1, f"g{i}"))
    cfg = UNetConfig(**KW, **flags)
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, cfg)
    save_weights(ckpt, build_model(cfg, torch.Generator().manual_seed(3)))
    return root


def _served(root):
    """The probabilities written, by file; the predictions are cleared."""
    out = os.path.join(root, "processed", "predictions")
    probs = {}
    for f in sorted(os.listdir(out)):
        if f.endswith(".npz"):
            with np.load(os.path.join(out, f)) as d:
                probs[f] = d["probs"]
                np.testing.assert_array_equal(d["mask"],
                                              d["probs"] > d["threshold"])
    shutil.rmtree(out)
    return probs


def _export(root, art, granules, *flags):
    return cli.main(["export_model", "--root", root, "--granule", "64",
                     "--batch-granules", str(granules), "--platforms", "cpu",
                     "--out", art] + SERVE + list(flags))


def _assert_equal(got, want):
    assert sorted(got) == sorted(want) and len(want) == 3
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("granules", [1, 3])
@pytest.mark.parametrize("forward", list(FORWARDS))
def test_exported_serving_equals_live(tmp_path, forward, granules):
    cfg_flags, flags = FORWARDS[forward]
    root = _root(tmp_path, **cfg_flags)
    art = str(tmp_path / "artifact")
    assert _export(root, art, granules, *flags) == 0 and is_artifact(art)
    assert cli.main(["predict_model", "--root", root, "--batch-granules",
                     str(granules)] + CPU + SERVE + flags) == 0
    live = _served(root)
    # the program is baked: no geometry or forward flag is needed
    assert cli.main(["predict_model", "--root", root, "--exported",
                     art] + CPU) == 0
    _assert_equal(_served(root), live)
    assert cli.main(["serve", "--root", root, "--once", "--settle", "0",
                     "--exported", art] + CPU) == 0
    _assert_equal(_served(root), live)


@pytest.mark.parametrize("flag", ["--quantize", "--quantize-output"])
def test_exported_serving_with_quantized_transfers(tmp_path, flag):
    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    assert _export(root, art, 3) == 0
    assert cli.main(["predict_model", "--root", root, "--batch-granules",
                     "3", flag] + CPU + SERVE) == 0
    live = _served(root)
    assert cli.main(["predict_model", "--root", root, "--exported", art,
                     flag] + CPU) == 0
    _assert_equal(_served(root), live)


def test_int8_artifact_calibrates_on_its_recorded_tile(tmp_path, caplog):
    """As the JAX CLI: the artifact's tile size, not ``--tile``, sets the
    calibration grid, so serving it does not depend on the flag."""
    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    assert _export(root, art, 3, "--int8") == 0
    runs = []
    for tile in ([], ["--tile", "64"]):
        with caplog.at_level(logging.INFO):
            assert cli.main(["predict_model", "--root", root, "--exported",
                             art, "--int8"] + CPU + tile) == 0
        assert "calibrated on 9 32² tiles" in caplog.text
        caplog.clear()
        runs.append(_served(root))
    _assert_equal(runs[1], runs[0])


def _error(caplog, main, argv):
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        assert main(argv) == 1
    return [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR]


@pytest.mark.parametrize("command", ["predict_model", "serve"])
@pytest.mark.parametrize("flags", [["--tta"], ["--mesh-devices", "2"],
                                   ["--tuned"]])
def test_refusals_give_the_jax_clis_messages(tmp_path, caplog, command,
                                             flags):
    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    extra = ["--once", "--settle", "0"] if command == "serve" else []
    got = _error(caplog, cli.main, [command, "--root", root, "--exported",
                                    art] + CPU + extra + flags)
    want = _error(caplog, jax_main, [command, "--root", root, "--exported",
                                     art] + extra + flags)
    assert got == want and "mutually exclusive" in got[0]
    assert not os.path.exists(os.path.join(root, "processed"))


@pytest.mark.parametrize("command", ["predict_model", "serve"])
def test_int8_with_an_fp_artifact_is_refused(tmp_path, caplog, command):
    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    assert _export(root, art, 1) == 0
    extra = ["--once", "--settle", "0"] if command == "serve" else []
    got = _error(caplog, cli.main, [command, "--root", root, "--exported",
                                    art, "--int8"] + CPU + extra)
    assert got == [f"--int8 passed but {art} was exported with the fp "
                   "forward; re-export with export_model --int8"]


def test_a_jax_artifact_is_refused_with_a_message(tmp_path, caplog):
    cfg = JaxUNetConfig(**KW)
    variables = JaxUNet(cfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 2)), train=False)
    exported, meta = jax_export.export_sliding_infer(
        variables, cfg, JaxInferConfig(tile_size=32, overlap=8,
                                       batch_tiles=4), (64, 64),
        platforms=["cpu"])
    jart = str(tmp_path / "jax_artifact")
    jax_export.save_exported(exported, meta, jart)
    root = _root(tmp_path)
    got = _error(caplog, cli.main, ["predict_model", "--root", root,
                                    "--exported", jart] + CPU)
    assert len(got) == 1 and "artifact of the JAX package" in got[0]
    assert "export_model" in got[0]


@pytest.mark.parametrize("platforms", ["gpu", "tpu,cpu"])
def test_export_model_refuses_a_platform_it_cannot_trace(tmp_path, caplog,
                                                         platforms):
    """``gpu`` is traced on a card: without one it exits 1 and never writes
    a CPU program under the card's name."""
    if platforms == "gpu" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    got = _error(caplog, cli.main, ["export_model", "--root", root,
                                    "--granule", "64", "--platforms",
                                    platforms, "--out", art])
    assert got[0].startswith("export failed:")
    assert not os.path.exists(art)


def test_export_model_pads_the_granule_and_records_the_geometry(tmp_path):
    import json

    root = _root(tmp_path)
    art = str(tmp_path / "artifact")
    assert cli.main(["export_model", "--root", root, "--granule", "61",
                     "--granule-width", "70", "--batch-granules", "2",
                     "--threshold", "0.3", "--platforms", "cpu", "--out",
                     art] + SERVE) == 0
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["granule_hw"] == [64, 72] and meta["granules"] == 2
    assert meta["threshold"] == pytest.approx(0.3)
    assert (meta["tile_size"], meta["overlap"], meta["batch_tiles"]) == (
        32, 8, 4)
    assert meta["forward"] == "flax" and meta["route"] == "module"
    cfg = dataclasses.asdict(UNetConfig(**KW))
    assert meta["depth"] == cfg["depth"] and meta["in_channels"] == 2
