"""plumekit_torch's granule files and command-line entry points against the
JAX package's: files read across packages, the two ``predict_model`` serve
the same weights to the same prediction files, and ``build_features`` (rg,
basic, gaussian, ``--batch-scenes``) and ``identify`` write and print what
the JAX CLI does on the same 256² roots."""

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_predict_model_use_mega_checkpoint_matches_jax_cli(tmp_path,
                                                           monkeypatch):
    """A checkpoint whose model_config.json says ``use_mega`` is served
    through the whole-forward path by both CLIs (its plain version here, the
    Pallas megakernel in interpret mode there) to the same prediction files;
    ``--fused`` on the same checkpoint takes the double-conv path instead,
    as in the JAX CLI."""
    from plumekit_torch.models.kernels import unet_mega
    from plumekit_torch.train.checkpoint import load_model_config

    root, ckpt = _root(tmp_path)
    save_model_config(ckpt, UNetConfig(**KW, use_mega=True))
    assert load_model_config(ckpt).use_mega
    assert jax_main(["predict_model", "--root", root] + SERVE) == 0
    want = _predictions(root)
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(variables))
    save_weights(ckpt, model)

    calls = []
    real = unet_mega.mega_forward_ref

    def counted(weights, x):
        calls.append(tuple(x.shape))
        return real(weights, x)

    monkeypatch.setattr(unet_mega, "mega_forward_ref", counted)
    assert cli.main(["predict_model", "--root", root, "--device", "cpu"]
                    + SERVE) == 0
    got = _predictions(root)
    served = len(calls)
    assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                     "--fused"] + SERVE) == 0
    fused = _predictions(root)
    assert served > 0 and len(calls) == served     # --fused took K6's path
    assert all(shape[1:3] == (32, 32) for shape in calls)
    assert sorted(got) == ["g0_pred.npz", "g1_pred.npz"] == sorted(want)
    for f in got:
        p, q = got[f]["probs"], want[f]["probs"]
        assert p.shape == q.shape == (64, 64) and p.dtype == np.float32
        np.testing.assert_allclose(p, q, atol=PROB_TOL, rtol=0)
        np.testing.assert_allclose(fused[f]["probs"], q, atol=PROB_TOL,
                                   rtol=0)
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


# ---------------------------------------------------------------- build_features

def _identify_root(tmp_path, name="root", seeds=(22, 25), **scene_kw):
    """A 256² synthetic root as ``plumekit make_dataset`` lays it out:
    granules with plumes, null holes and plume-less fires, one fire CSV."""
    from plumekit_torch.io.synthetic import (SyntheticSceneConfig,
                                             make_scene, write_fire_csv)

    root = str(tmp_path / name)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires_dir = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires_dir)
    tables = []
    kw = dict(size=256, n_plumes=3, background_level=0.2,
              background_noise=0.05, plume_amplitude=(0.6, 0.8),
              plume_sigma_major=(9.0, 14.0), plume_sigma_minor=(1.8, 2.6),
              extra_fires=2, null_blobs=1)
    kw.update(scene_kw)
    for seed in seeds:
        scene = make_scene(SyntheticSceneConfig(seed=seed, **kw))
        torch_granule.save_granule(
            os.path.join(maiac, scene.granule.name + ".npz"), scene.granule)
        tables.append(scene.fires)
    write_fire_csv(os.path.join(fires_dir, "fires.csv"),
                   {k: np.concatenate([t[k] for t in tables])
                    for k in tables[0]})
    return root


def _feature_outputs(root):
    """{relative path: parsed content} of every build_features output."""
    import pandas as pd

    out = {}
    full = os.path.join(root, "raw", "plume_identification", "dataframes",
                        "full")
    for sub in ("aod", "hull"):
        for f in sorted(os.listdir(os.path.join(full, sub))):
            out[f"{sub}/{f}"] = pd.read_csv(os.path.join(full, sub, f),
                                            dtype={"datetime": str})
    logs = os.path.join(root, "raw", "plume_identification", "logs")
    for f in sorted(os.listdir(logs)):
        with open(os.path.join(logs, f)) as fh:
            out[f"logs/{f}"] = fh.read().splitlines()
    masks = os.path.join(root, "interim", "plume_masks")
    for f in sorted(os.listdir(masks)) if os.path.isdir(masks) else []:
        with np.load(os.path.join(masks, f)) as d:
            out[f"masks/{f}"] = {k: d[k] for k in d.files}
    return out


def test_build_features_rg_matches_jax_cli(tmp_path):
    """``build_features --detector rg --device cpu`` writes the JAX CLI's
    CSVs (compared by value: integers exact, AOD mean/sd rtol 1e-5, as
    the sweep's float32 sums run in another order) and the same masks."""
    import shutil

    root = _identify_root(tmp_path)
    jax_root = str(tmp_path / "jax_root")
    shutil.copytree(root, jax_root)
    assert jax_main(["build_features", "--root", jax_root, "--detector",
                     "rg"]) == 0
    assert cli.main(["build_features", "--root", root, "--detector", "rg",
                     "--device", "cpu"]) == 0
    want, got = _feature_outputs(jax_root), _feature_outputs(root)
    assert any(k.startswith("masks/") for k in got), "no plume accepted"
    _assert_same_features(got, want)


def _assert_same_features(got, want):
    """Equal build_features outputs: the same files; work logs and masks
    equal; CSV columns by value, exact but for the AOD mean and sd."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k.startswith("logs/"):
            assert g == w, k
            continue
        if k.startswith("masks/"):
            assert sorted(g) == sorted(w)
            for pid in w:
                np.testing.assert_array_equal(g[pid], w[pid])
            continue
        assert list(g.columns) == list(w.columns) and len(g) == len(w), k
        for col in w.columns if len(w) else ():
            if col in ("plume_aod_mean", "plume_aod_sd"):
                np.testing.assert_allclose(g[col], w[col], rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(g[col].to_numpy(),
                                              w[col].to_numpy(), err_msg=k)


def _both_clis(tmp_path, flags, **root_kw):
    """The outputs of ``build_features <flags>`` from the port on the CPU
    and from the JAX CLI on copies of one root."""
    import shutil

    root = _identify_root(tmp_path, **root_kw)
    jax_root = str(tmp_path / "jax_root")
    shutil.copytree(root, jax_root)
    assert jax_main(["build_features", "--root", jax_root] + flags) == 0
    assert cli.main(["build_features", "--root", root, "--device", "cpu"]
                    + flags) == 0
    return _feature_outputs(root), _feature_outputs(jax_root)


def test_build_features_basic_matches_jax_cli(tmp_path):
    """One bounding-box row per plume in ``<base>_extent.csv``, a work log
    of the detector's own, no aod CSV and no masks."""
    got, want = _both_clis(tmp_path, ["--detector", "basic"],
                           seeds=(61, 62), background_level=0.05,
                           background_noise=0.02,
                           plume_amplitude=(0.5, 0.8),
                           plume_sigma_minor=(2.0, 3.0))
    _assert_same_features(got, want)
    assert sorted(got) == ["hull/SYNTH.00000061_extent.csv",
                           "hull/SYNTH.00000062_extent.csv",
                           "logs/basic_log.txt"]
    first = got["hull/SYNTH.00000061_extent.csv"]
    assert list(first.columns) == ["id", "plume_min_row", "plume_max_row",
                                   "plume_min_col", "plume_max_col"]
    assert sum(len(v) for k, v in got.items() if k.startswith("hull/")) >= 2


def test_build_features_gaussian_matches_jax_cli(tmp_path):
    """Hull vertices of every orbit layer with a ``datetime`` column; a
    granule under the 20-fire gate gets a header-only CSV."""
    got, want = _both_clis(tmp_path, ["--detector", "gaussian"],
                           seeds=(31,), n_layers=2, fires_per_plume=(7, 9),
                           extra_fires=6, null_blobs=2)
    _assert_same_features(got, want)
    assert sorted(got) == ["hull/SYNTH.00000031_extent.csv",
                           "logs/gaussian_log.txt"]
    hulls = got["hull/SYNTH.00000031_extent.csv"]
    assert list(hulls.columns) == ["id", "hull_lats", "hull_lons", "hull_x",
                                   "hull_y", "datetime"]
    assert len(hulls) >= 3 and hulls["datetime"].nunique() == 2


def test_build_features_gaussian_under_the_fire_gate(tmp_path):
    got, want = _both_clis(tmp_path, ["--detector", "gaussian"],
                           seeds=(32,), n_plumes=1, extra_fires=0)
    _assert_same_features(got, want)
    assert len(got["hull/SYNTH.00000032_extent.csv"]) == 0


def test_build_features_batch_scenes_matches_jax_cli(tmp_path):
    """Three granules in groups of two (a full group, then the rest),
    against the JAX CLI's ``--batch-scenes 2`` and the port's serial run."""
    import shutil

    seeds = (22, 25, 27)
    got, want = _both_clis(tmp_path, ["--batch-scenes", "2"], seeds=seeds)
    assert any(k.startswith("masks/") for k in got), "no plume accepted"
    _assert_same_features(got, want)
    assert got["logs/rg_log.txt"] == [f"SYNTH.000000{s}.npz" for s in seeds]
    serial = str(tmp_path / "serial")
    shutil.copytree(str(tmp_path / "root"), serial, ignore=lambda d, files: [
        f for f in files if f in ("dataframes", "logs", "interim")])
    assert cli.main(["build_features", "--root", serial, "--device",
                     "cpu"]) == 0
    _assert_same_features(got, _feature_outputs(serial))


def test_build_features_batch_scenes_flushes_on_a_shape_change(tmp_path):
    """A 128² granule between 256² ones ends the group before it; every
    granule still gets the serial run's files."""
    import shutil

    from plumekit_torch.io.synthetic import SyntheticSceneConfig, make_scene

    root = _identify_root(tmp_path, seeds=(22, 25))
    small = make_scene(SyntheticSceneConfig(size=128, n_plumes=1, seed=23))
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    torch_granule.save_granule(os.path.join(maiac, "SYNTH.00000023.npz"),
                               small.granule)
    serial = str(tmp_path / "serial")
    shutil.copytree(root, serial)
    assert cli.main(["build_features", "--root", root, "--device", "cpu",
                     "--batch-scenes", "3"]) == 0
    assert cli.main(["build_features", "--root", serial, "--device",
                     "cpu"]) == 0
    got = _feature_outputs(root)
    _assert_same_features(got, _feature_outputs(serial))
    assert len(got["logs/rg_log.txt"]) == 3


@pytest.mark.parametrize("flags,message", [
    (["--batch-scenes", "2", "--detector", "basic"], "rg detector only"),
    (["--batch-scenes", "2", "--detector", "gaussian"], "rg detector only"),
    (["--batch-scenes", "0"], "must be >= 1")])
def test_build_features_bad_batch_scenes_exits_1(tmp_path, caplog, flags,
                                                 message):
    with caplog.at_level(logging.ERROR):
        assert cli.main(["build_features", "--root", str(tmp_path),
                         "--device", "cpu"] + flags) == 1
    assert message in caplog.text


@pytest.mark.parametrize("detector", ["rg", "basic", "gaussian"])
def test_identify_prints_the_jax_count_and_writes_hulls(tmp_path, capsys,
                                                        detector):
    import pandas as pd

    root = _identify_root(tmp_path, seeds=(31,), n_layers=2,
                          fires_per_plume=(7, 9), extra_fires=6,
                          null_blobs=2)
    granule = os.path.join(root, "raw", "plume_identification", "maiac",
                           "SYNTH.00000031.npz")
    fires = os.path.join(root, "raw", "fires", "fires.csv")
    outs = [str(tmp_path / f"{who}.csv") for who in ("jax", "port")]
    args = [granule, fires, "--detector", detector, "--out"]
    assert jax_main(["identify"] + args + outs[:1]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(["identify", "--device", "cpu"] + args + outs[1:]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.endswith(" plumes")
    if detector != "basic":
        assert int(got.split()[0]) >= 1
    # basic has no hull table: neither CLI writes the file
    assert os.path.exists(outs[1]) == os.path.exists(outs[0]) \
        == (detector != "basic")
    if detector != "basic":
        w = pd.read_csv(outs[0], dtype={"datetime": str})
        g = pd.read_csv(outs[1], dtype={"datetime": str})
        _assert_same_features({"hull/out": g}, {"hull/out": w})


def test_identify_without_cuda_exits_1(tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with caplog.at_level(logging.ERROR):
        assert cli.main(["identify", "g.npz", "fires.csv"]) == 1
    assert "CUDA is not available" in caplog.text


def test_build_features_resumes_from_its_log(tmp_path, caplog):
    root = _identify_root(tmp_path)
    argv = ["build_features", "--root", root, "--device", "cpu",
            "--no-masks"]
    assert cli.main(argv) == 0
    log = os.path.join(root, "raw", "plume_identification", "logs",
                       "rg_log.txt")
    with open(log) as f:
        done = f.read().splitlines()
    assert done == ["SYNTH.00000022.npz", "SYNTH.00000025.npz"]
    assert not os.path.exists(os.path.join(root, "interim", "plume_masks"))
    aod_csv = os.path.join(root, "raw", "plume_identification",
                           "dataframes", "full", "aod",
                           "SYNTH.00000022_aod.csv")
    os.remove(aod_csv)
    with caplog.at_level(logging.INFO):
        assert cli.main(argv) == 0
    assert "already processed" in caplog.text
    assert not os.path.exists(aod_csv)
    with open(log) as f:
        assert f.read().splitlines() == done


@pytest.mark.parametrize("flags", [["--plot"]])
def test_build_features_unported_flag_exits_1(tmp_path, caplog, flags):
    with caplog.at_level(logging.ERROR):
        rc = cli.main(["build_features", "--root", str(tmp_path),
                       "--device", "cpu"] + flags)
    assert rc == 1
    assert "not ported" in caplog.text and "ROADMAP.md" in caplog.text


def test_build_features_without_cuda_or_fires_exits_1(tmp_path, caplog):
    with caplog.at_level(logging.ERROR):
        assert cli.main(["build_features", "--root", str(tmp_path),
                         "--device", "cpu"]) == 1
        assert "no fire table" in caplog.text
        if not torch.cuda.is_available():
            assert cli.main(["build_features", "--root",
                             str(tmp_path)]) == 1
            assert "CUDA is not available" in caplog.text


def test_build_features_empty_fire_table_writes_empty_tables(tmp_path):
    """A fire CSV without rows labels no plume: both CSVs hold only their
    header and no mask file is written."""
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    os.makedirs(os.path.join(root, "raw", "fires"))
    torch_granule.save_granule(os.path.join(maiac, "g0.npz"),
                               _granule(3, "g0"))
    with open(os.path.join(root, "raw", "fires", "fires.csv"), "w") as f:
        f.write("latitude,longitude,frp,acq_date\n")
    assert cli.main(["build_features", "--root", root, "--device",
                     "cpu"]) == 0
    full = os.path.join(root, "raw", "plume_identification", "dataframes",
                        "full")
    for sub, name in (("aod", "g0_aod.csv"), ("hull", "g0_extent.csv")):
        with open(os.path.join(full, sub, name)) as f:
            assert len(f.read().splitlines()) == 1
    assert not os.path.exists(os.path.join(root, "interim", "plume_masks"))
