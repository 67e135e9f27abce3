"""``plumekit_torch/io/verify.py`` and ``verify_real_granule`` against
``plumekit/io/verify.py`` and the JAX CLI: the summaries, and every check's
name, status and detail (the identify check's plume count; its date is
printed in each package's own type), on ``.npz`` and ``.h5`` synthetic
granules, with the detector off, on a value-range violation and on a
missing file; a ``.hdf`` path fails the decode check with the port's named
message, never as UNNAMED; and the CLI's exit codes."""

import json
import os

import numpy as np
import pytest
import torch

from plumekit import cli as jax_cli
from plumekit.io import verify as jax_verify
from plumekit_torch import cli
from plumekit_torch.io import verify
from plumekit_torch.io.granule import Granule, save_granule
from plumekit_torch.io.synthetic import (SyntheticSceneConfig, make_scene,
                                         write_fire_csv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granules(tmp_path_factory):
    """The JAX tests' synthetic granule as ``.npz`` and ``.h5``, its fire
    CSV, and an unscaled-counts granule."""
    d = tmp_path_factory.mktemp("verify")
    scene = make_scene(SyntheticSceneConfig(
        size=128, n_plumes=2, seed=3, background_level=0.2,
        background_noise=0.05, fires_per_plume=(4, 6)))
    out = {"fires": str(d / "fires.csv")}
    write_fire_csv(out["fires"], scene.fires)
    for ext in ("npz", "h5"):
        out[ext] = str(d / f"scene.{ext}")
        save_granule(out[ext], scene.granule)
    lat, lon = np.mgrid[40:41:32j, -105:-104:32j]
    out["raw"] = str(d / "raw.npz")
    save_granule(out["raw"], Granule(
        layers={"t0": np.full((32, 32), 1500.0, np.float32)}, lat=lat,
        lon=lon, name="raw_counts"))
    return out


def _same_result(got, want):
    assert got.summary() == want.summary()
    assert [(c.name, c.status) for c in got.checks] == \
        [(c.name, c.status) for c in want.checks]
    for g, w in zip(got.checks, want.checks):
        if g.name == "identify" and g.status == "pass":
            assert g.detail.split(" at ")[0] == w.detail.split(" at ")[0]
        else:
            assert g.detail == w.detail


@pytest.mark.parametrize("ext", ["npz", "h5"])
@pytest.mark.parametrize("detector", ["rg", "basic"])
def test_summaries_equal_the_jax_package(granules, ext, detector):
    if ext == "h5":
        pytest.importorskip("h5py")
    kw = dict(fires_csv=granules["fires"], detector=detector)
    got = verify.verify_granule(granules[ext], device="cpu", **kw)
    want = jax_verify.verify_granule(granules[ext], **kw)
    _same_result(got, want)
    assert got.ok, got.summary()
    names = {c.name for c in got.checks}
    assert {"decode", "layers", "grid_shape", "lat_range", "lon_range",
            "utm_resample", "identify"} <= names
    if detector == "basic":
        ident = next(c for c in got.checks if c.name == "identify")
        assert int(ident.detail.split(": ")[1].split()[0]) >= 1


@pytest.mark.parametrize("case", ["no_identify", "no_fires", "raw_counts",
                                  "missing"])
def test_other_outcomes_equal_the_jax_package(granules, tmp_path, case):
    path = {"no_identify": granules["npz"], "no_fires": granules["npz"],
            "raw_counts": granules["raw"],
            "missing": str(tmp_path / "nope.npz")}[case]
    kw = {"no_identify": dict(fires_csv=granules["fires"],
                              run_identify=False),
          "no_fires": {}, "raw_counts": dict(run_identify=False),
          "missing": {}}[case]
    got = verify.verify_granule(path, device="cpu", **kw)
    _same_result(got, jax_verify.verify_granule(path, **kw))
    assert got.ok == (case in ("no_identify", "no_fires"))
    if case == "raw_counts":
        assert any(c.name.startswith("values") and c.status == "fail"
                   for c in got.checks)


def test_hdf_fails_decode_by_name(tmp_path):
    path = tmp_path / "MCD19A2.A2017255.h12v09.006.hdf"
    path.touch()
    res = verify.verify_granule(str(path), device="cpu")
    assert not res.ok
    assert [c.name for c in res.checks] == ["decode"]
    assert "UNNAMED" not in res.checks[0].detail
    # an empty file is no HDF4 file: the reader's named error
    assert "not an HDF4 file" in res.checks[0].detail


def test_an_unnamed_reader_error_is_reported_as_such(tmp_path):
    path = tmp_path / "no_grid.npz"
    np.savez(path, aod_t0=np.zeros((4, 4), np.float32))     # no lat, lon
    res = verify.verify_granule(str(path), device="cpu")
    assert res.checks[0].status == "fail"
    assert res.checks[0].detail.startswith("UNNAMED")
    want = jax_verify.verify_granule(str(path))
    assert res.summary() == want.summary()


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_exit_codes_and_summaries(granules, tmp_path, capsys):
    argv = [granules["npz"], "--fires", granules["fires"], "--detector",
            "basic"]
    assert cli.main(["verify_real_granule", *argv, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert jax_cli.main(["verify_real_granule", *argv]) == 0
    assert got == _last_json(capsys)
    assert got["ok"] and not got["failed"]
    assert cli.main(["verify_real_granule", granules["npz"], "--fires",
                     granules["fires"], "--no-identify", "--device",
                     "cpu"]) == 0
    assert _last_json(capsys)["skipped"] == ["identify"]
    missing = str(tmp_path / "missing.hdf")
    assert cli.main(["verify_real_granule", missing, "--device", "cpu"]) == 1
    assert _last_json(capsys)["failed"] == ["exists"]
    assert cli.main(["verify_real_granule", granules["raw"], "--device",
                     "cpu"]) == 1


def test_cli_needs_a_card_unless_told_the_cpu(granules, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["verify_real_granule", granules["npz"]]) == 1
    assert capsys.readouterr().out == ""
    assert os.path.exists(granules["npz"])
