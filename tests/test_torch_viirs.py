"""``plumekit_torch/io/viirs.py`` against ``plumekit/io/viirs.py``: the
swath container and its ``.npz`` round trip, the synthetic swath and the
reprojected rasters bit for bit, the ``reprojected_viirs/h5`` product's
datasets and attributes, and the quicklook PNGs' pixels."""

import os

import numpy as np
import pytest
import torch

from plumekit.io import viirs as jax_viirs
from plumekit_torch.io import viirs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


SWATHS = [dict(lines=96, samples=128, seed=0),
          dict(lines=96, samples=128, seed=3, track_azimuth_deg=-30.0),
          dict(lines=12, samples=16, seed=1, center_lat=52.0,
               center_lon=-179.9, edge_growth=3.0)]


@pytest.mark.parametrize("kw", SWATHS)
def test_synthetic_swath_equals_the_jax_package(kw):
    got, want = viirs.make_synthetic_swath(**kw), \
        jax_viirs.make_synthetic_swath(**kw)
    assert got.name == want.name and got.shape == want.shape
    _same(got.lat, want.lat)
    _same(got.lon, want.lon)
    assert list(got.channels) == list(want.channels)
    for ch in want.channels:
        _same(got.channels[ch], want.channels[ch])


def test_swath_round_trip_and_cross_reading(tmp_path):
    swath = viirs.make_synthetic_swath(lines=12, samples=16, seed=3,
                                       name="s3")
    path = str(tmp_path / "s3.npz")
    viirs.save_swath(path, swath)
    for back in (viirs.load_swath(path), jax_viirs.load_swath(path)):
        assert back.name == "s3"
        assert sorted(back.channels) == ["aod", "blue", "green", "red"]
        _same(back.lat, swath.lat)
        _same(back.lon, swath.lon)
        for ch in swath.channels:
            _same(back.channels[ch], swath.channels[ch])
    jax_path = str(tmp_path / "j.npz")
    jax_viirs.save_swath(jax_path, jax_viirs.make_synthetic_swath(
        lines=12, samples=16, seed=3, name="s3"))
    back = viirs.load_swath(jax_path)
    _same(back.channels["blue"], swath.channels["blue"])


@pytest.mark.parametrize("kw", SWATHS)
@pytest.mark.parametrize("pixel,radius", [(750.0, 10000.0), (1000.0, 10000.0),
                                          (2000.0, 900.0)])
def test_reproject_swath_equals_the_jax_package(kw, pixel, radius):
    swath = viirs.make_synthetic_swath(**kw)
    swath.channels["const"] = np.full(swath.shape, 0.625, np.float32)
    rs, rasters = viirs.reproject_swath(swath, pixel, radius)
    jrs, jrasters = jax_viirs.reproject_swath(
        jax_viirs.Swath(swath.lat, swath.lon, dict(swath.channels)),
        pixel, radius)
    _same(rs.index_map, jrs.index_map)
    _same(rs.valid, jrs.valid)
    assert list(rasters) == list(jrasters)
    for ch in jrasters:
        _same(rasters[ch], jrasters[ch])
    valid = rasters["const"] != viirs.FILL_VALUE
    assert np.all(rasters["const"][valid] == np.float32(0.625))
    assert np.isin(rasters["blue"][valid], swath.channels["blue"]).all()


def _h5_contents(path):
    import h5py

    with h5py.File(path, "r") as f:
        data = {k: np.asarray(f[k]) for k in f}
        attrs = {k: np.asarray(v) for k, v in f.attrs.items()}
    return data, attrs


def test_reprojected_h5_equals_the_jax_package(tmp_path):
    pytest.importorskip("h5py")
    swath = viirs.make_synthetic_swath(lines=64, samples=96, seed=2)
    rs, rasters = viirs.reproject_swath(swath, 1500.0)
    jrs, jrasters = jax_viirs.reproject_swath(swath, 1500.0)
    viirs.write_reprojected_h5(str(tmp_path / "p.h5"), rs, rasters)
    jax_viirs.write_reprojected_h5(str(tmp_path / "j.h5"), jrs, jrasters)
    got, got_attrs = _h5_contents(str(tmp_path / "p.h5"))
    want, want_attrs = _h5_contents(str(tmp_path / "j.h5"))
    assert sorted(got) == sorted(want) == ["aod", "blue", "green", "red",
                                           "valid"]
    for k in want:
        _same(got[k], want[k])
    assert sorted(got_attrs) == sorted(want_attrs)
    for k in want_attrs:
        _same(got_attrs[k], want_attrs[k])
    assert float(got_attrs["pixel_size_m"]) == 1500.0
    assert (got["aod"][~got["valid"]] == viirs.FILL_VALUE).all()


def test_quicklooks_pixels_equal_the_jax_package(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg

    swath = viirs.make_synthetic_swath(lines=48, samples=64, seed=4)
    _, rasters = viirs.reproject_swath(swath, 1000.0)
    rasters["blue"][:3] = viirs.FILL_VALUE
    for name, fn in (("p", viirs.write_quicklooks),
                     ("j", jax_viirs.write_quicklooks)):
        for sub in ("blue", "tcc"):
            os.makedirs(tmp_path / name / sub)
        fn("s", rasters, str(tmp_path / name / "blue"),
           str(tmp_path / name / "tcc"))
    for sub, fname in (("blue", "s_blue.png"), ("tcc", "s_tcc.png")):
        got = mpimg.imread(str(tmp_path / "p" / sub / fname))
        want = mpimg.imread(str(tmp_path / "j" / sub / fname))
        assert got.shape[:2] == rasters["blue"].shape
        _same(got, want)
