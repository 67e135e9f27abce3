"""``plumekit_torch/io/viirs_aod.py`` against ``plumekit/io/viirs_aod.py``:
IDPS stamps and pairing, the synthetic IVAOT scene (rasters, and the fire
table column by column), the masked-source resample (NaN where the JAX
one has NaN) and the notebook's identify on the CPU against the JAX
``identify_viirs_aod``: plume dicts equal, images equal in value and
dtype. Everything compared here is exact."""

import datetime
import os

import numpy as np
import pytest
import torch

from plumekit.io import viirs_aod as jax_va
from plumekit_torch.io import viirs_aod as va


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


NOTEBOOK_AOD = ("IVAOT_npp_d20160822_t1702001_e1703242_b24974"
                "_c20181017161815133750_noaa_ops.h5")
NOTEBOOK_GEO = ("GMTCO_npp_d20160822_t1702001_e1703242_b24974"
                "_c20181019184439006772_noaa_ops.h5")


@pytest.mark.parametrize("fname", [NOTEBOOK_AOD, NOTEBOOK_GEO,
                                   "notagranule.h5", "IVAOT_npp_d2016.h5",
                                   "/some/dir/" + NOTEBOOK_AOD])
def test_stamp_parse_equals_the_jax_package(fname):
    got, want = va.parse_granule_filename(fname), \
        jax_va.parse_granule_filename(fname)
    if want is None:
        assert got is None
        return
    assert (got.product, got.platform, got.date, got.start, got.end,
            got.orbit) == (want.product, want.platform, want.date,
                           want.start, want.end, want.orbit)
    assert got.key == want.key
    assert va.format_granule_filename(got) == \
        jax_va.format_granule_filename(want)
    assert va.parse_granule_filename(va.format_granule_filename(got)) == got


def test_notebook_pair_shares_its_key():
    sa = va.parse_granule_filename(NOTEBOOK_AOD)
    sg = va.parse_granule_filename(NOTEBOOK_GEO)
    assert sa.product == "IVAOT" and sg.product == "GMTCO"
    assert sa.date == datetime.date(2016, 8, 22) and sa.orbit == 24974
    assert sa.key == sg.key


def _pair_dirs(root, seeds):
    aod_dir, geo_dir = os.path.join(root, "aod"), os.path.join(root, "geo")
    os.makedirs(aod_dir)
    os.makedirs(geo_dir)
    scenes = []
    for seed in seeds:
        scene = va.make_synthetic_ivaot_scene(seed=seed)
        va.write_synthetic_pair(aod_dir, geo_dir, *scene[:4])
        scenes.append(scene)
    return aod_dir, geo_dir, scenes


def test_pairing_equals_the_jax_package(tmp_path):
    pytest.importorskip("h5py")
    import h5py

    aod_dir, geo_dir, _ = _pair_dirs(str(tmp_path), (2, 0, 1))
    # an IVAOT without its GMTCO, a foreign file and a GMTCO alone
    lone = va.GranuleStamp("IVAOT", "npp", datetime.date(2016, 8, 21),
                           "0000001", "0001242", 99999)
    with h5py.File(os.path.join(aod_dir, va.format_granule_filename(lone)),
                   "w") as f:
        f.create_dataset(va.IVAOT_DATASET, data=np.zeros((4, 4), np.float32))
    open(os.path.join(aod_dir, "readme.txt"), "w").close()
    geo_only = va.GranuleStamp("GMTCO", "npp", datetime.date(2016, 8, 23),
                               "0000001", "0001242", 5)
    open(os.path.join(geo_dir, va.format_granule_filename(geo_only)),
         "w").close()
    got, want = va.pair_granules(aod_dir, geo_dir), \
        jax_va.pair_granules(aod_dir, geo_dir)
    assert [(p["aod"], p["geo"]) for p in got] == \
        [(p["aod"], p["geo"]) for p in want]
    assert [p["stamp"].orbit for p in got] == [24974, 24975, 24976]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n_plumes", [1, 2])
def test_synthetic_scene_equals_the_jax_package(seed, n_plumes):
    stamp, aod, lat, lon, fires, origins = va.make_synthetic_ivaot_scene(
        seed=seed, n_plumes=n_plumes)
    jstamp, jaod, jlat, jlon, jfires, jorigins = \
        jax_va.make_synthetic_ivaot_scene(seed=seed, n_plumes=n_plumes)
    assert (stamp.product, stamp.platform, stamp.date, stamp.start,
            stamp.end, stamp.orbit) == (jstamp.product, jstamp.platform,
                                        jstamp.date, jstamp.start, jstamp.end,
                                        jstamp.orbit)
    _same(aod, jaod)
    _same(lat, jlat)
    _same(lon, jlon)
    assert origins == jorigins
    for col in ("latitude", "longitude", "frp"):
        _same(fires[col], jfires[col].to_numpy())
    assert list(fires["acq_date"]) == list(jfires["acq_date"])
    _same(fires["date_time"],
          jfires["date_time"].to_numpy().astype("datetime64[D]"))


def _as_read(lat, lon):
    """Geolocation as the GMTCO round trip gives it: float32 on disk,
    float64 when read."""
    return (np.asarray(lat, np.float32).astype(np.float64),
            np.asarray(lon, np.float32).astype(np.float64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geo_fills", [False, True])
def test_resample_equals_the_jax_package(seed, geo_fills):
    _, aod, lat, lon, _, _ = va.make_synthetic_ivaot_scene(seed=seed)
    lat, lon = _as_read(lat, lon)
    if geo_fills:
        lat[:2], lon[:2] = -999.3, -999.3
    rs, aod_r, lat_g, lon_g = va.resample_viirs_aod(aod, lat, lon)
    jrs, jaod_r, jlat_g, jlon_g = jax_va.resample_viirs_aod(aod, lat, lon)
    _same(rs.index_map, jrs.index_map)
    _same(rs.valid, jrs.valid)
    _same(aod_r, jaod_r)           # NaN exactly where the JAX one has NaN
    _same(lat_g, jlat_g)
    _same(lon_g, jlon_g)
    assert np.isnan(aod_r).any()
    assert (aod_r[np.isfinite(aod_r)] >= 0).all()


def test_identify_arrays_on_the_cpu_equals_the_jax_package(tmp_path):
    pytest.importorskip("h5py")
    aod_dir, geo_dir, scenes = _pair_dirs(str(tmp_path), (0, 1, 2))
    pairs = jax_va.pair_granules(aod_dir, geo_dir)
    found = 0
    for pair, scene in zip(pairs, scenes):
        stamp, aod, lat, lon, fires, _ = scene
        jdict, jimage, jaod_r, _ = jax_va.identify_viirs_aod(
            pair["aod"], pair["geo"], jax_va.make_synthetic_ivaot_scene(
                seed=stamp.orbit - 24974)[4])
        lat, lon = _as_read(lat, lon)
        got = va.identify_viirs_arrays(aod, lat, lon,
                                       np.datetime64(stamp.date), fires,
                                       device="cpu")
        from_files = va.identify_viirs_aod(pair["aod"], pair["geo"], fires,
                                           device="cpu")
        for plume_dict, image, aod_r, _ in (got, from_files):
            assert plume_dict == jdict
            _same(image, np.asarray(jimage))
            _same(aod_r, jaod_r)
        found += len(jdict)
    assert found >= 3


def test_identify_refuses_mispaired_and_misnamed_files(tmp_path):
    pytest.importorskip("h5py")
    aod_dir, geo_dir, _ = _pair_dirs(str(tmp_path), (0,))
    pair = va.pair_granules(aod_dir, geo_dir)[0]
    with pytest.raises(ValueError, match="not an IDPS granule"):
        va.identify_viirs_aod(pair["geo"].replace("GMTCO_npp", "x"),
                              pair["geo"], {}, device="cpu")
    other = va.make_synthetic_ivaot_scene(lines=48, samples=64, seed=9)
    stamp = va.GranuleStamp("IVAOT", "npp", datetime.date(2016, 8, 22),
                            "1702001", "1703242", 77)
    small_aod, _ = va.write_synthetic_pair(aod_dir, geo_dir, stamp,
                                           *other[1:4])
    with pytest.raises(ValueError, match="mispaired"):
        va.identify_viirs_aod(small_aod, pair["geo"], other[4], device="cpu")


def test_readers_keep_fills_and_widen_geolocation(tmp_path):
    pytest.importorskip("h5py")
    aod_dir, geo_dir, scenes = _pair_dirs(str(tmp_path), (3,))
    pair = va.pair_granules(aod_dir, geo_dir)[0]
    aod = va.read_ivaot_aod(pair["aod"])
    lat, lon = va.read_gmtco_geo(pair["geo"])
    _same(aod, jax_va.read_ivaot_aod(pair["aod"]))
    for got, want in zip((lat, lon), jax_va.read_gmtco_geo(pair["geo"])):
        _same(got, want)
    assert aod.dtype == np.float32 and (aod < 0).any()
    assert lat.dtype == np.float64
    _same(aod, scenes[0][1])
