"""The basic and gaussian detectors, the config-typed ``identify`` and the
multi-scene rg entry of plumekit_torch against the JAX package on the
same synthetic scenes, and against the clean-room oracles as the JAX
package's own parity tests use them.

Tolerances: integer and boolean outputs (``near``, ``plume``, ``label``,
``area``, ``bbox``, ``plume_image``, accepted sets, masks, plume ids, hull
vertices in pixels) are exact; hull latitudes and longitudes are lookups
in the same grid, so exact too; the rg table's AOD mean and sd are float32
sums taken in another order, so rtol 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.config.identify import BasicIdentifyConfig as JaxBasicCfg
from plumekit.config.identify import GaussianIdentifyConfig as JaxGaussCfg
from plumekit.config.identify import RGIdentifyConfig as JaxRGCfg
from plumekit.identify import api as jax_api
from plumekit.identify import basic as jax_basic
from plumekit.identify import gaussian as jax_gaussian
from plumekit.identify import rg as jax_rg
from plumekit.io import synthetic as jax_synthetic
from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                            BlobIdentifyConfig,
                                            GaussianIdentifyConfig,
                                            RGIdentifyConfig)
from plumekit_torch.identify import api, basic, gaussian, rg
from plumekit_torch.identify.locate import pad_fires
from plumekit_torch.identify.pipeline import make_sweep_identifier
from plumekit_torch.io import synthetic
from plumekit_torch.ops.cluster import raster_cluster_centroids
from plumekit_torch.ops.inpaint import nearest_fill

sys.path.insert(0, os.path.dirname(__file__))
from oracle_basic import oracle_basic_identify  # noqa: E402
from oracle_gaussian import oracle_identify_layer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLOAT_RTOL = 1e-5
RG_KW = dict(size=256, n_plumes=3, background_level=0.2,
             background_noise=0.05, plume_amplitude=(0.6, 0.8),
             plume_sigma_major=(9.0, 14.0), plume_sigma_minor=(1.8, 2.6))
# the scenes of tests/test_identify_basic_parity.py
BASIC_KW = dict(size=256, n_plumes=3, background_level=0.05,
                background_noise=0.02, plume_amplitude=(0.5, 0.8),
                plume_sigma_major=(9.0, 14.0), plume_sigma_minor=(2.0, 3.0))
BASIC_CFG, JAX_BASIC_CFG = (c(max_fires=16)
                            for c in (BasicIdentifyConfig, JaxBasicCfg))
# the scenes of tests/test_identify_gaussian_parity.py
GAUSS_KW = dict(RG_KW, fires_per_plume=(7, 9))
GAUSS_CFG, JAX_GAUSS_CFG = (c(max_fires=32)
                            for c in (GaussianIdentifyConfig, JaxGaussCfg))


def _scenes(seed, **kw):
    return (jax_synthetic.make_scene(
                jax_synthetic.SyntheticSceneConfig(seed=seed, **kw)),
            synthetic.make_scene(synthetic.SyntheticSceneConfig(seed=seed,
                                                                **kw)))


def _assert_tables_equal(table, df):
    df = df.reset_index(drop=True)
    assert list(table.columns) == list(df.columns)
    assert len(table) == len(df)
    for col in table.columns:
        if col == "datetime":
            assert table.column(col) == df[col].tolist()
            continue
        got = np.asarray(table.column(col), dtype=np.float64)
        want = df[col].to_numpy(dtype=np.float64)
        if col in ("plume_aod_mean", "plume_aod_sd"):
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)


def test_configs_equal_the_jax_package_field_for_field():
    import dataclasses

    from plumekit.config.identify import BlobIdentifyConfig as JaxBlobCfg

    for ours, theirs in ((BasicIdentifyConfig, JaxBasicCfg),
                         (GaussianIdentifyConfig, JaxGaussCfg),
                         (RGIdentifyConfig, JaxRGCfg),
                         (BlobIdentifyConfig, JaxBlobCfg)):
        a, b = dataclasses.asdict(ours()), dataclasses.asdict(theirs())
        assert a == b and list(a) == list(b)
    assert GaussianIdentifyConfig().threshold_sets() == \
        JaxGaussCfg().threshold_sets()
    assert [len(t) for t in GaussianIdentifyConfig().threshold_sets()] == \
        [25, 25, 25]


# ------------------------------------------------------------------- basic

BASIC_SCENES = {
    "seed61": (61, BASIC_KW, True),
    "seed62": (62, BASIC_KW, True),
    "seed63": (63, BASIC_KW, True),
    # null windows: a negative sub-window mean must fail the ratio screen
    "nulls71": (71, dict(BASIC_KW, null_blobs=6, null_blob_sigma=8.0), False),
    # tests/test_identify.py's basic scene
    "seed41": (41, RG_KW, True),
}


def _basic_inputs(name):
    seed, kw, zero_negatives = BASIC_SCENES[name]
    js, ts = _scenes(seed, **kw)
    aod = ts.granule.first_layer().copy()
    if zero_negatives:
        aod[aod < 0] = 0.0
    return js, ts, aod


@pytest.mark.parametrize("name", sorted(BASIC_SCENES))
def test_basic_program_equals_jax(name):
    """Every output of the device program, fire slot by fire slot."""
    js, ts, aod = _basic_inputs(name)
    g = ts.granule
    f_rows, f_cols, f_valid = basic._prep_fires(
        g.lat, g.lon, ts.fires["date_time"][0], ts.fires, BASIC_CFG)
    assert f_valid.sum() >= 3
    want = jax_basic._make_program(JAX_BASIC_CFG)(
        jnp.asarray(aod), jnp.asarray(f_rows), jnp.asarray(f_cols),
        jnp.asarray(f_valid))
    got = basic._make_program(BASIC_CFG)(
        torch.from_numpy(aod), torch.from_numpy(f_rows),
        torch.from_numpy(f_cols), torch.from_numpy(f_valid))
    assert sorted(got) == sorted(want)
    for k in ("near", "plume", "label", "area", "bbox", "plume_image"):
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("name", sorted(BASIC_SCENES))
def test_basic_identify_equals_jax_and_oracle(name):
    js, ts, aod = _basic_inputs(name)
    g = ts.granule
    want_dict, want_img = jax_basic.identify(
        aod, g.lat, g.lon, js.fires.date_time.iloc[0], js.fires,
        JAX_BASIC_CFG)
    got_dict, got_img = basic.identify(
        aod, g.lat, g.lon, ts.fires["date_time"][0], ts.fires, BASIC_CFG,
        device="cpu")
    assert got_dict == want_dict
    np.testing.assert_array_equal(got_img, np.asarray(want_img))
    # the contract of tests/test_identify_basic_parity.py
    f_rows, f_cols, f_valid = basic._prep_fires(
        g.lat, g.lon, ts.fires["date_time"][0], ts.fires, BASIC_CFG)
    o_dict, o_img = oracle_basic_identify(
        aod.astype(np.float64), f_rows[f_valid], f_cols[f_valid], BASIC_CFG)
    np.testing.assert_array_equal(got_img > 0, o_img > 0)
    assert sorted(tuple(v.values()) for v in got_dict.values()) == \
        sorted(tuple(v.values()) for v in o_dict.values())


def test_basic_finds_plumes_and_bboxes_cover_them():
    found = 0
    for name in ("seed61", "seed62", "seed63"):
        _js, ts, aod = _basic_inputs(name)
        g = ts.granule
        plumes, image = basic.identify(aod, g.lat, g.lon,
                                       ts.fires["date_time"][0], ts.fires,
                                       BASIC_CFG, device="cpu")
        found += len(plumes)
        assert sorted(plumes) == list(range(1, len(plumes) + 1))
        for bb in plumes.values():
            box = image[bb["min_r"]:bb["max_r"], bb["min_c"]:bb["max_c"]]
            assert (box > 0).any()
            assert ts.gt_mask[bb["min_r"]:bb["max_r"],
                              bb["min_c"]:bb["max_c"]].any()
    assert found >= 3


def test_basic_does_not_depend_on_the_chunking(monkeypatch):
    _js, ts, aod = _basic_inputs("seed62")
    g = ts.granule
    args = (aod, g.lat, g.lon, ts.fires["date_time"][0], ts.fires, BASIC_CFG)
    whole_dict, whole_img = basic.identify(*args, device="cpu")
    monkeypatch.setattr(basic, "CHUNK_ELEMENTS", 256 * 256)
    part_dict, part_img = basic.identify(*args, device="cpu")
    assert len(whole_dict) >= 2 and part_dict == whole_dict
    np.testing.assert_array_equal(part_img, whole_img)


def test_basic_ratio_screen_keeps_zero_and_drops_negative_backgrounds():
    """A window with an all-zero sub-window divides to inf and is kept; a
    window with a negative sub-window mean gives a negative ratio and is
    dropped; a flat window has ratio 1 and is dropped."""
    aod = np.full((64, 64), 0.5, np.float32)
    aod[6:13, 6:13] = 0.0            # fire (16, 16): zero sub-window
    aod[40:47, 6:13] = -999.0        # fire (50, 16): negative sub-window
    rows = np.asarray([16, 50, 16], np.int32)
    cols = np.asarray([16, 16, 50], np.int32)
    f_rows, f_cols, f_valid = pad_fires(rows, cols, 8)
    got = basic._make_program(BASIC_CFG)(
        torch.from_numpy(aod), torch.from_numpy(f_rows),
        torch.from_numpy(f_cols), torch.from_numpy(f_valid))
    want = jax_basic._make_program(JAX_BASIC_CFG)(
        jnp.asarray(aod), jnp.asarray(f_rows), jnp.asarray(f_cols),
        jnp.asarray(f_valid))
    assert got["near"].tolist() == [True, False, False] + [False] * 5
    np.testing.assert_array_equal(got["near"].numpy(),
                                  np.asarray(want["near"]))


def test_basic_empty_fire_table():
    _js, ts, aod = _basic_inputs("seed61")
    g = ts.granule
    empty = {k: v[:0] for k, v in ts.fires.items()}
    plumes, image = basic.identify(aod, g.lat, g.lon,
                                   np.datetime64("2017-08-01"), empty,
                                   BASIC_CFG, device="cpu")
    assert plumes == {} and not image.any()


# ---------------------------------------------------------------- gaussian

def _located(ts):
    g = ts.granule
    return gaussian.load_fires(g.lat, g.lon, ts.fires,
                               ts.fires["date_time"][0], GAUSS_CFG)


def test_gaussian_load_fires_and_clusters_equal_jax():
    js, ts = _scenes(53, null_blobs=2, **GAUSS_KW)
    g = ts.granule
    rows, cols = _located(ts)
    jr, jc = jax_gaussian.load_fires(g.lat, g.lon, js.fires,
                                     js.fires.date_time.iloc[0],
                                     JAX_GAUSS_CFG)
    np.testing.assert_array_equal(rows, jr)
    np.testing.assert_array_equal(cols, jc)
    assert len(rows) >= 20
    got = gaussian.cluster_fire_centroids(g.shape, rows, cols, GAUSS_CFG,
                                          device="cpu")
    want = jax_gaussian.cluster_fire_centroids(g.shape, jr, jc,
                                               JAX_GAUSS_CFG)
    for a, b in zip(got, want):
        # no bucketing: the arrays have max_fires slots
        assert a.shape == (GAUSS_CFG.max_fires,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2].sum()) >= 2


@pytest.mark.parametrize("seed,null_blobs", [(51, 0), (53, 2)])
def test_gaussian_identify_layer_equals_jax(seed, null_blobs):
    js, ts = _scenes(seed, null_blobs=null_blobs, **GAUSS_KW)
    g = ts.granule
    rows, cols = _located(ts)
    want = jax_gaussian.identify_layer(g.first_layer(), g.lat, g.lon, rows,
                                       cols, JAX_GAUSS_CFG)
    got = gaussian.identify_layer(g.first_layer(), g.lat, g.lon, rows, cols,
                                  GAUSS_CFG, device="cpu")
    assert len(got) >= 3
    _assert_tables_equal(got, want)
    ids = got.column("id")
    assert ids == sorted(ids) and ids[0] == 0.0


@pytest.mark.parametrize("seed,null_blobs", [(51, 0), (52, 0), (53, 2)])
def test_gaussian_sweeps_against_oracle(seed, null_blobs):
    """The contract of tests/test_identify_gaussian_parity.py for the
    port: cluster sets equal; without nulls extents and accepted masks
    exact; decisions agree on at least 85% of (scale, cluster) pairs."""
    _js, ts = _scenes(seed, null_blobs=null_blobs, **GAUSS_KW)
    g = ts.granule
    aod = g.first_layer()
    rows, cols = _located(ts)
    scales_o, (o_rows, o_cols), _aod_o, _ = oracle_identify_layer(
        aod.astype(np.float64), rows, cols, JAX_GAUSS_CFG)

    null_mask = torch.from_numpy(aod == GAUSS_CFG.null_value)
    aod_i = nearest_fill(torch.from_numpy(aod), null_mask)
    fr, fc, fv = (torch.from_numpy(a) for a in
                  pad_fires(rows, cols, GAUSS_CFG.max_fires))
    cr, cc, cvalid = raster_cluster_centroids(aod.shape, fr, fc, fv,
                                              GAUSS_CFG.min_fire_cluster_px)
    lane_of = {(int(r), int(c)): i for i, (r, c, v)
               in enumerate(zip(cr, cc, cvalid)) if v}
    assert set(lane_of) == set(zip(o_rows.tolist(), o_cols.tolist()))
    assert len(lane_of) >= 2

    fn = make_sweep_identifier(gaussian._statics(GAUSS_CFG))
    exact = null_blobs == 0       # with nulls, nearest-pixel ties may differ
    total = agree = 0
    for (extents_o, results_o), thresholds in zip(
            scales_o, GAUSS_CFG.threshold_sets()):
        out = fn(aod_i, aod_i, null_mask,
                 torch.tensor(thresholds, dtype=torch.float32), cr, cc,
                 cvalid)
        out = {k: v.numpy() for k, v in out.items()}
        for oi, (r, c) in enumerate(zip(o_rows, o_cols)):
            di = lane_of[(int(r), int(c))]
            if exact:
                np.testing.assert_array_equal(out["extents"][:, di],
                                              extents_o[:, oi])
            total += 1
            o_res = results_o[oi]
            if (o_res is not None) != bool(out["accepted"][di]):
                continue
            agree += 1
            if o_res is None:
                continue
            if exact:
                np.testing.assert_array_equal(out["mask"][di], o_res["mask"])
            else:
                inter = (out["mask"][di] & o_res["mask"]).sum()
                assert inter / (out["mask"][di] | o_res["mask"]).sum() > 0.95
    assert agree / total >= 0.85, (agree, total)


# tests/test_identify.py's two-layer granule: >= 20 located fires, nulls
GRANULE_KW = dict(RG_KW, n_layers=2, fires_per_plume=(7, 9), extra_fires=6,
                  null_blobs=2)


def test_gaussian_identify_granule_equals_jax():
    js, ts = _scenes(31, **GRANULE_KW)
    want = jax_gaussian.identify_granule(
        js.granule, js.fires, js.fires.date_time.iloc[0], JAX_GAUSS_CFG)
    got = gaussian.identify_granule(
        ts.granule, ts.fires, ts.fires["date_time"][0], GAUSS_CFG,
        device="cpu")
    assert got.columns == ("id", "hull_lats", "hull_lons", "hull_x",
                           "hull_y", "datetime")
    _assert_tables_equal(got, want)
    layers = list(ts.granule.layers)
    assert len(layers) == 2 and set(got.column("datetime")) == set(layers)
    # plume ids start again with every layer
    for ts_name in layers:
        ids = [r[0] for r in got.rows if r[-1] == ts_name]
        assert min(ids) == 0.0


def test_gaussian_min_fires_gate():
    js, ts = _scenes(32, **dict(RG_KW, n_plumes=1))
    want = jax_gaussian.identify_granule(
        js.granule, js.fires, js.fires.date_time.iloc[0], JAX_GAUSS_CFG)
    got = gaussian.identify_granule(
        ts.granule, ts.fires, ts.fires["date_time"][0], GAUSS_CFG,
        device="cpu")
    assert want.empty and len(got) == 0
    assert list(got.columns) == list(want.columns)


# --------------------------------------------------------------------- api

def test_api_dispatch_equals_jax():
    js, ts = _scenes(25, **RG_KW)
    jdate, tdate = js.fires.date_time.iloc[0], ts.fires["date_time"][0]
    want = jax_api.identify(js.granule, js.fires, jdate,
                            JaxRGCfg(max_fires=8))
    got = api.identify(ts.granule, ts.fires, tdate,
                       RGIdentifyConfig(max_fires=8), device="cpu")
    assert isinstance(got, api.PlumeSet)
    assert len(got) == len(want) == len(got.aod_stats) >= 1
    _assert_tables_equal(got.aod_stats, want.aod_stats)
    _assert_tables_equal(got.hulls, want.hulls)
    assert sorted(got.masks) == sorted(want.masks) == \
        sorted(got.aod_stats.column("id"))
    for pid, mask in want.masks.items():
        np.testing.assert_array_equal(got.masks[pid], mask)

    want_b = jax_api.identify(js.granule, js.fires, jdate, JAX_BASIC_CFG)
    got_b = api.identify(ts.granule, ts.fires, tdate, BASIC_CFG,
                         device="cpu")
    _assert_tables_equal(got_b.aod_stats, want_b.aod_stats)
    np.testing.assert_array_equal(got_b.labelled_image,
                                  np.asarray(want_b.labelled_image))
    assert len(got_b) == len(want_b) and len(got_b.hulls) == 0

    with pytest.raises(TypeError, match="unknown identify config"):
        api.identify(ts.granule, ts.fires, tdate, cfg=42, device="cpu")


def test_api_basic_zeroes_negatives_before_the_detector():
    """The api hands basic a copy with negative AOD zeroed; the granule
    keeps its nulls."""
    js, ts = _scenes(71, **dict(BASIC_KW, null_blobs=6, null_blob_sigma=8.0))
    before = ts.granule.first_layer().copy()
    assert (before < 0).any()
    got = api.identify(ts.granule, ts.fires, ts.fires["date_time"][0],
                       BASIC_CFG, device="cpu")
    np.testing.assert_array_equal(ts.granule.first_layer(), before)
    want = jax_api.identify(js.granule, js.fires,
                            js.fires.date_time.iloc[0], JAX_BASIC_CFG)
    _assert_tables_equal(got.aod_stats, want.aod_stats)
    np.testing.assert_array_equal(got.labelled_image,
                                  np.asarray(want.labelled_image))


def test_api_gaussian_equals_jax():
    js, ts = _scenes(31, **GRANULE_KW)
    want = jax_api.identify(js.granule, js.fires,
                            js.fires.date_time.iloc[0], JAX_GAUSS_CFG)
    got = api.identify(ts.granule, ts.fires, ts.fires["date_time"][0],
                       GAUSS_CFG, device="cpu")
    _assert_tables_equal(got.hulls, want.hulls)
    assert len(got.aod_stats) == 0 and got.masks == {}
    assert len(got) == len(want) >= 1


# ------------------------------------------------------------- multi-scene

def _batch_scenes(seeds_kw):
    scenes, tables = [], []
    for seed, kw in seeds_kw:
        ts = synthetic.make_scene(synthetic.SyntheticSceneConfig(seed=seed,
                                                                 **kw))
        g = ts.granule
        scenes.append((g.first_layer(), g.lat, g.lon,
                       ts.fires["date_time"][0]))
        tables.append(ts.fires)
    fires = {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}
    return scenes, fires


def _assert_batch_equals_serial(scenes, fires, cfg):
    serial = [rg.identify(*s, fires, cfg, device="cpu") for s in scenes]
    batched = rg.identify_batch(scenes, fires, cfg, device="cpu")
    assert len(batched) == len(serial)
    for (a_s, h_s, o_s), (a_b, h_b, o_b) in zip(serial, batched):
        assert a_b.columns == a_s.columns and a_b.rows == a_s.rows
        assert h_b.columns == h_s.columns and h_b.rows == h_s.rows
        assert sorted(o_b["plume_masks"]) == sorted(o_s["plume_masks"])
        for pid, m in o_s["plume_masks"].items():
            np.testing.assert_array_equal(o_b["plume_masks"][pid], m)
    return serial, batched


def test_identify_batch_matches_serial_and_jax():
    scenes, fires = _batch_scenes([(s, RG_KW) for s in (25, 27, 28)])
    serial, batched = _assert_batch_equals_serial(
        scenes, fires, RGIdentifyConfig(max_fires=8))
    assert sum(len(r[0]) for r in serial) > 0
    import pandas as pd

    jscenes = [jax_synthetic.make_scene(
        jax_synthetic.SyntheticSceneConfig(seed=s, **RG_KW))
        for s in (25, 27, 28)]
    fire_df = pd.concat([s.fires for s in jscenes], ignore_index=True)
    want = jax_rg.identify_batch(
        [(s.granule.first_layer(), s.granule.lat, s.granule.lon,
          s.fires.date_time.iloc[0]) for s in jscenes], fire_df,
        JaxRGCfg(max_fires=8))
    for (a_b, h_b, _o), (a_j, h_j, _oj) in zip(batched, want):
        _assert_tables_equal(a_b, a_j)
        _assert_tables_equal(h_b, h_j)


def test_identify_batch_rejects_mixed_shapes_and_no_scenes():
    scenes, fires = _batch_scenes([(25, RG_KW)])
    aod, lat, lon, date = scenes[0]
    with pytest.raises(ValueError, match="same-shape"):
        rg.identify_batch([scenes[0], (aod[:128, :128], lat[:128, :128],
                                       lon[:128, :128], date)], fires,
                          RGIdentifyConfig(max_fires=8), device="cpu")
    with pytest.raises(ValueError, match="no scenes"):
        rg.identify_batch(iter(()), fires, device="cpu")


def test_identify_batch_mixed_fire_buckets():
    """Scenes whose own fire buckets differ share the larger one in the
    group and still match the serial results. The scenes lie 15° apart, so
    that each sees only its own fires in the shared table."""
    scenes, fires = _batch_scenes([
        (31, RG_KW), (33, dict(RG_KW, extra_fires=30, center_lon=-45.0))])
    cfg = RGIdentifyConfig(max_fires=64)
    serial, batched = _assert_batch_equals_serial(scenes, fires, cfg)
    caps = [[o["accepted"].shape[0] for _a, _h, o in runs]
            for runs in (serial, batched)]
    assert caps[0][0] < caps[0][1] and caps[1] == [caps[0][1]] * 2


# ------------------------------------------------------------------ device

def test_detectors_default_to_the_card_and_never_fall_back():
    """Without ``device="cpu"`` every entry asks for the card and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _js, ts = _scenes(25, **RG_KW)
    g = ts.granule
    date = ts.fires["date_time"][0]
    scene = (g.first_layer(), g.lat, g.lon, date)
    calls = [
        lambda: rg.identify(*scene, ts.fires),
        lambda: rg.identify_batch([scene], ts.fires),
        lambda: basic.identify(*scene, ts.fires),
        lambda: gaussian.identify_granule(g, ts.fires, date),
        lambda: gaussian.identify_layer(g.first_layer(), g.lat, g.lon,
                                        np.zeros(0, np.int32),
                                        np.zeros(0, np.int32)),
        lambda: api.identify(g, ts.fires, date),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
