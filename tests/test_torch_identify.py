"""The rg identify path of plumekit_torch against the JAX package on the
same synthetic scenes: scene generation, fire tables, the device sweep,
the rg driver's tables, and the reference oracle's contract.

Tolerances: integer and boolean outputs (extents, threshold indices,
labels, areas, bboxes, accepted flags, masks, tables' integer columns) are
exact; the in-plume AOD mean and sd are float32 sums over the mask taken
in another order than XLA's, so rtol 1e-5.
"""

import dataclasses
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from plumekit.config.identify import GaussianIdentifyConfig as JaxGaussCfg
from plumekit.config.identify import RGIdentifyConfig as JaxRGCfg
from plumekit.identify import gaussian as jax_gaussian
from plumekit.identify import rg as jax_rg
from plumekit.identify.locate import locate_fires_in_image as jax_locate
from plumekit.identify.locate import pad_fires as jax_pad
from plumekit.identify.pipeline import (cached_sweep_identifier,
                                        make_sweep_identifier as jax_sweep)
from plumekit.io import synthetic as jax_synthetic
from plumekit.io.dates import granule_date as jax_granule_date
from plumekit.io.fires import load_fire_csv as jax_load_fire_csv
from plumekit.io.fires import subset_fires_to_image as jax_subset
from plumekit.ops.cluster import mean_cluster_positions as jax_mcp
from plumekit_torch.config.identify import RGIdentifyConfig
from plumekit_torch.identify import rg
from plumekit_torch.identify.locate import locate_fires_in_image, pad_fires
from plumekit_torch.identify.pipeline import (SweepStatics,
                                              make_sweep_identifier,
                                              validate_descending_thresholds)
from plumekit_torch.io import synthetic
from plumekit_torch.io.dates import granule_date
from plumekit_torch.io.fires import load_fire_csv, subset_fires_to_image
from plumekit_torch.ops.cluster import mean_cluster_positions

sys.path.insert(0, os.path.dirname(__file__))
from oracle_rg import oracle_identify  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RG_CFG = RGIdentifyConfig(max_fires=8)
JAX_RG_CFG = JaxRGCfg(max_fires=8)
SEEDS = (21, 22, 23, 24, 25, 26, 27, 28)     # tests/test_identify.py:65
SCENE_KW = dict(
    size=256, n_plumes=3, background_level=0.2, background_noise=0.05,
    plume_amplitude=(0.6, 0.8), plume_sigma_major=(9.0, 14.0),
    plume_sigma_minor=(1.8, 2.6),
)
EXACT = ("extents", "t_index", "t_used", "label", "area", "bbox",
         "accepted", "mask")
FLOAT_RTOL = 1e-5


def _scenes(seed, **kw):
    kw = {**SCENE_KW, **kw}
    return (jax_synthetic.make_scene(
                jax_synthetic.SyntheticSceneConfig(seed=seed, **kw)),
            synthetic.make_scene(synthetic.SyntheticSceneConfig(seed=seed,
                                                                **kw)))


@pytest.mark.parametrize("seed,kw", [
    (7, dict(size=256, n_plumes=2)),
    (21, {}),
    (3, dict(size=128, n_layers=2, null_blobs=2, extra_fires=4,
             distractor_blobs=2)),
])
def test_make_scene_bit_equal_to_jax(seed, kw):
    js, ts = _scenes(seed, **kw)
    assert list(js.granule.layers) == list(ts.granule.layers)
    for k in js.granule.layers:
        np.testing.assert_array_equal(ts.granule.layers[k],
                                      js.granule.layers[k])
    np.testing.assert_array_equal(ts.granule.lat, js.granule.lat)
    np.testing.assert_array_equal(ts.granule.lon, js.granule.lon)
    np.testing.assert_array_equal(ts.gt_labels, js.gt_labels)
    assert ts.granule.name == js.granule.name
    for col in ("latitude", "longitude", "frp"):
        np.testing.assert_array_equal(ts.fires[col], js.fires[col].to_numpy())
    np.testing.assert_array_equal(
        ts.fires["date_time"],
        js.fires.date_time.to_numpy().astype("datetime64[D]"))


def test_fire_table_io_clustering_and_dates(tmp_path):
    """load_fire_csv, the subset, the cluster means and the granule date
    against the pandas versions. The port parses floats correctly
    rounded, so the written values come back exactly; pandas' default C
    parser may land one ulp away. From the same table on, subsets,
    cluster means and fire pixels are equal to the last bit."""
    js, _ = _scenes(5, extra_fires=6, size=192)
    fires = js.fires.copy()
    other_day = fires.iloc[:3].copy()
    other_day["acq_date"] = "2017-08-02"
    low_frp = fires.iloc[3:5].copy()
    low_frp["frp"] = 5.0
    written = pd.concat([fires, other_day, low_frp])
    path = tmp_path / "fires.csv"
    written.drop(columns=["date_time"]).to_csv(path, index=False)
    jf, tf = jax_load_fire_csv(str(path)), load_fire_csv(str(path))
    for col in ("latitude", "longitude", "frp"):
        np.testing.assert_array_equal(tf[col], written[col].to_numpy())
        np.testing.assert_array_max_ulp(tf[col], jf[col].to_numpy(), 1)
    np.testing.assert_array_equal(
        tf["date_time"], jf.date_time.to_numpy().astype("datetime64[D]"))
    tf.update({col: jf[col].to_numpy()
               for col in ("latitude", "longitude", "frp")})
    g = js.granule
    date = jf.date_time.iloc[0]
    jsub = jax_subset(g.lat, g.lon, jf, date, min_frp=10.0)
    tsub = subset_fires_to_image(g.lat, g.lon, tf, tf["date_time"][0],
                                 min_frp=10.0)
    np.testing.assert_array_equal(tsub["latitude"],
                                  jsub.latitude.to_numpy())
    jc = jax_mcp(jsub, 5.0)
    t_lat, t_lon = mean_cluster_positions(tsub, 5.0)
    np.testing.assert_array_equal(t_lat, jc.latitude.to_numpy())
    np.testing.assert_array_equal(t_lon, jc.longitude.to_numpy())
    jr, jcol = jax_locate(jc.latitude, jc.longitude, g.lat, g.lon, 15)
    tr, tcol = locate_fires_in_image(t_lat, t_lon, g.lat, g.lon, 15)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tcol, jcol)
    for r, c in ((tr, tcol), (tr[:0], tcol[:0])):
        for cap, bucket in ((8, False), (64, True)):
            for a, b in zip(pad_fires(r, c, cap, bucket),
                            jax_pad(r, c, cap, bucket)):
                np.testing.assert_array_equal(a, b)
    name = "MCD19A2.A2017255.h12v09.006.npz"
    assert granule_date(name) == np.datetime64(
        jax_granule_date(name).date(), "D")
    assert granule_date("SYNTH.npz", default=3) == 3


def _fire_rows(js, cfg=JAX_RG_CFG):
    g = js.granule
    sub = jax_subset(g.lat, g.lon, js.fires, js.fires.date_time.iloc[0],
                     min_frp=cfg.min_frp)
    cl = jax_mcp(sub, cfg.cluster_dist_km)
    return jax_locate(cl.latitude, cl.longitude, g.lat, g.lon, cfg.win_half)


def _run_both(jax_fn, torch_fn, aod, rows, cols, capacity, thresholds,
              null_mask=None):
    fr, fc, fv = pad_fires(rows, cols, capacity)
    nulls = np.zeros(aod.shape, bool) if null_mask is None else null_mask
    aj = jnp.asarray(aod, jnp.float32)
    jo = jax_fn(aj, aj, jnp.asarray(nulls), jnp.asarray(thresholds),
                jnp.asarray(fr), jnp.asarray(fc), jnp.asarray(fv))
    at = torch.from_numpy(np.asarray(aod, np.float32))
    to = torch_fn(at, at, torch.from_numpy(nulls),
                  torch.from_numpy(np.asarray(thresholds, np.float32)),
                  torch.from_numpy(fr), torch.from_numpy(fc),
                  torch.from_numpy(fv))
    return ({k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in to.items()})


def _assert_sweeps_equal(jo, to):
    assert set(to) == set(jo)
    for k in jo:
        assert to[k].shape == jo[k].shape and to[k].dtype == jo[k].dtype, k
    for k in EXACT:
        np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
    for k in ("aod_mean", "aod_sd"):
        np.testing.assert_allclose(to[k], jo[k], rtol=FLOAT_RTOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_matches_jax(seed):
    js, ts = _scenes(seed)
    rows, cols = _fire_rows(js)
    thresholds = np.asarray(RG_CFG.thresholds, np.float32)
    jo, to = _run_both(cached_sweep_identifier(jax_rg._statics(JAX_RG_CFG)),
                       make_sweep_identifier(rg._statics(RG_CFG)),
                       ts.granule.first_layer(), rows, cols,
                       RG_CFG.max_fires, thresholds)
    _assert_sweeps_equal(jo, to)
    # the gate flags of every candidate whose area passes the size gates
    # (whole-scene components beyond them have float covariances that
    # depend on summation order; those candidates fail on area anyway)
    for side in ("a", "b"):
        sized = jo[f"gates_{side}"][:, 1] & jo[f"gates_{side}"][:, 2]
        np.testing.assert_array_equal(to[f"gates_{side}"][sized],
                                      jo[f"gates_{side}"][sized])
        np.testing.assert_array_equal(to[f"n_peaks_{side}"][sized],
                                      jo[f"n_peaks_{side}"][sized])


def test_rg_parity_against_oracle():
    """tests/test_identify.py's contract for the port: extents exact at
    every (threshold, fire); accept decisions and masks agree on ≥ 80% of
    fires, the rest the same physical plume."""
    fn = make_sweep_identifier(rg._statics(RG_CFG))
    thresholds = torch.from_numpy(np.asarray(RG_CFG.thresholds, np.float32))
    total = agree = accepted_pairs = 0
    for seed in SEEDS:
        js, ts = _scenes(seed)
        rows, cols = _fire_rows(js)
        aod = ts.granule.first_layer().astype(np.float64)
        oracle, extents = oracle_identify(aod, rows, cols, JAX_RG_CFG)
        fr, fc, fv = pad_fires(rows, cols, RG_CFG.max_fires)
        at = torch.from_numpy(aod.astype(np.float32))
        out = fn(at, at, torch.zeros(aod.shape, dtype=torch.bool),
                 thresholds, torch.from_numpy(fr), torch.from_numpy(fc),
                 torch.from_numpy(fv))
        out = {k: v.numpy() for k, v in out.items()}
        np.testing.assert_array_equal(out["extents"][:, :len(rows)],
                                      extents)
        for i in range(len(rows)):
            total += 1
            o = oracle[i]
            if (o is not None) != bool(out["accepted"][i]):
                continue
            if o is None:
                agree += 1
            elif np.array_equal(out["mask"][i], o["mask"]):
                agree += 1
                accepted_pairs += 1
            else:
                inter = (out["mask"][i] & o["mask"]).sum()
                assert inter / (out["mask"][i] | o["mask"]).sum() > 0.5
    assert accepted_pairs >= 3, "acceptance path not exercised"
    assert agree / total >= 0.8, f"agreement {agree}/{total}"


def _assert_tables_equal(table, df):
    assert list(table.columns) == list(df.columns)
    assert len(table) == len(df)
    for col in table.columns:
        got = np.asarray(table.column(col), dtype=np.float64)
        want = df[col].to_numpy(dtype=np.float64)
        if col in ("plume_aod_mean", "plume_aod_sd"):
            np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)


@pytest.mark.parametrize("seed", [22, 25])
def test_rg_identify_tables_equal_jax_dataframes(seed):
    js, ts = _scenes(seed)
    g = ts.granule
    aod_df, hull_df, jout = jax_rg.identify(
        g.first_layer(), g.lat, g.lon, js.fires.date_time.iloc[0], js.fires,
        JAX_RG_CFG)
    aod_t, hull_t, tout = rg.identify(
        g.first_layer(), g.lat, g.lon, ts.fires["date_time"][0], ts.fires,
        RG_CFG, device="cpu")
    assert len(aod_df) >= 1
    _assert_tables_equal(aod_t, aod_df)
    _assert_tables_equal(hull_t, hull_df.reset_index(drop=True))
    jm, tm = jax_rg.plume_masks(jout), rg.plume_masks(tout)
    assert sorted(jm) == sorted(tm)
    for pid in jm:
        np.testing.assert_array_equal(tm[pid], jm[pid])


def test_rg_dedup_drops_duplicate_plumes():
    """Two fires claiming one plume: the second row and its hull rows go,
    as the JAX package's ``drop_duplicates``."""
    js, ts = _scenes(25)
    g = ts.granule
    _a, _h, tout = rg.identify(g.first_layer(), g.lat, g.lon,
                               ts.fires["date_time"][0], ts.fires, RG_CFG)
    f = int(np.nonzero(tout["accepted"])[0][0])
    dup = {k: np.concatenate([v, v[f:f + 1]]) for k, v in tout.items()
           if k in ("accepted", "mask", "bbox", "area", "aod_mean",
                    "aod_sd", "t_index")}
    ja, jh = jax_rg.build_scene_dataframes(dup, g.lat, g.lon)
    ta, th = rg.build_scene_dataframes(dup, g.lat, g.lon)
    _assert_tables_equal(ta, ja)
    _assert_tables_equal(th, jh.reset_index(drop=True))
    ta_all, _ = rg.build_scene_dataframes(dup, g.lat, g.lon, dedup=False)
    assert len(ta_all) == len(ta) + 1


def test_rg_empty_fires():
    _js, ts = _scenes(25)
    g = ts.granule
    empty = {k: v[:0] for k, v in ts.fires.items()}
    aod_t, hull_t, _ = rg.identify(g.first_layer(), g.lat, g.lon,
                                   np.datetime64("2017-08-01"), empty, RG_CFG)
    assert len(aod_t) == 0 and len(hull_t) == 0


def test_sweep_with_gaussian_statics_matches_jax():
    """The unsmoothed, null-checked, 5×5-dilated variant (the gaussian
    detector's statics) on a scene with null holes."""
    jcfg = JaxGaussCfg(max_fires=16)
    jstat = jax_gaussian._statics(jcfg)
    tstat = SweepStatics(**dataclasses.asdict(jstat))
    assert (tstat.savgol_window, tstat.check_null, tstat.dilate_plume_px,
            tstat.use_mask_b) == (0, True, 5, False)
    js, ts = _scenes(24, null_blobs=2)
    aod = ts.granule.first_layer()
    rows, cols = _fire_rows(js)
    thresholds = np.asarray(jcfg.threshold_sets()[0], np.float32)
    jo, to = _run_both(jax_sweep(jstat), make_sweep_identifier(tstat), aod,
                       rows, cols, jcfg.max_fires, thresholds,
                       null_mask=aod == -999.0)
    _assert_sweeps_equal(jo, to)


def test_label_window_nearest_matches_jax():
    """Nearest-label lookups at fires in the middle, at the edges (the
    window clamps) and in empty windows, on labels with equidistant ties:
    the first minimum in row-major window order wins in both."""
    import jax

    from plumekit.ops.segment import label_window_nearest as jax_nearest
    from plumekit_torch.ops.segment import label_window_nearest

    rng = np.random.default_rng(4)
    labels = np.where(rng.random((64, 80)) < 0.02,
                      rng.integers(1, 9, (64, 80)), 0).astype(np.int32)
    labels[30:34, 40:44] = 0
    labels[30, 44], labels[34, 40] = 5, 6          # equidistant from (32, 42)
    labels[:12, :12] = 0                           # an empty corner window
    rows = np.array([32, 0, 63, 5, 40, 3], np.int32)
    cols = np.array([42, 0, 79, 5, 1, 77], np.int32)
    got_l, got_f = label_window_nearest(torch.from_numpy(labels),
                                        torch.from_numpy(rows),
                                        torch.from_numpy(cols), 5)
    want_l, want_f = jax.vmap(
        lambda r, c: jax_nearest(jnp.asarray(labels), r, c, 5))(
            jnp.asarray(rows), jnp.asarray(cols))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_l.numpy()[got_f.numpy()],
                                  np.asarray(want_l)[np.asarray(want_f)])
    assert not got_f.numpy()[3]


def test_threshold_validation():
    np.testing.assert_array_equal(
        validate_descending_thresholds([0.5, 0.25]),
        np.asarray([0.5, 0.25], np.float32))
    for bad in ([0.5], [0.25, 0.5], [0.5, 0.5], [[0.5, 0.25]]):
        with pytest.raises(ValueError, match="descending"):
            validate_descending_thresholds(bad)
