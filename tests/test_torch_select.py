"""The port's curation (``plumekit_torch/label``, ``io/tables.py`` and the
``select`` command) against the JAX package's: the row tables read as
``pd.read_csv`` types them and written as pandas writes them, the
duplicate pass, the reviews, the decision split, the model-support scores
and order, the review export, and ``select`` of both CLIs on one root,
every table compared as the CSV text each package writes."""

import io
import logging
import math
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from plumekit.cli import main as jax_main
from plumekit.io.granule import Granule as JaxGranule
from plumekit.io.granule import save_granule as jax_save_granule
from plumekit.label import ranking as jrank
from plumekit.label import selector as jsel
from plumekit_torch import cli
from plumekit_torch.io.granule import Granule
from plumekit_torch.io.tables import Table, read_decisions, truthy
from plumekit_torch.label import ranking as trank
from plumekit_torch.label import selector as tsel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CSVS = {
    "ints": "id,x\n1,2\n3,-4\n",
    "float_ids_and_blanks": "id,hull_x,hull_lats\n0.0,1,10.123456789012345\n"
                            "1.0,,-9.913891823607251\n2.0,3,\n",
    "bools_and_strings": "a,b,c\nTrue,layer0,NA\nFalse,2017200000A,x\n",
    "numeric_datetimes": "id,datetime,keep\n1,2020001,1\n2,2016123.1030,\n"
                         "3,2020001,yes\n",
    "int_datetimes": "id,datetime,keep\n1,2020001,1.0\n2,2020002,true\n",
    "all_blank_and_nan": "a,b,c\n,nan,1e-05\n,NaN,1e+16\n",
    "header_only": "id,hull_lats,hull_lons,hull_x,hull_y\n",
}


def _kind(v):
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    return "str"


@pytest.mark.parametrize("name", sorted(CSVS))
def test_table_reads_and_writes_as_pandas(tmp_path, name):
    path = str(tmp_path / "t.csv")
    with open(path, "w") as f:
        f.write(CSVS[name])
    got = Table.read_csv(path)
    want = pd.read_csv(path)
    assert got.columns == tuple(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got.column(c), want[c].tolist()
        assert [_kind(v) for v in g] == [_kind(v) for v in w], c
        assert [str(v) for v in g] == [str(v) for v in w], c
    buf = io.StringIO()
    want.to_csv(buf, index=False)
    got.to_csv(str(tmp_path / "back.csv"))
    with open(tmp_path / "back.csv") as f:
        assert f.read() == buf.getvalue()


@pytest.mark.parametrize("seed", range(3))
def test_numbers_parse_as_pandas_default_converter(seed):
    """pandas' default float converter is not correctly rounded past 2**53
    significant digits; the port reads the same doubles (``float`` would
    differ in about a third of these cells)."""
    from plumekit_torch.io.tables import pandas_float

    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.normal(0, 1, 2000) * 10.0 ** rng.integers(-30, 30, 2000),
        rng.uniform(-180, 180, 2000)])
    cells = ([repr(float(v)) for v in vals] + ["%.19g" % v for v in vals]
             + ["1e5", "-0.0", "+3.25", "1.5E-3", "00012.5",
                "12345678901234567890.5", "inf", "-Infinity"])
    want = pd.read_csv(io.StringIO("a\n" + "\n".join(cells) + "\n")).a
    got = [pandas_float(c) for c in cells]
    assert [repr(g) for g in got] == [repr(float(w)) for w in want]
    assert sum(float(c) != g for c, g in zip(cells, got)) > 100
    for bad in ("", "1e", "x1", "1.2.3", "--1"):
        with pytest.raises(ValueError):
            pandas_float(bad)


@pytest.mark.parametrize("value", ["1", "1.0", "true", "Yes", " y ", "0",
                                   "", "nan", "2", "no", 1.0, 1, True,
                                   math.nan])
def test_truthy_and_decisions_as_the_jax_cli(tmp_path, value):
    """The keep rule of ``plumekit select --decisions``, on the cell as
    written and as read back."""
    path = str(tmp_path / "d.csv")
    pd.DataFrame({"id": [3, 4], "datetime": ["layer0", "x"],
                  "keep": [value, "1"]}).to_csv(path, index=False)
    dec = pd.read_csv(path)
    want = {(int(r.id), str(r.datetime)) for r in dec.itertuples()
            if _jax_truthy(r.keep)}
    assert read_decisions(path) == want
    assert truthy(value) == _jax_truthy(value)


def _jax_truthy(v) -> bool:
    """``plumekit/cli.py``'s nested rule, copied: the JAX CLI keeps it
    inside ``cmd_select``."""
    sv = str(v).strip().lower()
    if sv in ("1", "true", "yes", "y"):
        return True
    try:
        return float(sv) == 1.0
    except ValueError:
        return False


def _hull(cy, cx, r, pid, dt="t0", lat=None, lon=None):
    ys = [cy - r, cy - r, cy + r, cy + r]
    xs = [cx - r, cx + r, cx + r, cx - r]
    return pd.DataFrame({"id": float(pid),
                         "hull_lats": [float(cy) if lat is None else lat] * 4,
                         "hull_lons": [float(cx) if lon is None else lon] * 4,
                         "hull_x": xs, "hull_y": ys, "datetime": dt})


def _both_tables(tmp_path, df):
    """The frame as the JAX package reads it back and as the port does."""
    path = str(tmp_path / "h.csv")
    df.to_csv(path, index=False)
    return pd.read_csv(path), Table.read_csv(path)


def _same(tmp_path, got, want):
    got.to_csv(str(tmp_path / "got.csv"))
    want.to_csv(str(tmp_path / "want.csv"), index=False)
    with open(tmp_path / "got.csv") as g, open(tmp_path / "want.csv") as w:
        assert g.read() == w.read()


def _dup_frames():
    rng = np.random.default_rng(5)
    random_rows = pd.DataFrame({
        "id": rng.integers(0, 12, 200).astype(float),
        "hull_lats": np.round(rng.normal(10, 0.002, 200), 9),
        "hull_lons": np.round(rng.normal(20, 0.002, 200), 9),
        "hull_x": rng.integers(0, 100, 200),
        "hull_y": rng.integers(0, 100, 200),
        "datetime": rng.choice(["t0", "t1", "layer0"], 200)})
    return {
        "same_centroid": pd.concat([_hull(50, 50, 5, 2), _hull(50, 50, 5, 0),
                                    _hull(90, 90, 5, 1)], ignore_index=True),
        # rounds to 0.000 and 0.002 (half to even) in the mean
        "half_to_even": pd.concat([
            _hull(20, 20, 5, 0, lat=0.0005, lon=1.0),
            _hull(30, 30, 5, 1, lat=0.0004, lon=1.0),
            _hull(40, 40, 5, 2, lat=0.0015, lon=1.0),
            _hull(60, 60, 5, 3, lat=0.0025, lon=1.0)], ignore_index=True),
        "interleaved_datetimes": pd.concat([
            _hull(50, 50, 5, 1, "t1"), _hull(50, 50, 5, 0, "t0"),
            _hull(50, 50, 5, 0, "t1"), _hull(50, 50, 5, 1, "t0")],
            ignore_index=True).sample(frac=1.0, random_state=3),
        "nan_id": pd.concat([_hull(50, 50, 5, 0), _hull(70, 70, 5, np.nan)],
                            ignore_index=True),
        "random": random_rows,
        "empty": _hull(1, 1, 1, 0).iloc[:0],
    }


@pytest.mark.parametrize("name", sorted(_dup_frames()))
def test_remove_duplicated_plumes_matches_jax(tmp_path, name):
    jdf, table = _both_tables(tmp_path, _dup_frames()[name])
    _same(tmp_path, tsel.remove_duplicated_plumes(table),
          jsel.remove_duplicated_plumes(jdf))


def test_group_mean_is_pandas_compensated_sum():
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, (400, 7)) * 10.0 ** rng.integers(-3, 9, (400, 7))
    df = pd.DataFrame({"k": np.repeat(np.arange(7), 400 // 7 + 1)[:400],
                       "v": vals[:, 0]})
    want = df.groupby("k").v.mean()
    for k, w in want.items():
        assert tsel.group_mean(df.v[df.k == k]) == w
    assert math.isnan(tsel.group_mean([math.nan]))


@pytest.fixture()
def granules():
    """One granule with a bright and a faint plume and a second orbit
    layer, in both packages' containers."""
    rng = np.random.default_rng(1)
    aod = np.full((128, 128), 0.05, np.float32)
    aod[40:60, 40:60] = 0.8
    aod[90:110, 10:30] = 0.01 + 0.005 * rng.random((20, 20))
    other = np.flipud(aod).copy()
    lat, lon = np.mgrid[0:128, 0:128].astype(np.float64)
    layers = {"2017200000A": aod, "2017201000A": other}
    return (Granule(layers, lat, lon, name="toy"),
            JaxGranule(layers, lat, lon, name="toy"))


def _review_frame():
    return pd.concat([
        _hull(50, 50, 10, 0, "2017200000A"),       # bright: kept for review
        _hull(100, 20, 8, 1, "2017200000A"),       # faint: auto-rejected
        _hull(100, 20, 8, 1, "2017201000A"),       # bright in the flip
        _hull(50, 50, 10, 4, "layer0"),
        _hull(50, 50, 10, 5, "layer0"),            # duplicate of 4
        _hull(30, 115, 12, 2, "2017200000A"),      # crop clipped at the edge
        pd.DataFrame({"id": 3.0, "hull_lats": 1.0, "hull_lons": 2.0,
                      "hull_x": [np.nan] * 3, "hull_y": [1.0, 2.0, 3.0],
                      "datetime": "2017200000A"}),  # NaN hull: no crop
    ], ignore_index=True)


def _same_reviews(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.plume_id, str(g.datetime), g.auto_rejected) == \
            (w.plume_id, str(w.datetime), w.auto_rejected)
        for a in ("crop", "hull_x", "hull_y", "in_plume_aod"):
            if getattr(w, a) is None:
                assert getattr(g, a) is None
            else:
                np.testing.assert_array_equal(getattr(g, a), getattr(w, a))


@pytest.mark.parametrize("dedup", [True, False])
def test_review_plumes_matches_jax(tmp_path, granules, dedup):
    jdf, table = _both_tables(tmp_path, _review_frame())
    got = tsel.review_plumes(table, granules[0], dedup=dedup)
    _same_reviews(got, jsel.review_plumes(jdf, granules[1], dedup=dedup))
    assert any(r.auto_rejected and r.crop is not None for r in got)


def test_review_plumes_refuses_an_unknown_orbit(tmp_path, granules):
    jdf, table = _both_tables(tmp_path, _hull(50, 50, 10, 0, "nope"))
    with pytest.raises(ValueError, match="not among granule layers"):
        tsel.review_plumes(table, granules[0])
    with pytest.raises(ValueError, match="not among granule layers"):
        jsel.review_plumes(jdf, granules[1])


def _scores_pair(tmp_path, jdf, table, shape=(128, 128)):
    rng = np.random.default_rng(2)
    probs = rng.random(shape).astype(np.float32)
    masks = {"0": np.zeros(shape, bool), "1": np.zeros((4, 4), bool)}
    masks["0"][45:55, 45:55] = True
    return (trank.plume_support(probs, table, masks),
            jrank.plume_support(probs, jdf, masks), probs, masks)


@pytest.mark.parametrize("ranked", [False, True])
def test_apply_decisions_matches_jax(tmp_path, granules, ranked):
    jdf, table = _both_tables(tmp_path, _review_frame())
    scores = _scores_pair(tmp_path, jdf, table) if ranked else None
    seen = {"got": [], "want": []}

    def decide(key):
        def f(r):
            seen[key].append((r.plume_id, str(r.datetime)))
            return r.plume_id in (0, 1, 4)
        return f

    got = tsel.apply_decisions(table, granules[0], decide("got"),
                               scores[0] if ranked else None)
    want = jsel.apply_decisions(jdf, granules[1], decide("want"),
                                scores[1] if ranked else None)
    assert seen["got"] == seen["want"] and seen["got"]
    for g, w in zip(got, want):
        _same(tmp_path, g, w)


def test_plume_support_and_review_order_match_jax(tmp_path, granules):
    jdf, table = _both_tables(tmp_path, _review_frame())
    got, want, _p, _m = _scores_pair(tmp_path, jdf, table)
    _same(tmp_path, got, want)
    assert any(math.isnan(v) for v in got.column("model_support"))
    assert trank.review_order(got) == jrank.review_order(want)
    reviews = tsel.review_plumes(table, granules[0])
    jreviews = jsel.review_plumes(jdf, granules[1])
    _same_reviews(tsel.order_reviews(reviews, got),
                  jsel.order_reviews(jreviews, want))


def test_load_prediction_and_masks_match_jax(tmp_path):
    p = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    for name, probs in (("f", p), ("q", np.round(p * 255).astype(np.uint8))):
        np.savez(tmp_path / f"{name}_pred.npz", probs=probs)
        got = trank.load_prediction(str(tmp_path), name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jrank.load_prediction(str(tmp_path), name))
    assert trank.load_prediction(str(tmp_path), "none") is None
    np.savez(tmp_path / "g_masks.npz", **{"0": p > 0.5, "3": p > 0.2})
    got = trank.load_plume_masks(str(tmp_path), "g")
    want = jrank.load_plume_masks(str(tmp_path), "g")
    assert sorted(got) == sorted(want) == ["0", "3"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert trank.load_plume_masks(str(tmp_path), "none") is None


@pytest.mark.parametrize("ranked", [False, True])
def test_export_review_batch_matches_jax(tmp_path, granules, ranked):
    pytest.importorskip("matplotlib")
    jdf, table = _both_tables(tmp_path, _review_frame())
    scores = _scores_pair(tmp_path, jdf, table) if ranked else (None, None)
    got = tsel.export_review_batch(table, granules[0], str(tmp_path / "g"),
                                   scores=scores[0])
    jsel.export_review_batch(jdf, granules[1], str(tmp_path / "w"),
                             scores=scores[1])
    assert sorted(os.listdir(tmp_path / "g")) == \
        sorted(os.listdir(tmp_path / "w"))
    with open(tmp_path / "g" / "manifest.csv") as g, \
            open(tmp_path / "w" / "manifest.csv") as w:
        assert g.read() == w.read()
    assert len(got) == 6


def test_export_without_matplotlib_refuses(tmp_path, granules, monkeypatch,
                                           caplog):
    """Where matplotlib is missing (the card's machine), the export raises
    ImportError and ``select`` without ``--decisions`` exits 1 naming
    matplotlib; ``select --decisions`` needs no matplotlib."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _jdf, table = _both_tables(tmp_path, _review_frame())
    with pytest.raises(ImportError):
        tsel.export_review_batch(table, granules[0], str(tmp_path / "g"))
    root = _select_root(tmp_path)
    with caplog.at_level(logging.ERROR):
        assert cli.main(["select", "--root", root]) == 1
    assert "needs matplotlib" in caplog.text
    assert not os.path.exists(os.path.join(root, "review"))
    dec = str(tmp_path / "dec.csv")
    pd.DataFrame({"id": [0], "datetime": ["layer0"], "keep": [1]}).to_csv(
        dec, index=False)
    assert cli.main(["select", "--root", root, "--decisions", dec]) == 0


def _select_root(tmp_path, name="root"):
    """A root with three hull tables: rg-like (no datetime column), a
    gaussian-like two-orbit one with a datetime column, and a basic bbox
    table (no hulls), plus one hull table without a granule."""
    root = str(tmp_path / name)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    hull_dir = os.path.join(root, "raw", "plume_identification",
                            "dataframes", "full", "hull")
    os.makedirs(maiac)
    os.makedirs(hull_dir)
    rng = np.random.default_rng(4)
    aod = np.full((128, 128), 0.05, np.float32)
    aod[40:60, 40:60] = 0.8
    aod[90:110, 10:30] = 0.005
    lat, lon = np.mgrid[0:128, 0:128].astype(np.float64)
    for base, layers in (("rg", {"2017200000A": aod}),
                         ("gauss", {"2017200000A": aod,
                                    "2017201000A": np.fliplr(aod).copy()})):
        jax_save_granule(os.path.join(maiac, base + ".npz"),
                         JaxGranule(layers, lat, lon + rng.random(), base))
    rg = pd.concat([_hull(50, 50, 10, 0), _hull(100, 20, 8, 1),
                    _hull(50, 50, 10, 2), _hull(20, 100, 6, 3)],
                   ignore_index=True).drop(columns="datetime")
    rg.to_csv(os.path.join(hull_dir, "rg_extent.csv"), index=False)
    gauss = pd.concat([_hull(50, 50, 10, 0, "2017200000A"),
                       _hull(50, 77, 10, 1, "2017201000A"),
                       _hull(100, 20, 8, 2, "2017200000A")],
                      ignore_index=True)
    gauss.to_csv(os.path.join(hull_dir, "gauss_extent.csv"), index=False)
    pd.DataFrame({"id": [0], "plume_min_row": [1]}).to_csv(
        os.path.join(hull_dir, "basic_extent.csv"), index=False)
    rg.to_csv(os.path.join(hull_dir, "orphan_extent.csv"), index=False)
    return root


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".csv"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    out[os.path.relpath(p, root)] = fh.read()
            elif f.endswith(".png"):
                out[os.path.relpath(os.path.join(d, f), root)] = "png"
    return out


@pytest.mark.parametrize("keep", ["1", "1.0", "yes", ""])
def test_select_decisions_matches_jax_cli(tmp_path, keep):
    dec = str(tmp_path / "dec.csv")
    pd.DataFrame({"id": [0, 1, 3, 0, 1, 2],
                  "datetime": ["layer0"] * 3 + ["2017200000A",
                                                "2017201000A", "x"],
                  "keep": [keep, "1", "true", "1", keep, "1"]}).to_csv(
        dec, index=False)
    want_root = _select_root(tmp_path, "want")
    got_root = _select_root(tmp_path, "got")
    assert jax_main(["select", "--root", want_root, "--decisions", dec]) == 0
    assert cli.main(["select", "--root", got_root, "--decisions", dec]) == 0
    got, want = _tree(got_root), _tree(want_root)
    assert got == want
    assert any("reduced/plume" in k for k in got)


@pytest.mark.parametrize("rank", [[], ["--rank-with-predictions"]])
def test_select_review_export_matches_jax_cli(tmp_path, rank):
    pytest.importorskip("matplotlib")
    roots = [_select_root(tmp_path, "want"), _select_root(tmp_path, "got")]
    for root in roots:
        pred_dir = os.path.join(root, "processed", "predictions")
        os.makedirs(pred_dir)
        probs = np.random.default_rng(9).random((128, 128))
        np.savez(os.path.join(pred_dir, "rg_pred.npz"),
                 probs=probs.astype(np.float32))
    assert jax_main(["select", "--root", roots[0], *rank]) == 0
    assert cli.main(["select", "--root", roots[1], *rank]) == 0
    got, want = _tree(roots[1]), _tree(roots[0])
    assert got == want
    manifest = got[os.path.join("review", "rg", "manifest.csv")]
    assert ("model_support" in manifest) == bool(rank)


def test_granule_helpers_match_jax(tmp_path, granules):
    from plumekit.io.granule import find_granule as jfind
    from plumekit.io.granule import resolve_layer as jresolve
    from plumekit_torch.io.granule import (LAYER0_SENTINEL, find_granule,
                                           resolve_layer)

    assert LAYER0_SENTINEL == "layer0"
    g, jg = granules
    for ts in ("layer0", "2017201000A", 2017200000, "nope"):
        try:
            want = jresolve(jg, ts)
        except ValueError:
            with pytest.raises(ValueError):
                resolve_layer(g, ts)
            continue
        np.testing.assert_array_equal(resolve_layer(g, ts), want)
    single = Granule({"a": np.zeros((2, 2))}, g.lat, g.lon)
    assert resolve_layer(single, 5.0) is single.layers["a"]
    for ext in (".h5", ".npz"):
        open(tmp_path / f"x{ext}", "w").close()
    assert find_granule(str(tmp_path), "x") == jfind(str(tmp_path), "x") \
        == str(tmp_path / "x.npz")
    assert find_granule(str(tmp_path), "y") is None
