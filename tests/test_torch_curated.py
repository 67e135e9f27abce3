"""The port's curated training data (``plumekit_torch/train/curated.py``,
``prepare_model_data`` and ``train_model --curated``) against the JAX
package's: hull rasterisation, the model-ready samples (channels and masks
bit for bit), the curated dataset, and the whole loop make_dataset →
build_features → select --decisions → prepare_model_data → train_model
--curated through the port's CLI on the CPU, its reduced tables and
samples held against the JAX CLI's on a copy of the root."""

import logging
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from plumekit.cli import main as jax_main
from plumekit.config import PathsConfig as JaxPathsConfig
from plumekit.train import curated as jcur
from plumekit_torch import cli
from plumekit_torch.config import PathsConfig
from plumekit_torch.io.granule import Granule, save_granule
from plumekit_torch.io.synthetic import (SyntheticSceneConfig, make_scene,
                                         write_fire_csv)
from plumekit_torch.io.tables import Table
from plumekit_torch.ops.geometry import convex_hull_vertices_host
from plumekit_torch.train import curated as tcur


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hull_rows(mask, pid, dt=None):
    ys, xs = np.nonzero(mask)
    pts = np.column_stack([xs, ys]).astype(np.float64)
    verts = convex_hull_vertices_host(pts)
    rows = pd.DataFrame({"id": float(pid), "hull_lats": 10.0 + pid,
                         "hull_lons": 20.0, "hull_x": pts[verts, 0],
                         "hull_y": pts[verts, 1]})
    if dt is not None:
        rows["datetime"] = dt
    return rows


def _read_both(tmp_path, df):
    path = str(tmp_path / "h.csv")
    df.to_csv(path, index=False)
    return pd.read_csv(path), Table.read_csv(path)


def _ellipse(shape, cy, cx, ry, rx):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def _l_shape(shape, y, x):
    m = np.zeros(shape, bool)
    m[y:y + 20, x:x + 6] = True
    m[y + 14:y + 20, x:x + 20] = True
    return m


def _frames():
    shape = (64, 72)
    degenerate = pd.DataFrame({"id": 7.0, "hull_lats": 0.0, "hull_lons": 0.0,
                               "hull_x": [1.0, 2.0, 3.0],
                               "hull_y": [1.0, 2.0, 3.0]})
    two = pd.DataFrame({"id": 8.0, "hull_lats": 0.0, "hull_lons": 0.0,
                        "hull_x": [5.0, 9.0], "hull_y": [5.0, 9.0]})
    nan = pd.DataFrame({"id": 9.0, "hull_lats": 0.0, "hull_lons": 0.0,
                        "hull_x": [5.0, np.nan, 9.0],
                        "hull_y": [5.0, 7.0, 9.0]})
    edge = pd.DataFrame({"id": 10.0, "hull_lats": 0.0, "hull_lons": 0.0,
                         "hull_x": [-3.5, 80.2, 40.0],
                         "hull_y": [-2.0, 10.5, 70.9]})
    return shape, {
        "ellipse": _hull_rows(_ellipse(shape, 30, 28, 12, 5), 0),
        "union": pd.concat([_hull_rows(_ellipse(shape, 10, 10, 6, 9), 0),
                            _hull_rows(_l_shape(shape, 30, 40), 1)],
                           ignore_index=True),
        "degenerate": pd.concat([_hull_rows(_l_shape(shape, 2, 2), 3),
                                 degenerate, two, nan], ignore_index=True),
        "off_the_edge": edge,
    }


@pytest.mark.parametrize("name", sorted(_frames()[1]))
def test_rasterize_hulls_matches_jax(tmp_path, name):
    shape, frames = _frames()
    jdf, table = _read_both(tmp_path, frames[name])
    got = tcur.rasterize_hulls(table, shape)
    np.testing.assert_array_equal(got, jcur.rasterize_hulls(jdf, shape))
    assert got.dtype == bool and (got.any() or name == "degenerate")


def _scene(seed, size=96, n_layers=1):
    return make_scene(SyntheticSceneConfig(size=size, n_plumes=2, seed=seed,
                                           n_layers=n_layers,
                                           fires_per_plume=(3, 5)))


def _curation_root(tmp_path, fires="table"):
    """A root with two granules (one of two orbit layers), curated and
    full hull tables (device masks for one granule, one with an id the
    npz lacks), a basic bbox table, a table without a granule and an
    empty one; ``fires`` "table", "header" (no rows) or "none"."""
    root = str(tmp_path / "root")
    paths = PathsConfig(root=root)
    s0, s1 = _scene(3), _scene(4, n_layers=2)
    tables = []
    for name, s in (("g0", s0), ("g1", s1)):
        g = s.granule
        save_granule(os.path.join(paths.ensure("maiac_dir"), name + ".npz"),
                     Granule(g.layers, g.lat, g.lon, name))
        tables.append(s.fires)
    if fires != "none":
        table = {k: np.concatenate([t[k] for t in tables])
                 for k in ("latitude", "longitude", "frp", "acq_date")}
        if fires == "header":
            table = {k: v[:0] for k, v in table.items()}
        write_fire_csv(os.path.join(paths.ensure("fires_dir"), "fires.csv"),
                       table)
    shape = s0.granule.shape
    m0 = _l_shape(shape, 20, 30)
    m1 = _ellipse(shape, 60, 60, 8, 14)
    m2 = _ellipse(shape, 15, 70, 5, 5)
    np.savez_compressed(os.path.join(paths.ensure("plume_mask_dir"),
                                     "g0_masks.npz"),
                        **{"0": m0, "1": m1})
    np.savez_compressed(os.path.join(paths.resolve("plume_mask_dir"),
                                     "g1_masks.npz"), **{"0": m0})
    ts1 = list(s1.granule.layers)
    g0 = pd.concat([_hull_rows(m0, 0), _hull_rows(m1, 1)], ignore_index=True)
    g1 = pd.concat([_hull_rows(m0, 0, ts1[1]), _hull_rows(m2, 5, ts1[1]),
                    _hull_rows(m1, 1, ts1[0])], ignore_index=True)
    for key, frames in (("reduced_plume_hull_dir", (g0, g1.iloc[:-4])),
                        ("hull_df_dir", (g0, g1))):
        d = paths.ensure(key)
        frames[0].to_csv(os.path.join(d, "g0_extent.csv"), index=False)
        frames[1].to_csv(os.path.join(d, "g1_extent.csv"), index=False)
        g0.to_csv(os.path.join(d, "orphan_extent.csv"), index=False)
        g0.iloc[:0].to_csv(os.path.join(d, "empty_extent.csv"), index=False)
        pd.DataFrame({"id": [0], "plume_min_row": [1]}).to_csv(
            os.path.join(d, "basic_extent.csv"), index=False)
    return root


def _samples(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with np.load(os.path.join(d, f)) as z:
            out[f] = {k: z[k] for k in z.files}
    return out


def _same_samples(got, want):
    assert sorted(got) == sorted(want) and got
    for f in got:
        assert sorted(got[f]) == sorted(want[f]) == ["channels", "mask"]
        for k in got[f]:
            assert got[f][k].dtype == want[f][k].dtype == np.float32
            np.testing.assert_array_equal(got[f][k], want[f][k])


@pytest.mark.parametrize("use_masks", [True, False])
@pytest.mark.parametrize("uncurated", [False, True])
@pytest.mark.parametrize("fires", ["table", "header", "none"])
def test_build_model_data_matches_jax(tmp_path, use_masks, uncurated,
                                      fires):
    root = _curation_root(tmp_path, fires)
    got_dir, want_dir = str(tmp_path / "got"), str(tmp_path / "want")
    os.makedirs(got_dir)
    os.makedirs(want_dir)
    got = tcur.build_model_data(PathsConfig(root=root), out_dir=got_dir,
                                use_masks=use_masks, uncurated=uncurated)
    want = jcur.build_model_data(JaxPathsConfig(root=root), out_dir=want_dir,
                                 use_masks=use_masks, uncurated=uncurated)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    _same_samples(_samples(got_dir), _samples(want_dir))
    # the rg table has no datetime: the granule's first layer key names it
    assert "g0__20172000000A.npz" in os.listdir(got_dir)
    samples = tcur.make_curated_dataset(got_dir)
    jsamples = jcur.make_curated_dataset(want_dir)
    assert len(samples) == len(jsamples) == len(got)
    for s, w in zip(samples, jsamples):
        np.testing.assert_array_equal(s.channels, w.channels)
        np.testing.assert_array_equal(s.mask, w.mask)


def test_masks_for_kept_ids_and_channels_match_jax(tmp_path):
    root = _curation_root(tmp_path)
    npz = os.path.join(root, "interim", "plume_masks", "g0_masks.npz")
    for ids in ([0.0], [0.0, 1.0], [1.0, 2.0]):
        got = tcur.masks_for_kept_ids(npz, ids, (96, 96))
        want = jcur.masks_for_kept_ids(npz, ids, (96, 96))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError, match="prepare_model_data"):
        tcur.make_curated_dataset(str(tmp_path))


def test_prepare_model_data_cli_matches_jax_cli(tmp_path):
    want_root = _curation_root(tmp_path)
    got_root = str(tmp_path / "got")
    shutil.copytree(want_root, got_root)
    for flags in ([], ["--hulls-only"], ["--uncurated"]):
        for root in (want_root, got_root):
            shutil.rmtree(os.path.join(root, "processed"), ignore_errors=True)
        assert jax_main(["prepare_model_data", "--root", want_root,
                         *flags]) == 0
        assert cli.main(["prepare_model_data", "--root", got_root,
                         *flags]) == 0
        _same_samples(_samples(os.path.join(got_root, "processed",
                                            "model_data")),
                      _samples(os.path.join(want_root, "processed",
                                            "model_data")))
    empty = str(tmp_path / "empty")
    assert cli.main(["prepare_model_data", "--root", empty]) == 1
    assert jax_main(["prepare_model_data", "--root", empty]) == 1


def test_curated_loop_through_the_cli_on_the_cpu(tmp_path, caplog):
    """make_dataset → build_features rg → select --decisions (every plume
    kept) → prepare_model_data → train_model --curated, through the port's
    CLI on the CPU; the reduced tables and the samples are the JAX CLI's
    on a copy of the root."""
    root = str(tmp_path / "root")
    dev = ["--root", root, "--device", "cpu"]
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "2",
                     "--size", "128", "--plumes", "2"]) == 0
    assert cli.main(["build_features", *dev, "--detector", "rg"]) == 0
    hull_dir = PathsConfig(root=root).resolve("hull_df_dir")
    rows = []
    for f in sorted(os.listdir(hull_dir)):
        t = Table.read_csv(os.path.join(hull_dir, f))
        rows += [(int(pid), "layer0", 1) for pid in sorted(set(t.column(
            "id")))]
    assert rows
    dec = str(tmp_path / "decisions.csv")
    Table(("id", "datetime", "keep"), rows).to_csv(dec)
    jax_root = str(tmp_path / "jax")
    shutil.copytree(root, jax_root)
    assert jax_main(["select", "--root", jax_root, "--decisions", dec]) == 0
    assert cli.main(["select", "--root", root, "--decisions", dec]) == 0
    for key in ("reduced_plume_hull_dir", "reduced_not_plume_hull_dir"):
        got_dir = PathsConfig(root=root).resolve(key)
        want_dir = JaxPathsConfig(root=jax_root).resolve(key)
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
        for f in os.listdir(got_dir):
            with open(os.path.join(got_dir, f)) as g, \
                    open(os.path.join(want_dir, f)) as w:
                assert g.read() == w.read()
    assert jax_main(["prepare_model_data", "--root", jax_root]) == 0
    assert cli.main(["prepare_model_data", "--root", root]) == 0
    _same_samples(_samples(PathsConfig(root=root).resolve("model_data_dir")),
                  _samples(JaxPathsConfig(root=jax_root).resolve(
                      "model_data_dir")))
    with caplog.at_level(logging.INFO):
        assert cli.main(["train_model", *dev, "--curated", "--steps", "2",
                         "--batch-size", "2", "--tile", "64"]) == 0
    assert "curated dataset:" in caplog.text
    ck = os.path.join(root, "models", "checkpoints")
    assert sorted(os.listdir(ck)) == ["model_config.json", "step_00000002.pt",
                                      "weights.pt"]
