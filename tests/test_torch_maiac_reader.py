"""The port's MAIAC MCD19A2 reader (``plumekit_torch.io.granule.
read_maiac_hdf4`` on ``io/hdf4.py``) against the JAX package's
``read_maiac_hdf4``, which runs unchanged on the same real HDF4 files with
the C library standing in for ``pyhdf`` (``tests/torch_hdf4_lib.py``'s
shim): layer keys, arrays, lat and lon bit for bit, and the same named
errors. The committed fixtures (``tests/data/maiac/``, written by
``tools/make_maiac_fixtures.py``) are also held against the arrays
regenerated from seed 0, which needs no library; the cases of
tests/test_io_hdf4.py and tests/test_real_data_contracts.py that touch
``.hdf`` are mirrored on files written here. Then the slice: the
``.hdf`` granule through ``build_features``, ``identify``,
``predict_model`` and ``verify_real_granule`` on the CPU, against the same
arrays read from ``.npz``."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from plumekit.geo import sinusoidal as jax_sinusoidal
from plumekit.io import granule as jax_granule
from plumekit_torch import cli
from plumekit_torch.geo import sinusoidal
from plumekit_torch.io import granule, prefetch
from plumekit_torch.io.verify import verify_granule

sys.path.insert(0, os.path.dirname(__file__))
import torch_hdf4_lib as lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import make_maiac_fixtures as mf  # noqa: E402

needs_lib = pytest.mark.skipif(not lib.available(),
                               reason="needs the HDF4 C library "
                                      "(libdfalt.so.0, libmfhdfalt.so.0)")
FIXTURES = mf.fixtures()
DATA = mf.OUT_DIR
VALID = sorted(f for f, fx in FIXTURES.items() if fx.error is None)
BROKEN = sorted(f for f, fx in FIXTURES.items() if fx.error is not None)
SMALL_VALID = [f for f in VALID if f != mf.FULL_NAME + ".hdf"]
# what the C library itself reads: the coders other than deflate
LIBRARY_READS = ("maiac_skphuff.hdf", "maiac_rle.hdf")


def _assert_same_granule(got, want):
    assert got.name == want.name
    assert list(got.layers) == list(want.layers)
    for k in want.layers:
        assert got.layers[k].dtype == want.layers[k].dtype == np.float32
        assert got.layers[k].tobytes() == want.layers[k].tobytes(), k
    for a, b in ((got.lat, want.lat), (got.lon, want.lon)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.fixture
def jax_reader(monkeypatch):
    """The JAX package's reader, ``pyhdf`` being the library's shim."""
    pkg, sd_mod = lib.pyhdf_modules()
    monkeypatch.setitem(sys.modules, "pyhdf", pkg)
    monkeypatch.setitem(sys.modules, "pyhdf.SD", sd_mod)
    return jax_granule.read_maiac_hdf4


# ------------------------------------------------- the committed fixtures

def test_fixtures_are_committed_and_small():
    sizes = {f: os.path.getsize(os.path.join(DATA, f)) for f in FIXTURES}
    assert sum(sizes.values()) < 3 * 2 ** 20
    assert sizes["maiac_truncated.hdf"] == mf.TRUNCATED_BYTES


def test_full_size_fixture_is_the_bench_scene():
    from plumekit_torch.experiments.ccl_pass_times import BENCH_SCENE

    assert mf.BENCH_SCENE == BENCH_SCENE
    fx = FIXTURES[mf.FULL_NAME + ".hdf"]
    assert fx.raw.shape == (4, 1200, 1200) and fx.raw.dtype == np.int16
    assert len(fx.stamps.split()) == 4      # the >4 rule does not fire


@pytest.mark.parametrize("name", VALID)
def test_fixture_reads_as_the_seeds_arrays(name):
    """Every layer, the grid and the name bit for bit against the arrays
    regenerated from seed 0 (no library needed)."""
    got = granule.load_granule(os.path.join(DATA, name))
    _assert_same_granule(got, mf.expected_granule(FIXTURES[name]))


@pytest.mark.parametrize("name", BROKEN)
def test_broken_fixture_gives_its_named_error(name):
    with pytest.raises(ValueError, match=FIXTURES[name].error) as e:
        granule.load_granule(os.path.join(DATA, name))
    assert name in str(e.value)


@pytest.mark.parametrize("name", SMALL_VALID)
def test_fixture_storage_form(name):
    from plumekit_torch.io.hdf4 import SDFile

    with SDFile(os.path.join(DATA, name)) as f:
        storage = f.select("Optical_Depth_055").storage
    assert storage == {"contiguous": "contiguous",
                       "deflate": "compressed (deflate)",
                       "chunked": "chunked", "chunked_deflate": "chunked",
                       "linked": "linked blocks",
                       "unwritten": "unwritten"}[FIXTURES[name].storage]


@needs_lib
@pytest.mark.parametrize("name", VALID)
def test_fixture_equals_the_jax_reader(name, jax_reader):
    path = os.path.join(DATA, name)
    _assert_same_granule(granule.load_granule(path), jax_reader(path))


@needs_lib
@pytest.mark.parametrize("name", ["maiac_five_orbits_terra.hdf",
                                  "maiac_malformed_stamp.hdf"])
def test_fixture_errors_equal_the_jax_readers(name, jax_reader):
    path = os.path.join(DATA, name)
    with pytest.raises(ValueError) as want:
        jax_reader(path)
    with pytest.raises(ValueError) as got:
        granule.read_maiac_hdf4(path)
    assert str(got.value) == str(want.value)


@needs_lib
@pytest.mark.parametrize("name", LIBRARY_READS)
def test_other_coders_are_refused_where_the_library_reads(name, jax_reader):
    """The C library decodes skipping Huffman and RLE; the port names the
    coder instead of returning anything."""
    path = os.path.join(DATA, name)
    want = jax_reader(path)
    assert set(want.layers) == {"20172131535T", "20172131710A"}
    with pytest.raises(ValueError, match="coder"):
        granule.load_granule(path)


@needs_lib
@pytest.mark.parametrize("kw", [dict(max_layers_rule=False),
                                dict(correct_orbit_layer=True)])
@pytest.mark.parametrize("name", ["maiac_five_orbits_aqua_third.hdf",
                                  "maiac_five_orbits_terra.hdf"])
def test_orbit_rule_options_equal_the_jax_reader(name, kw, jax_reader):
    path = os.path.join(DATA, name)
    try:
        want = jax_reader(path, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="Aqua"):
            granule.read_maiac_hdf4(path, **kw)
        assert "Aqua" in str(e)
        return
    _assert_same_granule(granule.read_maiac_hdf4(path, **kw), want)


@needs_lib
def test_committed_fixtures_match_a_fresh_write(tmp_path):
    """``tools/make_maiac_fixtures.py`` writes files whose contents are the
    committed ones (the library stamps nothing that varies by run)."""
    assert mf.main(["--out", str(tmp_path)]) == 0
    for name in FIXTURES:
        with open(os.path.join(DATA, name), "rb") as a, \
                open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name


# ----------------------- tests/test_io_hdf4.py and test_real_data_contracts

H, W = 6, 5
STRUCT_META = (                     # tests/test_io_hdf4.py's
    "GROUP=GridStructure\n\tGROUP=GRID_1\n\t\tGridName=\"grid1km\"\n"
    f"\t\tUpperLeftPointMtrs=({mf.X0:.6f},{mf.Y0:.6f})\n"
    f"\t\tLowerRightMtrs=({mf.X1:.6f},{mf.Y1:.6f})\n"
    "\tEND_GROUP=GRID_1\nEND_GROUP=GridStructure")


def _stub_like(tmp_path, name, stamps, meta=STRUCT_META,
               storage="deflate"):
    """A real file holding what tests/test_io_hdf4.py's stub serves: layer
    i at raw (i+1)*100, one MAIAC fill at [0, 0]."""
    n = max(1, len([t for t in stamps.split(" ") if t]))
    data = np.stack([np.full((H, W), (i + 1) * 100, np.int16)
                     for i in range(n)])
    data[:, 0, 0] = mf.MAIAC_FILL
    path = str(tmp_path / name)
    with lib.Writer(path) as w:
        w.attr("Orbit_time_stamp", stamps)
        w.attr("StructMetadata.0", meta)
        w.sds("Optical_Depth_055", data, storage=storage, chunks=(1, 4, 4))
    return path


def _both(path, jax_reader, **kw):
    """(port, JAX) results of one file: Granules, or the ValueErrors."""
    out = []
    for read in (granule.read_maiac_hdf4, jax_reader):
        try:
            out.append(read(path, **kw))
        except ValueError as e:
            out.append(e)
    return out


@needs_lib
@pytest.mark.parametrize("storage", ["contiguous", "deflate",
                                     "chunked_deflate"])
def test_two_orbits_scale_null_and_grid(tmp_path, jax_reader, storage):
    path = _stub_like(tmp_path, "fake_granule.hdf",
                      "20172301915T  20172302054A ", storage=storage)
    got, want = _both(path, jax_reader)
    _assert_same_granule(got, want)
    assert list(got.layers) == ["20172301915T", "20172302054A"]
    assert got.layers["20172301915T"][1, 1] == np.float32(100) * 0.001
    assert got.layers["20172302054A"][0, 0] == granule.NULL_VALUE
    lon00, lat00 = sinusoidal.sinusoidal_to_wgs84(mf.X0, mf.Y0)
    assert got.lat[0, 0] == pytest.approx(lat00)
    assert got.lon[0, 0] == pytest.approx(lon00)


@needs_lib
@pytest.mark.parametrize("kw,stamp,value", [
    ({}, "20172300330A", 100),                      # the quirk: layer 0
    (dict(correct_orbit_layer=True), "20172300330A", 300),
    (dict(max_layers_rule=False), None, None)])
def test_more_than_four_orbits(tmp_path, jax_reader, kw, stamp, value):
    path = _stub_like(tmp_path, "fake_granule.hdf",
                      "20172300010T 20172300150T 20172300330A "
                      "20172300510T 20172300650A")
    got, want = _both(path, jax_reader, **kw)
    _assert_same_granule(got, want)
    if stamp is None:
        assert len(got.layers) == 5
        assert got.layers["20172300650A"][1, 1] == np.float32(500) * 0.001
    else:
        assert list(got.layers) == [stamp]
        assert got.layers[stamp][1, 1] == np.float32(value) * 0.001


@needs_lib
def test_many_orbit_granule(tmp_path, jax_reader):
    stamps = " ".join(f"201723000{i}0{'A' if i in (3, 6) else 'T'}"
                      for i in range(8))
    got, want = _both(_stub_like(tmp_path, "eight_orbits.hdf", stamps),
                      jax_reader)
    _assert_same_granule(got, want)
    assert list(got.layers) == ["20172300030A"]


@needs_lib
def test_load_granule_dispatches_hdf(tmp_path, jax_reader):
    path = _stub_like(tmp_path, "scene_T.hdf", "20172301915T")
    got, want = granule.load_granule(path), jax_granule.load_granule(path)
    _assert_same_granule(got, want)
    assert got.name == "scene_T"


@needs_lib
@pytest.mark.parametrize("stamps,meta,match", [
    ("GARBAGE", STRUCT_META, "malformed orbit timestamp"),
    ("   ", STRUCT_META, "none is an Aqua|0 orbit"),
    ("20172300010T 20172300150T 20172300330T 20172300510T 20172300650T",
     STRUCT_META, "Aqua"),
    ("20172302054A", "GROUP=GridStructure END_GROUP", "StructMetadata")])
def test_named_errors_equal_the_jax_readers(tmp_path, jax_reader, stamps,
                                            meta, match):
    got, want = _both(_stub_like(tmp_path, "weird.hdf", stamps, meta),
                      jax_reader)
    assert isinstance(got, ValueError) and isinstance(want, ValueError)
    assert str(got) == str(want)
    assert any(m in str(got) for m in match.split("|"))


@needs_lib
def test_a_missing_attribute_is_named(tmp_path):
    path = str(tmp_path / "no_stamps.hdf")
    with lib.Writer(path) as w:
        w.attr("StructMetadata.0", STRUCT_META)
        w.sds("Optical_Depth_055", np.zeros((1, H, W), np.int16))
    with pytest.raises(ValueError, match="no global attribute "
                                         "'Orbit_time_stamp'"):
        granule.load_granule(path)


@pytest.mark.parametrize("meta", [
    STRUCT_META,
    STRUCT_META.replace("\t", "   ").replace("\n", "\r\n"),
    "UpperLeftPointMtrs=( +1.5 , -2.25 )\nLowerRightMtrs=(3.0,-4.0)",
    mf.struct_metadata(1200, 1200, pad=True).rstrip("\0"),
    "GROUP=GridStructure END_GROUP",
    "UpperLeftPointMtrs=(1,2)\nLowerRightMtrs=(3.0,4.0)",
    ""])
def test_parse_struct_metadata_equals_the_jax_one(meta):
    try:
        want = jax_sinusoidal.parse_struct_metadata(meta)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sinusoidal.parse_struct_metadata(meta)
        assert str(got.value) == str(e)
        return
    assert sinusoidal.parse_struct_metadata(meta) == want


# ------------------------------------------------------------ verify

@pytest.mark.parametrize("name", SMALL_VALID)
def test_verify_passes_every_fixture(name):
    res = verify_granule(os.path.join(DATA, name), run_identify=False,
                         device="cpu")
    by = {c.name: c for c in res.checks}
    assert by["decode"].status == "pass"
    assert by["orbit_stamps"].status == "pass"
    assert res.ok, res.summary()


@needs_lib
@pytest.mark.parametrize("name", ["maiac_contiguous.hdf",
                                  "maiac_five_orbits_aqua_third.hdf",
                                  "maiac_malformed_stamp.hdf"])
def test_verify_equals_the_jax_register(name, jax_reader):
    from plumekit.io.verify import verify_granule as jax_verify

    path = os.path.join(DATA, name)
    got = verify_granule(path, run_identify=False, device="cpu")
    want = jax_verify(path, run_identify=False)
    assert [(c.name, c.status) for c in got.checks] == \
        [(c.name, c.status) for c in want.checks]
    assert got.checks[0].detail == want.checks[0].detail


@pytest.mark.parametrize("name", BROKEN)
def test_verify_names_each_broken_fixture(name):
    res = verify_granule(os.path.join(DATA, name), run_identify=False,
                         device="cpu")
    assert not res.ok and res.checks[0].name == "decode"
    assert "UNNAMED" not in res.checks[0].detail
    assert FIXTURES[name].error.split()[0] in res.checks[0].detail


# ------------------------------------------------------------- the slice

def _small_root(tmp_path, ext):
    """A root whose one granule is the chunked deflate fixture, as ``.hdf``
    or as an ``.npz`` of the regenerated arrays, with the small scene's
    fires."""
    root = str(tmp_path / ext)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires)
    fx = FIXTURES["maiac_chunked_deflate.hdf"]
    if ext == "hdf":
        shutil.copy(os.path.join(DATA, fx.file), maiac)
    else:
        granule.save_granule(os.path.join(maiac, fx.name + ".npz"),
                             mf.expected_granule(fx))
    from plumekit_torch.io.synthetic import make_scene, write_fire_csv

    scene = make_scene(mf.tile_scene_config(size=mf.SMALL[0], null_blobs=2,
                                            null_blob_sigma=4.0))
    write_fire_csv(os.path.join(fires, "fires.csv"), scene.fires)
    return root, os.path.join(maiac, os.listdir(maiac)[0]), \
        os.path.join(fires, "fires.csv")


def _tree(root, skip=("maiac", "fires")):
    """{relative path: bytes} of every file a command wrote under root."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in skip]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("detector", ["rg", "basic"])
def test_build_features_reads_hdf_as_npz(tmp_path, detector):
    """The same CSVs, masks and logs from the ``.hdf`` granule as from the
    ``.npz`` of its arrays (the log names the file, so by base name)."""
    outs = {}
    for ext in ("hdf", "npz"):
        root, _, _ = _small_root(tmp_path, ext)
        assert cli.main(["build_features", "--root", root, "--detector",
                         detector, "--device", "cpu"]) == 0
        outs[ext] = {k: v.replace(b".hdf", b"").replace(b".npz", b"")
                     for k, v in _tree(root).items()}
    assert outs["hdf"] == outs["npz"] and outs["hdf"]


def test_identify_and_predict_model_read_hdf_as_npz(tmp_path, capsys):
    import torch

    from plumekit_torch.config import UNetConfig
    from plumekit_torch.models import build_model
    from plumekit_torch.train.checkpoint import (save_model_config,
                                                 save_weights)

    printed, preds = {}, {}
    for ext in ("hdf", "npz"):
        root, gpath, fpath = _small_root(tmp_path, ext)
        capsys.readouterr()
        assert cli.main(["identify", gpath, fpath, "--detector", "rg",
                         "--device", "cpu"]) == 0
        printed[ext] = capsys.readouterr().out
        ckpt = os.path.join(root, "models", "checkpoints")
        cfg = UNetConfig(in_channels=2, base_features=4, depth=2,
                         compute_dtype="float32")
        torch.manual_seed(0)
        save_model_config(ckpt, cfg)
        save_weights(ckpt, build_model(cfg))
        assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                         "--tile", "32", "--overlap", "8"]) == 0
        preds[ext] = _tree(os.path.join(root, "processed"), skip=())
    assert printed["hdf"] == printed["npz"] and "plumes" in printed["hdf"]
    assert preds["hdf"] == preds["npz"] and preds["hdf"]


def test_verify_real_granule_cli_on_hdf(tmp_path, capsys):
    _, gpath, fpath = _small_root(tmp_path, "hdf")
    assert cli.main(["verify_real_granule", gpath, "--fires", fpath,
                     "--detector", "rg", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] and not summary["failed"], summary
    assert summary["skipped"] == []


def test_decode_pool_reads_fixtures_in_threads():
    """``io/prefetch.decode_pool`` (the reader from several threads) gives
    what serial reads give."""
    names = VALID * 2
    paths = [os.path.join(DATA, n) for n in names]
    serial = [granule.load_granule(p) for p in paths]
    pooled = list(prefetch.decode_pool(paths, granule.load_granule,
                                       workers=4, depth=4))
    assert len(pooled) == len(serial)
    for got, want in zip(pooled, serial):
        _assert_same_granule(got, want)
