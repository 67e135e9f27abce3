"""The VIIRS commands of ``plumekit_torch.cli`` against the JAX CLI on the
same synthetic roots: ``make_dataset --viirs-swaths --viirs-aod-pairs``
(swath arrays, h5 datasets, ``fires_viirs_aod.csv`` as text),
``resample_viirs`` (the ``.h5`` products), ``identify_viirs --device
cpu`` (mask arrays in value and dtype, bbox CSVs as text), the resume
skip, the missing fire table, and the refusals without h5py."""

import os
import sys

import numpy as np
import pytest
import torch

from plumekit import cli as jax_cli
from plumekit_torch import cli

h5py = pytest.importorskip("h5py")


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


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = path
    return out


def _h5(path):
    with h5py.File(path, "r") as f:
        data = {}
        f.visititems(lambda k, v: data.__setitem__(k, np.asarray(v))
                     if isinstance(v, h5py.Dataset) else None)
        attrs = {k: np.asarray(v) for k, v in f.attrs.items()}
    return data, attrs


def _same_file(got, want):
    if got.endswith((".csv", ".txt")):
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read(), got
    elif got.endswith(".npz"):
        with np.load(got) as a, np.load(want) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                _same(a[k], b[k])
    elif got.endswith(".h5"):
        (gd, ga), (wd, wa) = _h5(got), _h5(want)
        assert sorted(gd) == sorted(wd) and sorted(ga) == sorted(wa)
        for k in wd:
            _same(gd[k], wd[k])
        for k in wa:
            _same(ga[k], wa[k])
    else:
        raise AssertionError(f"unexpected file {got}")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Both CLIs' roots after make_dataset, resample_viirs and
    identify_viirs."""
    base = tmp_path_factory.mktemp("viirs_cli")
    out = {}
    for name, main, device in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_cli.main, [])):
        root = str(base / name)
        assert main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64", "--plumes", "1", "--viirs-swaths", "2",
                     "--viirs-aod-pairs", "2"]) == 0
        assert main(["resample_viirs", "--root", root,
                     "--pixel-size", "1500"]) == 0
        assert main(["identify_viirs", "--root", root, *device]) == 0
        out[name] = root
    return out


def test_every_file_equals_the_jax_cli(roots):
    got, want = _files(roots["port"]), _files(roots["jax"])
    assert sorted(got) == sorted(want)
    kinds = {os.path.dirname(k) for k in want}
    assert {"raw/viirs/sdr", "raw/viirs/aod", "raw/viirs/geo",
            "raw/viirs/masks", "raw/reprojected_viirs/h5",
            "raw/fires"} <= kinds
    for rel in want:
        _same_file(got[rel], want[rel])


def test_identify_viirs_found_the_planted_plumes(roots):
    masks = os.path.join(roots["port"], "raw/viirs/masks")
    csvs = sorted(m for m in os.listdir(masks) if m.endswith("_plumes.csv"))
    assert len(csvs) == 2
    for c in csvs:
        with open(os.path.join(masks, c)) as f:
            lines = f.read().splitlines()
        assert lines[0] == "plume_id,min_r,min_c,max_r,max_c"
        assert len(lines) >= 2
        with np.load(os.path.join(masks, c.replace("_plumes.csv",
                                                   "_mask.npz"))) as z:
            assert z["plume_image"].dtype == np.int32
            assert (z["plume_image"] > 0).sum() >= 100
            assert z["aod"].dtype == np.float32


def test_resume_skips_what_is_done(roots):
    root = roots["port"]
    outs = [p for p in _files(root).values()
            if "reprojected_viirs" in p or "viirs/masks" in p]
    mtimes = {p: os.path.getmtime(p) for p in outs}
    assert cli.main(["resample_viirs", "--root", root]) == 0
    assert cli.main(["identify_viirs", "--root", root, "--device",
                     "cpu"]) == 0
    assert {p: os.path.getmtime(p) for p in outs} == mtimes


def test_quicklooks_equal_the_jax_cli(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg

    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        root = str(tmp_path / name)
        assert main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64", "--viirs-swaths", "1"]) == 0
        assert main(["resample_viirs", "--root", root, "--quicklooks"]) == 0
    for sub, fname in (("blue", "viirs_sdr_0000_blue.png"),
                       ("tcc", "viirs_sdr_0000_tcc.png")):
        rel = os.path.join("raw/reprojected_viirs", sub, fname)
        _same(mpimg.imread(str(tmp_path / "port" / rel)),
              mpimg.imread(str(tmp_path / "jax" / rel)))


def test_missing_fire_table_and_no_pairs_exit_1(tmp_path):
    root = str(tmp_path / "r")
    assert cli.main(["identify_viirs", "--root", root, "--device",
                     "cpu"]) == 1                     # no fire table
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64", "--plumes", "1"]) == 0
    fires = os.path.join(root, "raw/fires/fires.csv")
    assert cli.main(["identify_viirs", "--root", root, "--fires", fires,
                     "--device", "cpu"]) == 1         # no pairs
    assert jax_cli.main(["identify_viirs", "--root", root]) == 1


def test_identify_viirs_needs_a_card_unless_told_the_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "r")
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64", "--viirs-aod-pairs", "1"]) == 0
    assert cli.main(["identify_viirs", "--root", root]) == 1
    assert not os.path.exists(os.path.join(root, "raw/viirs/masks"))


def test_without_h5py_the_file_commands_refuse_by_name(tmp_path,
                                                       monkeypatch, caplog):
    root = str(tmp_path / "r")
    assert cli.main(["make_dataset", "--root", root, "--n-granules", "1",
                     "--size", "64", "--viirs-swaths", "1"]) == 0
    monkeypatch.setitem(sys.modules, "h5py", None)    # import fails
    for argv in (["resample_viirs", "--root", root],
                 ["identify_viirs", "--root", root, "--device", "cpu"],
                 ["make_dataset", "--root", str(tmp_path / "r2"),
                  "--n-granules", "1", "--size", "64",
                  "--viirs-aod-pairs", "1"]):
        caplog.clear()
        assert cli.main(argv) == 1
        assert "requires h5py" in caplog.text
    h5_dir = os.path.join(root, "raw/reprojected_viirs/h5")
    assert not os.path.exists(h5_dir) or not os.listdir(h5_dir)
    assert not os.path.exists(tmp_path / "r2")       # nothing written


def _parser_tree(parser):
    """{command: {dest: (option strings, default, choices, nargs)}}."""
    import argparse

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            tuple(a.choices or ()), a.nargs)
                   for a in sp._actions if a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_parsers_differ_from_the_jax_cli_only_by_design():
    """Every JAX command is here (all 15, ``report`` too) with the JAX
    flags and defaults; the port adds ``--device`` (and ``evaluate_model
    --batch-tiles``) and exports for the card by default."""
    port, ref = _parser_tree(cli.build_parser()), \
        _parser_tree(jax_cli.build_parser())
    assert set(ref) == set(port) and len(ref) == 15
    for command in set(ref):
        for dest, spec in ref[command].items():
            if (command, dest) == ("export_model", "platforms"):
                assert port[command][dest][1] == "gpu,cpu"
                continue
            assert port[command][dest] == spec, (command, dest)
        extra = set(port[command]) - set(ref[command])
        assert extra <= {"device", "batch_tiles"}, (command, extra)
    for command in ("resample_viirs", "identify_viirs",
                    "verify_real_granule"):
        assert ("device" in port[command]) == (command != "resample_viirs")
