"""The serving-geometry tuner of plumekit_torch (``infer/tune.py``, ``tune``
and ``--tuned``) against the JAX package's: candidate parsing with its
messages, the sweep's ranking and failure rule on the CPU at tiny
geometries, the artifact read across packages, ``_apply_tuned``, and
``tune`` then ``predict_model --tuned`` against the explicit flags and the
JAX CLI. Also the tile rules of K6, K7 and Q1 at every shape the tuner's
default grid gives them at a 2048² granule (plan only: the kernels run on
the card, ``tests/test_torch_kernels_cuda.py``)."""

import dataclasses
import logging
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.cli import _apply_tuned as jax_apply_tuned
from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import tune as jax_tune
from plumekit.models import build_model as jax_build_model
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.experiments.conv_kernel_times import block_shapes
from plumekit_torch.experiments.int8_conv_times import conv_cases
from plumekit_torch.infer import tune
from plumekit_torch.infer.sliding import _effective_batch, tile_grid
from plumekit_torch.models import build_model
from plumekit_torch.models.kernels import conv_tiles, int8_conv, unet_mega
from plumekit_torch.train.checkpoint import save_weights
from test_torch_cli import PROB_TOL, SERVE, _predictions, _root

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
GRANULE = 2048                     # the tuner's default granule
SMS = 132                          # an H100 SXM's multiprocessors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- candidates

@pytest.mark.parametrize("spec,granules", [
    ("32/0,48/16/8", (1, 2)),
    (tune.DEFAULT_CANDIDATES, (1, 2, 4)),
    (" 64/8 , 64/0/2 ", (3,)),
    ("32/32", (1,)),                 # overlap >= tile
    ("32", (1,)),                    # malformed
    ("32/0/4/1", (1,)),              # too many fields
    ("256/-32", (1,)),               # gap stripes
    ("0/0", (1,)),                   # overlap not below the tile
    ("32/0/0", (1,)),                # zero batch
    ("32/0", (0,)),                  # zero G
    ("  ,", (1,)),                   # empty field
    ("a/0", (1,)),                   # not a number
    ("", ())])                       # no granule counts
def test_parse_candidates_matches_jax(spec, granules):
    def run(parse):
        try:
            return [dataclasses.astuple(g) for g in parse(spec, granules)]
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(tune.parse_candidates) == run(jax_tune.parse_candidates)
    assert tune.DEFAULT_CANDIDATES == jax_tune.DEFAULT_CANDIDATES
    assert (tune.TUNED_BASENAME, tune.TUNED_VERSION) == (
        jax_tune.TUNED_BASENAME, jax_tune.TUNED_VERSION)


# --------------------------------------------------------------------- sweep

@pytest.fixture(scope="module")
def tiny_model():
    return build_model(UNetConfig(**KW), torch.Generator().manual_seed(0))


def _sweep(model, spec="32/0/4,32/8/4", granules=(1, 2)):
    return tune.tune_geometry(cli._module_forward, model, 2, 64,
                              tune.parse_candidates(spec, granules),
                              repeats=1, device="cpu")


def test_tune_geometry_ranks_like_the_jax_sweep(tiny_model):
    payload = _sweep(tiny_model)
    rates = [r["mpix_s"] for r in payload["results"]]
    assert len(rates) == 4 and all(v and v > 0 for v in rates)
    assert rates == sorted(rates, reverse=True)
    assert payload["best"] == payload["results"][0]
    assert payload["best_blended"]["overlap"] == 8
    assert payload["best_blended"]["mpix_s"] == max(
        r["mpix_s"] for r in payload["results"] if r["overlap"])
    assert (payload["platform"], payload["device_kind"]) == ("cpu", "cpu")
    assert payload["version"] == tune.TUNED_VERSION
    # the same keys as the JAX payload's, in the payload and in each row
    cfg = JaxUNetConfig(**KW)
    model = jax_build_model(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)),
                           train=False)
    want = jax_tune.tune_geometry(model.apply, variables, 2, 64,
                                  jax_tune.parse_candidates("32/8/4"),
                                  repeats=1)
    assert set(payload) == set(want)
    assert set(payload["results"][0]) == set(want["results"][0])


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4 GiB"),
    ValueError("no tile of a 512x512 plane fits 256 rows")],
    ids=["out_of_memory", "shape_refused"])
def test_refused_candidate_is_ranked_last(tiny_model, monkeypatch, exc):
    real = tune.time_geometry

    def flaky(apply_fn, variables, stack, geom, channels, repeats=3):
        if geom.overlap == 8:
            raise exc
        return real(apply_fn, variables, stack, geom, channels, repeats)

    monkeypatch.setattr(tune, "time_geometry", flaky)
    payload = _sweep(tiny_model, granules=(1,))
    assert payload["best"]["overlap"] == 0
    failed = payload["results"][-1]
    assert failed["mpix_s"] is None
    assert failed["error"] == f"{type(exc).__name__}: {exc}"
    assert payload["best_blended"] is None      # the one blended one failed


def test_a_kernel_fault_propagates(tiny_model, monkeypatch):
    """A launch error is no slow geometry: the sweep stops there."""
    def fault(*_a, **_k):
        raise RuntimeError("fused double-conv kernel launch failed: "
                           "unspecified launch failure")

    monkeypatch.setattr(tune, "time_geometry", fault)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _sweep(tiny_model)


def test_every_candidate_refused_raises_the_jax_message(tiny_model,
                                                        monkeypatch):
    def refuse(*_a, **_k):
        raise ValueError("nothing fits")

    monkeypatch.setattr(tune, "time_geometry", refuse)
    monkeypatch.setattr(jax_tune, "time_geometry", refuse)
    with pytest.raises(RuntimeError) as got:
        _sweep(tiny_model)
    with pytest.raises(RuntimeError) as want:
        jax_tune.tune_geometry(None, None, 2, 64,
                               jax_tune.parse_candidates("32/0/4,32/8/4",
                                                         (1, 2)), repeats=1)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("every candidate geometry failed")


# ------------------------------------------------------------------ artifact

def test_save_load_tuned_roundtrip_and_validation(tmp_path):
    best = {"tile": 32, "overlap": 0, "batch_tiles": 4, "granules": 2,
            "mpix_s": 1.0}
    payload = {"version": tune.TUNED_VERSION, "best": best, "results": [best]}
    path = str(tmp_path / "models" / "t.json")   # the directory is made
    tune.save_tuned(path, payload)
    assert tune.load_tuned(path) == payload
    assert not list((tmp_path / "models").glob("*.tmp"))
    for bad, match in [(dict(payload, version=99), "version"),
                       ({"version": tune.TUNED_VERSION,
                         "best": {"tile": 32, "overlap": 0}}, "malformed"),
                       ({"version": tune.TUNED_VERSION,
                         "best": dict(best, granules=2.0)}, "malformed")]:
        tune.save_tuned(path, bad)
        with pytest.raises(ValueError, match=match) as got:
            tune.load_tuned(path)
        with pytest.raises(ValueError) as want:
            jax_tune.load_tuned(path)
        assert str(got.value) == str(want.value)


def test_artifacts_load_across_packages(tmp_path, tiny_model):
    payload = _sweep(tiny_model)
    payload.update(int8=False, arch="unet")
    port_path = str(tmp_path / "port.json")
    tune.save_tuned(port_path, payload)
    assert jax_tune.load_tuned(port_path) == payload
    best = {"tile": 48, "overlap": 16, "batch_tiles": 8, "granules": 4,
            "mpix_s": 12.5}
    jax_payload = {"version": jax_tune.TUNED_VERSION, "best": best,
                   "best_blended": best, "results": [best], "granule": 64,
                   "platform": "tpu", "device_kind": "TPU v5 lite"}
    jax_path = str(tmp_path / "jax.json")
    jax_tune.save_tuned(jax_path, jax_payload)
    assert tune.load_tuned(jax_path) == jax_payload


def _artifact(root, **extra):
    best = {"tile": 32, "overlap": 0, "batch_tiles": 4, "granules": 2,
            "mpix_s": 123.0}
    path = os.path.join(root, "models", tune.TUNED_BASENAME)
    tune.save_tuned(path, {"version": tune.TUNED_VERSION, "best": best,
                           "results": [best], "best_blended": None, **extra})
    return path


@pytest.mark.parametrize("serving,artifact", [
    (dict(int8=False), {}),
    (dict(int8=False), dict(int8=False, arch="unet")),
    (dict(int8=False), dict(int8=True, arch="unet")),
    (dict(int8=True), dict(int8=False, arch="unetpp")),
    (dict(int8=True, arch="unetpp"), dict(int8=True, arch="unetpp"))],
    ids=["bare", "same", "int8", "both", "unetpp"])
def test_apply_tuned_matches_jax(tmp_path, caplog, serving, artifact):
    """The four flags overridden as the JAX CLI overrides them, and the
    same warnings in the same words when the artifact was measured for
    another forward or architecture."""
    root = str(tmp_path)
    _artifact(root, **artifact)
    arch = serving.get("arch", "unet")
    flags = {}
    for apply, cfg, name in [
            (jax_apply_tuned, JaxUNetConfig(arch=arch), "plumekit.cli"),
            (cli._apply_tuned, UNetConfig(arch=arch), "plumekit_torch.cli")]:
        args = Namespace(root=root, tuned="auto", exported=None,
                         int8=serving["int8"], tile=288, overlap=32,
                         batch_tiles=64, batch_granules=1)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            apply(args, cfg)
        flags[name] = ((args.tile, args.overlap, args.batch_tiles,
                        args.batch_granules),
                       [r.getMessage() for r in caplog.records
                        if r.name == name and r.levelno == logging.WARNING])
    assert flags["plumekit_torch.cli"] == flags["plumekit.cli"]
    assert flags["plumekit.cli"][0] == (32, 0, 4, 2)
    mismatched = sum(artifact.get(k, v) != v for k, v in
                     (("int8", serving["int8"]), ("arch", arch)))
    assert len(flags["plumekit.cli"][1]) == mismatched


def test_apply_tuned_refuses_a_missing_or_bad_artifact(tmp_path):
    args = Namespace(root=str(tmp_path / "empty"), tuned="auto", int8=False)
    with pytest.raises(cli._CliError, match="not found"):
        cli._apply_tuned(args)
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    with pytest.raises(cli._CliError, match="--tuned"):
        cli._apply_tuned(Namespace(root=str(tmp_path), tuned=str(path),
                                   int8=False))
    path.write_text('{"version": 7}')
    with pytest.raises(cli._CliError, match="version"):
        cli._apply_tuned(Namespace(root=str(tmp_path), tuned=str(path),
                                   int8=False))


# ----------------------------------------------------------------------- CLI

def test_tune_then_predict_tuned_equals_the_explicit_flags(tmp_path):
    """``tune --device cpu`` writes the artifact; ``predict_model --tuned``
    serves exactly what the winner's four flags given explicitly serve,
    and what the JAX CLI's ``predict_model --tuned`` serves on the same
    artifact and weights (the JAX trainer's PRNGKey(0) initial weights)."""
    root, ckpt = _root(tmp_path)
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                         TrainConfig())
    model = build_model(UNetConfig(**KW))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})))
    save_weights(ckpt, model)
    assert cli.main(["tune", "--root", root, "--device", "cpu", "--granule",
                     "64", "--candidates", "32/8/4,32/0/4,48/16/2",
                     "--granules-per-program", "1,2", "--repeats", "1"]) == 0
    payload = tune.load_tuned(os.path.join(root, "models",
                                           tune.TUNED_BASENAME))
    assert len(payload["results"]) == 6
    assert (payload["int8"], payload["arch"]) == (False, "unet")
    best = payload["best"]

    base = ["predict_model", "--root", root, "--device", "cpu"]
    assert cli.main(base + ["--tuned"]) == 0
    tuned = _predictions(root)
    assert cli.main(base + [
        "--tile", str(best["tile"]), "--overlap", str(best["overlap"]),
        "--batch-tiles", str(best["batch_tiles"]),
        "--batch-granules", str(best["granules"])]) == 0
    explicit = _predictions(root)
    assert jax_main(["predict_model", "--root", root, "--tuned"]) == 0
    want = _predictions(root)
    assert sorted(tuned) == sorted(explicit) == sorted(want) == [
        "g0_pred.npz", "g1_pred.npz"]
    for f in tuned:
        for k in ("probs", "mask", "threshold"):
            np.testing.assert_array_equal(tuned[f][k], explicit[f][k])
        np.testing.assert_allclose(tuned[f]["probs"], want[f]["probs"],
                                   atol=PROB_TOL, rtol=0)


@pytest.mark.parametrize("flags", [
    ["--candidates", "32/64"], ["--candidates", "32"],
    ["--candidates", "a/b"], ["--granules-per-program", "0"]])
def test_tune_bad_candidates_exit_1(tmp_path, caplog, flags):
    with caplog.at_level(logging.ERROR):
        assert cli.main(["tune", "--root", str(tmp_path), "--device", "cpu",
                         "--granule", "64"] + flags) == 1
    assert "tune: " in caplog.text
    assert not os.path.exists(os.path.join(str(tmp_path), "models"))


def test_predict_tuned_without_an_artifact_exits_1(tmp_path, caplog):
    root, _ckpt = _root(tmp_path)
    with caplog.at_level(logging.ERROR):
        assert cli.main(["predict_model", "--root", root, "--device", "cpu",
                         "--tuned"] + SERVE) == 1
    assert "not found" in caplog.text


# ------------------------------------------- tile rules at the tuner's shapes

def _grid_batches(tile):
    """The forward batches of the default grid's candidates at ``tile`` on
    a 2048² granule: G granules times the effective batch of the tile
    grid, for every G of the default sweep."""
    batches = set()
    for geom in tune.parse_candidates(tune.DEFAULT_CANDIDATES, (1, 2, 4)):
        if geom.tile != tile:
            continue
        stride = tile - geom.overlap
        padded = tile + -(-(GRANULE - tile) // stride) * stride
        n = len(tile_grid(padded, tile, stride)) ** 2
        batches.add(geom.granules * _effective_batch(geom.batch_tiles, n))
    return sorted(batches)


@pytest.fixture(scope="module")
def flagship_stages():
    """K7's packed stages of ``UNetConfig()`` (seeded weights), packed on
    the CPU: what the card's plan is built from."""
    model = build_model(UNetConfig(), torch.Generator().manual_seed(0)).eval()
    folded = unet_mega.fold_weights(model, torch.bfloat16)
    return unet_mega._pack(folded, torch.device("cpu"))[1]


TUNER_TILES = (256, 288, 384, 512)


def test_the_default_grid_gives_these_batches():
    assert {t: _grid_batches(t) for t in TUNER_TILES} == {
        256: [64, 128, 256], 288: [64, 128, 256],
        384: [36, 72, 144], 512: [16, 32, 64]}


@pytest.mark.parametrize("tile", TUNER_TILES)
def test_double_conv_tile_at_the_tuners_tiles(tile):
    """K6's tile rule returns a tile at every block of ``UNetConfig()``
    (and K7's stage rule, which takes the same function, at the pooling
    and head variants)."""
    for cin, cmid, cout, h in block_shapes(UNetConfig(), tile):
        for even, head in ((False, False), (True, False), (False, True)):
            t = conv_tiles.double_conv_tile(h, h, cin, cmid, cout, even, head)
            assert t.th >= 1 and t.tw >= 1 and t.images >= 1
            assert t.path == ("wgmma" if cmid > 64 else "mma")
            assert 0 < t.fill <= 1


@pytest.mark.parametrize("tile", TUNER_TILES)
def test_int8_conv_tile_at_the_tuners_tiles(tile):
    """Q1's tile rule returns a tile at every conv of the int8 forward of
    ``UNetConfig()`` at every batch the grid gives, covering the plane."""
    for batch in _grid_batches(tile):
        for c_skip, cin, cout, side, _int8_out in conv_cases(UNetConfig(),
                                                             tile):
            c0, c1 = (c_skip, cin) if c_skip else (cin, 0)
            shape = int8_conv.conv_shape(c0, c1, cout)
            t = int8_conv.conv_tile(side, side, batch, shape)
            assert 1 <= t.th <= side and 1 <= t.tw <= side
            assert 1 <= t.images <= batch


@pytest.mark.parametrize("tile", TUNER_TILES)
def test_mega_plan_builds_at_the_tuners_tiles(flagship_stages, tile):
    """K7's stage table and scratch size at every batch the grid gives:
    one row per stage, every plane inside the scratch."""
    for batch in _grid_batches(tile):
        assert unet_mega.mega_eligible(UNetConfig(), tile, tile)
        plan, elems = unet_mega._plan(flagship_stages, batch, tile, tile,
                                      blocks=SMS)
        assert plan.shape == (len(flagship_stages), unet_mega._PLAN_FIELDS)
        assert elems > 0 and (plan[:, 28:31] >= 1).all()    # th, tw, images
        # the scratch is what the docstring of mega_eligible reckons: about
        # 7.5 bytes per input pixel and base feature, in bf16 elements
        assert 2 * elems < 10 * batch * tile * tile * 32
