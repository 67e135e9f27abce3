"""Exported serving artifacts of plumekit_torch (``infer/export.py``, the
port of ``plumekit/infer/export.py``) at the sizes of
``tests/test_export.py::_tiny`` (base 8, depth 2, 96² granules, tile 64,
overlap 8): export, save, load and run equal bit for bit to the live CPU
program for every forward at G = 1 and G = 3; the exported plain and int8
programs against the JAX package's exported programs on the same weights;
one artifact serving two checkpoints; the guards; and
``stream_inference(infer_is_batched=True)``. On the CPU every kernel op runs
its plain version."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import export as jax_export
from plumekit.models import UNet as JaxUNet
from plumekit.models.quantized_forward import quantize_unet as jax_quantize
from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.convert import from_flax, qvars_from_flax
from plumekit_torch.infer import export
from plumekit_torch.infer.sliding import (make_multi_granule_infer,
                                          make_sliding_infer)
from plumekit_torch.infer.streaming import stream_inference
from plumekit_torch.infer.tta import make_tta_apply
from plumekit_torch.io import granule as torch_granule
from plumekit_torch.models import build_model
from plumekit_torch.models.quantized_forward import (make_quantized_apply,
                                                     quantize_unet)

KW = dict(in_channels=2, base_features=8, depth=2)
ICFG = InferConfig(tile_size=64, overlap=8, batch_tiles=2)
HW = (96, 96)
#: the forwards an artifact can hold: (config, export forward, tta)
FORWARDS = {
    "plain": (UNetConfig(**KW, compute_dtype="float32"), "flax", False),
    "use_pallas": (UNetConfig(**KW, use_pallas=True), "flax", False),
    "use_mega": (UNetConfig(**KW, use_mega=True), "flax", False),
    "int8": (UNetConfig(**KW, compute_dtype="float32"), "int8", False),
    "tta": (UNetConfig(**KW, compute_dtype="float32"), "flax", True),
    "unetpp_pruned": (UNetConfig(**KW, arch="unetpp", deep_supervision=True,
                                 prune_level=1, compute_dtype="float32"),
                      "flax", False),
}
ROUTES = {"plain": "module", "use_pallas": "fused", "use_mega": "mega",
          "int8": "int8", "tta": "module", "unetpp_pruned": "module"}
#: the port's exported fp32 program against the JAX package's on the same
#: weights: both fp32, convolutions and sums in another order; found
#: max|Δp| about 1e-7 on these granules
FP32_PROB_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(granules, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((granules,) + HW + (2,),
                                       dtype=np.float32))


def _model(cfg, seed=0):
    return build_model(cfg, torch.Generator().manual_seed(seed)).eval()


def _export(tmp_path, name, model, cfg, granules, forward="flax", tta=False,
            icfg=ICFG):
    programs, meta = export.export_sliding_infer(
        model, cfg, icfg, HW, granules=granules, platforms=["cpu"],
        forward=forward, tta=tta)
    art = str(tmp_path / name)
    export.save_exported(programs, meta, art)
    return art, programs["cpu"]


def _variables(model, cfg, forward):
    """What the live program reads: the model, or its int8 variables
    calibrated on a fixed batch."""
    if forward != "int8":
        return model
    calib = np.random.default_rng(7).random((2, 64, 64, 2), np.float32)
    return quantize_unet(model, cfg, calib)


def _live(cfg, forward, tta, granules):
    apply = (make_quantized_apply(cfg) if forward == "int8"
             else lambda m, x: m(x))
    if tta:
        apply = make_tta_apply(apply)
    make = make_multi_granule_infer if granules > 1 else make_sliding_infer
    return make(apply, ICFG, channels=2)


def _op_nodes(program):
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("plumekit."))


@pytest.mark.parametrize("granules", [1, 3])
@pytest.mark.parametrize("name", list(FORWARDS))
def test_exported_program_equals_the_live_program(tmp_path, name, granules):
    cfg, forward, tta = FORWARDS[name]
    model = _model(cfg)
    art, program = _export(tmp_path, "art", model, cfg, granules, forward,
                           tta)
    assert export.is_artifact(art)
    assert sorted(os.listdir(art)) == ["meta.json", "program.cpu.pt2"]
    fn, meta = export.load_exported(art, "cpu")
    assert meta["route"] == ROUTES[name] and meta["granules"] == granules
    assert meta["format_version"] == (2 if forward == "int8" else 1)
    assert meta["tta"] is tta and meta["platforms"] == ["cpu"]
    assert "torch_version" in meta and "jax_version" not in meta
    variables = _variables(model, cfg, forward)
    tree = export.serving_tree(meta["route"], cfg, variables, "cpu")[0]
    images = _images(granules)
    x = images if granules > 1 else images[0]
    live = _live(cfg, forward, tta, granules)
    with torch.inference_mode():
        p_live, m_live = live(variables, x)
        p_exp, m_exp = fn(tree, x)
    assert p_exp.shape == x.shape[:-1]
    assert torch.equal(p_exp, p_live) and torch.equal(m_exp, m_live)
    # each forward's kernels are ops of the graph: K6 per block, K7 per
    # forward, Q1 per conv and Q2 per upsample; a granule is 4 tiles, so
    # the program runs 2 forwards of 2 tiles a granule
    forwards = 2
    per_forward = {"fused": ["plumekit.fused_double_conv3x3.default"] * 5,
                   "mega": ["plumekit.unet_mega.default"],
                   "int8": ["plumekit.int8_conv3x3.default"] * 10
                   + ["plumekit.int8_upsample2x2.default"] * 2,
                   "module": []}[meta["route"]]
    assert _op_nodes(program) == sorted(per_forward * forwards)


def test_one_artifact_serves_two_checkpoints(tmp_path):
    """The weights are an input of the program, never its constants."""
    for name in ("plain", "use_pallas", "use_mega", "int8"):
        cfg, forward, _tta = FORWARDS[name]
        art, program = _export(tmp_path, name, _model(cfg, 0), cfg, 3,
                               forward)
        assert not program.state_dict and program.example_inputs is None
        assert all(t.numel() <= 96 * 96 for t in program.constants.values())
        # graph and the taper's constants: no weights, no example inputs
        assert os.path.getsize(os.path.join(art, "program.cpu.pt2")) \
            < 600_000
        fn, meta = export.load_exported(art, "cpu")
        images = _images(3, seed=1)
        outs = []
        for seed in (1, 2):
            model = _model(cfg, seed)
            variables = _variables(model, cfg, forward)
            tree = export.serving_tree(meta["route"], cfg, variables,
                                       "cpu")[0]
            with torch.inference_mode():
                got = fn(tree, images)[0]
                want = _live(cfg, forward, False, 3)(variables, images)[0]
            assert torch.equal(got, want), name
            outs.append(got)
        assert not torch.equal(outs[0], outs[1])


def _jax_tiny():
    cfg = JaxUNetConfig(**KW, compute_dtype="float32")
    variables = JaxUNet(cfg).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 2)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    model = build_model(UNetConfig(**KW, compute_dtype="float32"))
    model.load_state_dict(from_flax(variables))
    return cfg, variables, model.eval()


def test_exported_plain_program_matches_the_jax_packages(tmp_path):
    jcfg, variables, model = _jax_tiny()
    jicfg = JaxInferConfig(tile_size=64, overlap=8, batch_tiles=2)
    exported, jmeta = jax_export.export_sliding_infer(
        variables, jcfg, jicfg, HW, granules=3, platforms=["cpu"])
    jart = str(tmp_path / "jax")
    jax_export.save_exported(exported, jmeta, jart)
    jfn, _ = jax_export.load_exported(jart)
    cfg = UNetConfig(**KW, compute_dtype="float32")
    art, _program = _export(tmp_path, "port", model, cfg, 3)
    fn, meta = export.load_exported(art, "cpu")
    images = _images(3, seed=4)
    want = np.asarray(jfn(variables, jnp.asarray(images.numpy()))[0])
    tree = export.serving_tree(meta["route"], cfg, model, "cpu")[0]
    with torch.inference_mode():
        got = fn(tree, images)[0].numpy()
    np.testing.assert_allclose(got, want, atol=FP32_PROB_ATOL, rtol=0)
    # the keys of the JAX package's meta, torch's version for JAX's
    assert set(meta) == set(jmeta) - {"jax_version"} | {"torch_version",
                                                         "route"}


def test_exported_int8_program_matches_the_jax_packages(tmp_path):
    """Both int8 programs on the same quantized state (the JAX package's,
    carried over): the tolerance of ``tests/test_torch_int8_cli.py``."""
    from test_torch_int8_cli import PROB_ATOL

    jcfg, variables, model = _jax_tiny()
    calib = np.random.default_rng(7).random((2, 64, 64, 2), np.float32)
    jq = jax_quantize(variables, jcfg, calib)
    jicfg = JaxInferConfig(tile_size=64, overlap=8, batch_tiles=2)
    exported, jmeta = jax_export.export_sliding_infer(
        variables, jcfg, jicfg, HW, granules=3, platforms=["cpu"],
        forward="int8")
    jart = str(tmp_path / "jax")
    jax_export.save_exported(exported, jmeta, jart)
    jfn, _ = jax_export.load_exported(jart)
    cfg = UNetConfig(**KW, compute_dtype="float32")
    art, _program = _export(tmp_path, "port", model, cfg, 3, "int8")
    fn, meta = export.load_exported(art, "cpu")
    assert meta["format_version"] == jmeta["format_version"] == 2
    images = _images(3, seed=5)
    want = np.asarray(jfn(jax.tree.map(jnp.asarray, jq),
                          jnp.asarray(images.numpy()))[0])
    tree = export.serving_tree("int8", cfg, qvars_from_flax(jq), "cpu")[0]
    with torch.inference_mode():
        got = fn(tree, images)[0].numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


def test_guards(tmp_path):
    cfg, _forward, _tta = FORWARDS["plain"]
    model = _model(cfg)
    with pytest.raises(ValueError, match="divisible"):
        export.export_sliding_infer(model, cfg, ICFG, (70, 96),
                                    platforms=["cpu"])
    with pytest.raises(ValueError, match="unknown platform"):
        export.export_sliding_infer(model, cfg, ICFG, HW, platforms=["tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA is not available"):
            export.export_sliding_infer(model, cfg, ICFG, HW)
    art, _program = _export(tmp_path, "art", model, cfg, 1)
    fn, _meta = export.load_exported(art, "cpu")
    tree = export.serving_tree("module", cfg, model, "cpu")[0]
    with pytest.raises(ValueError, match="expects image shape"):
        fn(tree, torch.zeros((64, 64, 2)))
    # a platform the artifact was not exported for fails at load, with the
    # remedy in the message
    mpath = os.path.join(art, "meta.json")
    with open(mpath) as f:
        meta = json.load(f)
    with open(mpath, "w") as f:
        json.dump(dict(meta, platforms=["gpu"]), f)
    with pytest.raises(ValueError, match="re-export"):
        export.load_exported(art, "cpu")
    # a newer format refuses loudly
    with open(mpath, "w") as f:
        json.dump(dict(meta, format_version=3), f)
    with pytest.raises(ValueError, match="format_version"):
        export.load_exported(art, "cpu")


def test_artifacts_of_the_two_packages_are_told_apart(tmp_path):
    jcfg, variables, model = _jax_tiny()
    jicfg = JaxInferConfig(tile_size=64, overlap=8, batch_tiles=2)
    exported, jmeta = jax_export.export_sliding_infer(
        variables, jcfg, jicfg, HW, platforms=["cpu"])
    jart = str(tmp_path / "jax")
    jax_export.save_exported(exported, jmeta, jart)
    assert not export.is_artifact(jart)
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        export.load_exported(jart, "cpu")
    art, _program = _export(tmp_path, "port", model,
                            UNetConfig(**KW, compute_dtype="float32"), 1)
    assert not jax_export.is_artifact(art)
    # the JAX reader stops at its first step, on its program's name
    with pytest.raises(FileNotFoundError, match="program.stablehlo"):
        jax_export.load_exported(art)


def _granules_on_disk(tmp_path, n):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        aod = rng.random(HW).astype(np.float32)
        g = torch_granule.Granule({"t0": aod}, np.zeros(HW, np.float32),
                                  np.zeros(HW, np.float32), name=f"g{i}")
        paths.append(str(tmp_path / f"g{i}.npz"))
        torch_granule.save_granule(paths[-1], g)
    return paths


@pytest.mark.parametrize("quantize", [False, True])
def test_stream_inference_with_exported_batched(tmp_path, quantize):
    """An exported G = 2 program through ``stream_inference(
    infer_is_batched=True)``: the ragged third granule is padded by
    repetition, and every output equals the live unbatched stream's."""
    cfg, _forward, _tta = FORWARDS["plain"]
    model = _model(cfg)
    paths = _granules_on_disk(tmp_path, 3)
    live = _live(cfg, "flax", False, 3)
    with torch.inference_mode():
        want = dict(stream_inference(paths, live, model, cfg.depth, "cpu",
                                     decode_workers=1, quantize=quantize))
    art, _program = _export(tmp_path, "art", model, cfg, 2)
    fn, meta = export.load_exported(art, "cpu")
    tree = export.serving_tree(meta["route"], cfg, model, "cpu")[0]
    seen = []

    def counted(variables, images):
        seen.append(images.shape[0])
        return fn(variables, images)

    with torch.inference_mode():
        got = dict(stream_inference(paths, counted, tree, cfg.depth, "cpu",
                                    decode_workers=1, quantize=quantize,
                                    batch_granules=2, infer_is_batched=True))
    assert list(got) == ["g0", "g1", "g2"] and seen == [2, 2]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


def test_stream_inference_batched_guard():
    with pytest.raises(ValueError, match="infer_is_batched"):
        list(stream_inference([], lambda v, x: (x, x), {}, 2, "cpu",
                              batch_granules=1, infer_is_batched=True))
