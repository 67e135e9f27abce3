"""The port's SegFormer (``models/segformer.py``) against the plain fp32
reference ``tests/oracle_segformer.py`` on seeded random weights, at a
small size on the CPU: the forward's logits in fp32 and in bf16, whole
granules through the sliding program and the stream, ``predict_model`` on
a SegFormer checkpoint, ``model_config.json`` round trips, the refusals of
the flags it does not serve, its spans and counters, and its FLOP count.
The JAX package has no SegFormer, so nothing here imports it.

The tests marked ``cuda`` run the published widths on 1024² tiles on the
card (``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_segformer.py``) and skip elsewhere."""

import ast
import dataclasses
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from plumekit_torch import cli
from plumekit_torch.config import InferConfig, SegFormerConfig, UNetConfig
from plumekit_torch.infer import make_multi_granule_infer
from plumekit_torch.infer.streaming import (decode_granule_channels,
                                            stream_inference)
from plumekit_torch.io import granule as torch_granule
from plumekit_torch.models import build_model
from plumekit_torch.models.flops import segformer_flops
from plumekit_torch.train import checkpoint
from plumekit_torch.utils import timers

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import oracle_segformer as oracle  # noqa: E402

#: a small SegFormer: every stage, every kind of layer, sr 8/4/2/1
SMALL = dict(hidden_sizes=(16, 32, 48, 64), depths=(1, 1, 2, 1),
             num_attention_heads=(1, 2, 3, 4), decoder_hidden_size=32)
#: fp32 forwards agree to rounding: sums of a few hundred terms in another
#: order (PyTorch's fused attention and channels-last convs against the
#: reference's written-out softmax), on logits of order 1; the widest gap
#: over seeds 0-9 is 5e-6
FP32_TOL = 1e-4
#: bf16 keeps 8 significant bits: every product's operands round at 2^-9
#: relative, and over 5 blocks and the head the probabilities move by
#: 0.009-0.019 (seeds 0-9); the tolerance is twice the widest of those.
#: The reference's fp8 control reads 0.072-0.189 and its faults 0.18-0.54
#: there (seeds 0-9), so the tolerance fails each of them
BF16_PROB_TOL = 0.04
#: the card's limits on the probability gap of the bf16 forward at the
#: published widths against the fp32 reference, the limits of the cell
#: segformer-serve-8192 (8192² granules, 1024² tiles at stride 768, on an
#: H100): sound forwards over 22 seeds read at most 0.228 (widest) and
#: 0.0504 (mean; one seed, the next 0.0266), so a rare seed reads over the
#: mean's limit; the fp8 control read at least 0.806 and 0.105, the faults
#: at least 0.493 (widest)
CARD_MAX_DP = 0.3
CARD_MEAN_DP = 0.05
#: the card's weights: each kernel N(0, gain²/fan_in) (query and key at 2,
#: so attention is peaked; the classifier at 20), biases N(0, 0.1²),
#: LayerNorm and batch norm near identity with random statistics; then the
#: classifier's bias centres the reference's logits (:func:`_published`)
CARD_GAINS = {"qk": 2.0, "head": 20.0}
SERVE = ["--tile", "64", "--overlap", "16", "--batch-tiles", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small planes gain nothing from torch's thread pool, and under
    parallel test workers its waiting threads slow every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0, dtype="float32", **kw):
    """A small SegFormer in eval mode with every tensor drawn from
    ``seed``: weights at 1/√fan_in, biases, norms and the head's batch norm
    statistics away from their identity."""
    cfg = SegFormerConfig(**{**SMALL, **kw}, compute_dtype=dtype)
    model = build_model(cfg, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1000)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        bn = model.decode_head.batch_norm
        bn.running_mean.copy_(0.1 * torch.randn(bn.num_features,
                                                generator=g))
        bn.running_var.copy_(torch.exp(0.2 * torch.randn(bn.num_features,
                                                         generator=g)))
    return cfg, model


def _weights(model):
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def _tiles(seed, n=2, side=64):
    return torch.randn((n, side, side, 2),
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_forward_matches_the_oracle(seed):
    cfg, model = _model(seed)
    x = _tiles(seed)
    with torch.no_grad():
        got = model(x)
    want = oracle.forward(_weights(model), dataclasses.asdict(cfg), x)
    assert got.shape == (2, 64, 64, 1) and got.dtype == torch.float32
    assert float(want.std()) > 0.1
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=0)


def _within_bf16_rounding(got, want) -> bool:
    """Probabilities of the bf16 forward against the fp32 reference's: off
    by more than fp32 rounding (the path does run in bf16) and by less
    than bf16's."""
    gap = float((got - want).abs().max())
    return FP32_TOL < gap < BF16_PROB_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_matches_the_oracle_within_its_rounding(seed):
    cfg, model = _model(seed, dtype="bfloat16")
    x = _tiles(seed)
    with torch.no_grad():
        got = torch.sigmoid(model(x))
    want = torch.sigmoid(oracle.forward(_weights(model),
                                        dataclasses.asdict(cfg), x))
    assert _within_bf16_rounding(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", [
    {"low": True}, {"fault": "no_dwconv"}, {"fault": "scale64"}])
def test_the_bf16_check_fails_the_fp8_control_and_the_faults(seed, variant):
    """The reference at fp8, or missing a depthwise conv, or with stage 1's
    softmax scale at 1/64, read in the bf16 forward's place, fails the
    check that the bf16 forward passes."""
    cfg, model = _model(seed, dtype="bfloat16")
    x = _tiles(seed)
    w, c = _weights(model), dataclasses.asdict(cfg)
    with torch.no_grad():
        got = torch.sigmoid(oracle.forward(w, c, x, **variant))
    want = torch.sigmoid(oracle.forward(w, c, x))
    assert not _within_bf16_rounding(got, want)


def test_state_dict_names_are_hugging_faces():
    cfg, model = _model()
    names = set(model.state_dict())
    for name in (
            "segformer.encoder.patch_embeddings.0.proj.weight",
            "segformer.encoder.patch_embeddings.3.layer_norm.bias",
            "segformer.encoder.block.2.1.attention.self.query.weight",
            "segformer.encoder.block.0.0.attention.self.sr.weight",
            "segformer.encoder.block.0.0.attention.self.layer_norm.weight",
            "segformer.encoder.block.1.0.attention.output.dense.bias",
            "segformer.encoder.block.3.0.mlp.dwconv.dwconv.weight",
            "segformer.encoder.block.3.0.layer_norm_2.weight",
            "segformer.encoder.layer_norm.3.weight",
            "decode_head.linear_c.0.proj.weight",
            "decode_head.linear_fuse.weight",
            "decode_head.batch_norm.running_var",
            "decode_head.classifier.bias"):
        assert name in names, name
    # sr = 1 in the last stage: no reduction conv there
    assert not [n for n in names if n.startswith("segformer.encoder.block.3")
                and ".sr." in n]
    assert "decode_head.linear_fuse.bias" not in names
    assert model.state_dict()["decode_head.linear_fuse.weight"].shape == \
        (32, 128, 1, 1)


def test_granule_probabilities_through_the_stream_match_the_oracle():
    """Three 96² granules (a group of two and a tail of one) through
    ``make_multi_granule_infer`` and ``stream_inference``, against the
    reference's own sliding window with the same taper."""
    cfg, model = _model(3)
    rng = np.random.default_rng(3)
    granules = {f"g{i}": rng.random((96, 96, 2)).astype(np.float32)
                for i in range(3)}
    infer = make_multi_granule_infer(
        lambda m, x: m(x), InferConfig(tile_size=64, overlap=16,
                                       batch_tiles=4), channels=2)
    predecoded = {k: (k, v, v.shape[:2]) for k, v in granules.items()}
    with torch.inference_mode():
        got = dict(stream_inference(list(granules), infer, model, cfg.depth,
                                    torch.device("cpu"), batch_granules=2,
                                    predecoded=predecoded,
                                    decode_workers=1))
    w = _weights(model)
    for name, channels in granules.items():
        want = oracle.granule_probs(w, dataclasses.asdict(cfg),
                                    torch.from_numpy(channels), 64, 16)
        np.testing.assert_allclose(got[name], want.numpy(), atol=1e-5,
                                   rtol=0)


def test_model_config_round_trips_and_unknown_arch_is_refused(tmp_path,
                                                              caplog):
    cfg = SegFormerConfig(**SMALL)
    checkpoint.save_model_config(str(tmp_path / "s"), cfg)
    assert checkpoint.load_model_config(str(tmp_path / "s")) == cfg
    with open(tmp_path / "s" / "model_config.json") as f:
        d = json.load(f)
    assert d["arch"] == "segformer" and d["hidden_sizes"] == [16, 32, 48, 64]
    assert SegFormerConfig() == SegFormerConfig(**json.loads(json.dumps(
        dataclasses.asdict(SegFormerConfig()))))
    d["arch"] = "swin"
    os.makedirs(tmp_path / "x")
    with open(tmp_path / "x" / "model_config.json", "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="'swin'"):
        checkpoint.load_model_config(str(tmp_path / "x"))
    # a U-Net's record reads as before
    checkpoint.save_model_config(str(tmp_path / "u"),
                                 UNetConfig(arch="unetpp"))
    assert checkpoint.load_model_config(str(tmp_path / "u")) == \
        UNetConfig(arch="unetpp")


def _granule(seed, name, size=64):
    rng = np.random.default_rng(seed)
    aod = rng.random((size, size)).astype(np.float32)
    aod[rng.random((size, size)) < 0.05] = torch_granule.NULL_VALUE
    lat, lon = np.meshgrid(np.linspace(10, 11, size, dtype=np.float32),
                           np.linspace(20, 21, size, dtype=np.float32),
                           indexing="ij")
    return torch_granule.Granule({"2020001A": aod}, lat, lon, name=name)


def _segformer_root(tmp_path, seed=4):
    root = str(tmp_path / "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    paths = []
    for i in range(3):
        paths.append(os.path.join(maiac, f"g{i}.npz"))
        torch_granule.save_granule(paths[-1], _granule(i + seed, f"g{i}",
                                                       size=80))
    cfg, model = _model(seed)
    ckpt = os.path.join(root, "models", "checkpoints")
    checkpoint.save_model_config(ckpt, cfg)
    checkpoint.save_weights(ckpt, model)
    return root, paths, cfg, model


@pytest.mark.parametrize("command", [
    ["predict_model"], ["serve", "--once", "--settle", "0"]])
def test_predict_model_and_serve_a_segformer_checkpoint(tmp_path, caplog,
                                                         command):
    """Through ``_restore_model``, ``make_multi_granule_infer`` and
    ``stream_inference``: 80² granules, padded to the total stride (96²),
    in a group of two and a tail, against the reference's granule
    probabilities on the same decoded channels."""
    root, paths, cfg, model = _segformer_root(tmp_path)
    with caplog.at_level(logging.INFO):
        assert cli.main(command + ["--root", root, "--device", "cpu",
                                   "--batch-granules", "2"] + SERVE) == 0
    out = os.path.join(root, "processed", "predictions")
    w = _weights(model)
    for path in paths:
        name, channels, (h, w_) = decode_granule_channels(path, cfg.depth)
        assert channels.shape[:2] == (96, 96) and (h, w_) == (80, 80)
        want = oracle.granule_probs(w, dataclasses.asdict(cfg),
                                    torch.from_numpy(channels), 64, 16)
        with np.load(os.path.join(out, f"{name}_pred.npz")) as d:
            np.testing.assert_allclose(d["probs"], want[:80, :80].numpy(),
                                       atol=1e-5, rtol=0)
            np.testing.assert_array_equal(d["mask"], d["probs"] > 0.5)


@pytest.mark.parametrize("argv,item", [
    (["predict_model", "--int8"], "S.2"),
    (["predict_model", "--fused"], "S.5"),
    (["predict_model", "--prune-level", "1"], "S.8"),
    (["predict_model", "--exported", "nowhere"], "S.4"),
    (["serve", "--once", "--int8"], "S.2"),
    (["tune"], "S.3"),
    (["export_model"], "S.4")])
def test_unported_flags_exit_1_naming_their_roadmap_item(tmp_path, caplog,
                                                         argv, item):
    root, _, _, _ = _segformer_root(tmp_path)
    device = [] if argv[0] == "export_model" else ["--device", "cpu"]
    with caplog.at_level(logging.ERROR):
        assert cli.main(argv[:1] + ["--root", root] + device + argv[1:]) == 1
    assert f"ROADMAP {item}" in caplog.text
    assert not os.path.exists(os.path.join(root, "processed", "predictions")) \
        or not os.listdir(os.path.join(root, "processed", "predictions"))


def test_spans_and_counters_are_recorded_only_with_the_recorder_on():
    cfg, model = _model()
    x = _tiles(0, n=3)
    timers.drain()
    with torch.no_grad():
        model(x)
    assert timers.drain() == {"spans": [], "counters": {}}
    timers.enable()
    try:
        with torch.no_grad():
            model(x)
            model(x[:1])
    finally:
        timers.disable()
    got = timers.drain()
    assert got["counters"] == {"segformer.forwards": 2, "segformer.tiles": 4}
    spans = got["spans"]
    forwards = [s for s in spans if s["name"] == "segformer.forward"]
    assert [s["attrs"]["tiles"] for s in forwards] == [3, 1]
    for f in forwards:
        inner = [s for s in spans if s["parent"] == f["id"]]
        assert [s["name"] for s in inner] == ["segformer.stage"] * 4 \
            + ["segformer.decode"]
        assert [s["attrs"].get("stage") for s in inner[:4]] == [1, 2, 3, 4]
        assert all(f["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= f["t1_ns"]
                   for s in inner)


@pytest.mark.parametrize("tile", [64, 96])
def test_flop_count_equals_torchs_flop_counter(tile):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.utils.flop_counter import FlopCounterMode

    cfg, model = _model()
    counter = FlopCounterMode(display=False)
    # the counter has no rule for the CPU's fused attention; the math
    # backend computes it by two batched products, which it counts
    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH), counter:
        model(_tiles(0, n=1, side=tile))
    assert counter.get_total_flops() == sum(segformer_flops(cfg,
                                                            tile).values())


def test_the_oracle_imports_nothing_of_the_program_or_jax():
    with open(oracle.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _published(device, tiles=None, seed=2**31 + 7, cfg=SegFormerConfig()):
    """The published widths with every tensor drawn on ``device`` in one
    seeded draw by :data:`CARD_GAINS`, the logits centred over ``tiles``:
    random weights offset every logit of a seed alike, by up to ±20, and
    probabilities that all sit at 0 or 1 would hold the forward to
    nothing."""
    with torch.device("meta"):
        model = build_model(cfg)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    draw = torch.randn(sum(s.numel() for s in shapes.values()),
                       device=device, generator=torch.Generator(device)
                       .manual_seed(seed))
    w, at = {}, 0
    for name, shape in shapes.items():
        z = draw[at:at + shape.numel()].reshape(shape)
        at += shape.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            w[name] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf == "running_var":
            w[name] = torch.exp(0.2 * z)
        elif "norm" in name and leaf == "weight":
            w[name] = 1.0 + 0.1 * z
        elif leaf == "weight":
            kind = ("qk" if ".query." in name or ".key." in name
                    else "head" if "classifier" in name else None)
            w[name] = z * CARD_GAINS.get(kind, 1.0) / shape[1:].numel() ** 0.5
        else:       # biases, norms' shifts, the running mean
            w[name] = 0.1 * z
    if tiles is not None:
        with torch.no_grad():
            logits = torch.cat([oracle.forward(w, cfg, tiles[i:i + 2])
                                for i in range(0, len(tiles), 2)])
        w["decode_head.classifier.bias"] -= logits.double().mean(
            dim=(0, 1, 2)).float()
    model.to_empty(device=device)
    model.load_state_dict(w)
    return cfg, w, model.eval()


def _gaps(got, want):
    gap = (got - want).abs()
    return float(gap.max()), float(gap.double().mean())


def _card_tiles(device):
    """The four 1024² tiles of a 2048² granule of the benchmark's 8192²
    plume scene (its plumes, AOD and nulls)."""
    from benchmark.harness.granules import make_granule

    scene = {"size": 2048, "pool": 1, "plumes": 8, "plume_length": [64, 1024],
             "plume_width": [8, 96], "plume_aod": [0.5, 3.0],
             "background_aod": [0.05, 0.4], "null_share": 0.08,
             "fires_per_plume": 2}
    granule, _ = make_granule(scene, torch.Generator(device).manual_seed(5),
                              device)
    return torch.stack([granule[y:y + 1024, x:x + 1024]
                        for y in (0, 1024) for x in (0, 1024)])


@pytest.mark.cuda
def test_published_widths_on_the_card_match_the_oracle_within_the_limits():
    """Four 1024² tiles through the bf16 forward, with the math backend of
    attention excluded, against the fp32 reference: the widest and the
    mean probability gap within the card's limits; the reference's fp8
    control and its two faults, read in the forward's place, each fail
    one."""
    device = _card()
    x = _card_tiles(device)
    cfg, w, model = _published(device, x)
    with torch.inference_mode():
        got = torch.sigmoid(model(x)[..., 0])
        want = torch.sigmoid(oracle.forward(w, cfg, x)[..., 0])
        worst, mean = _gaps(got, want)
        assert worst <= CARD_MAX_DP and mean <= CARD_MEAN_DP, (worst, mean)
        for variant in ({"low": True}, {"fault": "no_dwconv"},
                        {"fault": "scale64"}):
            bad = torch.sigmoid(oracle.forward(w, cfg, x, **variant)[..., 0])
            worst, mean = _gaps(bad, want)
            assert worst > CARD_MAX_DP or mean > CARD_MEAN_DP, \
                (variant, worst, mean)


@pytest.mark.cuda
def test_attention_on_the_card_takes_no_math_backend():
    """The forward's attention raises rather than materialise the scores
    where only the math backend could take it (fp64), and a bf16 forward
    at 1024² runs no kernel of the math path (no explicit softmax)."""
    device = _card()
    from torch.profiler import ProfilerActivity, profile

    from plumekit_torch.models.segformer import attention_backends

    q = torch.randn((1, 1, 64, 64), device=device, dtype=torch.float64)
    with attention_backends(device), pytest.raises(RuntimeError):
        torch.nn.functional.scaled_dot_product_attention(q, q, q)
    _, _, model = _published(device)
    x = torch.rand((2, 1024, 1024, 2), device=device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "_scaled_dot_product_attention_math"
                in n or n == "aten::_softmax"], names
    assert [n for n in names if "flash" in n.lower()
            or "efficient_attention" in n.lower() or "fmha" in n.lower()]
