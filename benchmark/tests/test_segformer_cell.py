"""The SegFormer cell's harness on the CPU: its seeded weights against the
program's state dict, its reference against the tests' oracle, the cell
found by name from the files as they are, the frozen yardstick against the
program's count and torch's FLOP counter, and tiny runs of its driver:
correct when the served path is sound, not correct when it is broken.

    python -m pytest -q -p no:cacheprovider benchmark/tests/test_segformer_cell.py
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import cell as cell_mod
from benchmark.harness import segformer_weights
from benchmark.yardstick import segformer_ops

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
CELL = "segformer-serve-8192"
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "segformer-b5-c1024.json").read_text())
#: small widths: every stage and kind of layer, sr 8/4/2/1
SMALL = dict(hidden_sizes=[16, 32, 48, 64], depths=[1, 1, 2, 1],
             num_attention_heads=[1, 2, 3, 4], decoder_hidden_size=32)


def _small():
    return {**CONFIG["segformer"], **SMALL}


def _program_cfg(seg: dict):
    from plumekit_torch.config.segformer import SegFormerConfig

    return SegFormerConfig(**seg, **{k: v for k, v in CONFIG["model"].items()
                                     if k != "arch"})


def test_seeded_weights_are_the_programs_state_dict():
    from plumekit_torch.models import build_model

    seg = _small()
    with torch.device("meta"):
        model = build_model(_program_cfg(seg))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _ in
           segformer_weights.param_specs(seg, CONFIG["model"])}
    assert list(got) == list(want)
    assert got == want
    w = segformer_weights.make_weights(seg, CONFIG["model"], CONFIG["init"],
                                       2**31 + 3, "cpu")
    model.to_empty(device="cpu")
    model.load_state_dict(w)             # strict: every name, every shape
    again = segformer_weights.make_weights(seg, CONFIG["model"],
                                           CONFIG["init"], 2**31 + 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_centred_logits_have_mean_zero_over_the_tiles():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "segformer_reference", ROOT / "benchmark" / "reference" /
        "segformer.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    seg = _small()
    w = segformer_weights.make_weights(seg, CONFIG["model"], CONFIG["init"],
                                       11, "cpu")
    tiles = segformer_weights.corner_tiles(torch.rand((96, 128, 2)), 64,
                                           "cpu")
    assert tiles.shape == (4, 64, 64, 2)
    before = ref.forward(w, seg, tiles)
    weight = w["decode_head.classifier.weight"].clone()
    segformer_weights.center_logits(w, seg, ref.forward, tiles, chunk=3)
    after = ref.forward(w, seg, tiles)
    assert abs(float(after.double().mean())) < 1e-4
    torch.testing.assert_close(after - after.mean(), before - before.mean(),
                               atol=1e-4, rtol=0)
    assert torch.equal(w["decode_head.classifier.weight"], weight)


def test_published_widths_have_the_published_parameter_count():
    specs = segformer_weights.param_specs(CONFIG["segformer"],
                                          CONFIG["model"])
    params = sum(torch.Size(shape).numel() for name, shape, kind in specs
                 if kind not in ("count",) and "running_" not in name)
    # 84.7 M published at 3 inputs and 19 labels; 2 inputs and 1 label here
    assert 84.5e6 < params < 84.7e6


def test_the_reference_is_the_tests_oracle():
    ref = ROOT / "benchmark" / "reference" / "segformer.py"
    oracle = ROOT / "tests" / "oracle_segformer.py"
    assert ref.read_bytes() == oracle.read_bytes()


def test_the_cell_loads_by_name_from_the_files_as_they_are():
    cell = cell_mod.load_cell(CELL, BENCH)
    assert cell.chips == 1 and cell.mix["driver"] == "serve_bf16"
    assert cell.model.arch == "segformer"
    assert set(cell.limits) == {"max_dp", "mean_dp"}
    assert [m["name"] for m in cell.end_to_end] == [
        "serve_mpix_s", "granule_p95_ms", "setup_s"]
    names = {m.name for m in cell.per_layer}
    assert names == {"stager_wait_ms.serve", "readback_ms.serve",
                     "stitch_ms.serve", "forward_ms.serve", "idle_pct.serve",
                     "attn_roofline.segformer", "dwconv_roofline.segformer",
                     "decoder_ms.segformer", "mfu.segformer"}
    for m in cell.per_layer:
        assert m.read({}) is None
    mix = cell.mix
    # 121 tiles a granule in 11 forwards of 11 tiles a granule, no fill
    n = -(-(mix["granule"]["size"] - mix["tile"])
          // (mix["tile"] - mix["overlap"])) + 1
    assert n * n == 121 and (n * n) % mix["batch_tiles"] == 0
    assert CONFIG["reduced"] == ["num_channels", "num_labels"]
    assert CONFIG["published"] == {"num_channels": 3, "num_labels": 19}
    assert (CONFIG["num_channels"], CONFIG["num_labels"]) == (
        CONFIG["model"]["in_channels"], CONFIG["model"]["out_channels"])


@pytest.mark.parametrize("tile", [1024, 512, 96])
def test_the_frozen_count_equals_the_programs(tile):
    from plumekit_torch.models.flops import segformer_flops

    seg = CONFIG["segformer"] if tile != 96 else _small()
    assert segformer_ops.flops_per_tile(seg, CONFIG["model"], tile) == \
        segformer_flops(_program_cfg(seg), tile)
    flops, _ = segformer_ops.attention_flops_and_bytes(seg, tile)
    assert flops == segformer_ops.flops_per_tile(
        seg, CONFIG["model"], tile)["attention"]


@pytest.mark.parametrize("tile", [64, 128])
def test_the_frozen_count_equals_torchs_flop_counter(tile):
    """The yardstick against ``torch.utils.flop_counter`` over a forward of
    the program at small widths (attention through the math backend,
    whose two batched products the counter counts)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.utils.flop_counter import FlopCounterMode

    from plumekit_torch.models import build_model

    seg = _small()
    cfg = _program_cfg(seg)
    with torch.device("meta"):
        model = build_model(cfg)
    model.to_empty(device="cpu")
    model.load_state_dict(segformer_weights.make_weights(
        seg, CONFIG["model"], CONFIG["init"], 5, "cpu"))
    model.eval()
    counter = FlopCounterMode(display=False)
    x = torch.rand((2, tile, tile, 2))
    with torch.no_grad(), sdpa_kernel(SDPBackend.MATH), counter:
        model(x)
    parts = segformer_ops.flops_per_tile(seg, CONFIG["model"], tile)
    assert counter.get_total_flops() == 2 * sum(parts.values())
    _, dw_bytes = segformer_ops.dwconv_flops_and_bytes(seg, tile)
    hidden = [c * r for c, r in zip(seg["hidden_sizes"], seg["mlp_ratios"])]
    sides = [s for s, _, _, _ in segformer_ops.stages(seg, tile)]
    assert sides == [tile // 4, tile // 8, tile // 16, tile // 32]
    assert dw_bytes == sum(d * 2 * (2 * s * s * h + 10 * h) for d, s, h in
                           zip(seg["depths"], sides, hidden))


def _tiny_root(tmp_path: Path) -> Path:
    """A checkout of the benchmark whose SegFormer cell runs small widths
    on 128² granules at tile 64."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    here = tmp_path / "benchmark"
    conf = dict(CONFIG, segformer=_small())
    (here / "configs" / "segformer-b5-c1024.json").write_text(
        json.dumps(conf))
    path = here / "traffic" / "serve-bf16-8192-g4-t1024.json"
    mix = json.loads(path.read_text())
    mix["granule"].update(size=128, pool=3, plumes=2, plume_length=[10, 40],
                          plume_width=[3, 8])
    mix.update(tile=64, overlap=16, batch_tiles=4, batch_granules=2)
    path.write_text(json.dumps(mix))
    return tmp_path


def _run(root: Path, trace: int = 0):
    args = bench_run.parse(["--workload", CELL, "--seed", str(2**31 + 17),
                            "--seconds", "2", "--trace", str(trace)])
    return bench_run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                              root / "BENCHMARK.json")


def test_a_tiny_run_is_correct_and_reports_its_metrics(tmp_path):
    result, checks = _run(_tiny_root(tmp_path))
    assert result["correct"], checks
    assert set(result["metrics"]) == {"serve_mpix_s", "granule_p95_ms",
                                      "setup_s"}
    assert result["attempted"] > 0 and checks["granules_checked"]["value"]
    traced, _ = _run(_tiny_root(tmp_path / "t"), trace=1)
    # the CPU has no profile and no device time: the program's counters
    # alone are read
    assert set(traced["metrics"]) == {"mfu.segformer"}


def test_a_broken_served_path_is_not_correct(tmp_path, monkeypatch):
    from plumekit_torch.infer import sliding

    real = sliding.make_multi_granule_infer

    def make(*a, **k):
        infer = real(*a, **k)

        def altered(variables, images):
            probs, masks = infer(variables, images)
            probs = probs.clone()
            probs[:, 5, 7] += 0.9
            return probs, masks
        return altered
    monkeypatch.setattr(sliding, "make_multi_granule_infer", make)
    result, checks = _run(_tiny_root(tmp_path))
    assert not result["correct"], checks


@pytest.mark.parametrize("variant", [
    {"low": True}, {"fault": "no_dwconv"}, {"fault": "scale64"}])
def test_the_reference_control_and_faults_served_are_not_correct(
        tmp_path, monkeypatch, variant):
    """The reference at fp8 (the control), or missing stage 1's first
    depthwise conv, or with stage 1's softmax scale at 1/64, served in the
    program's forward's place through the whole driver: its own check, at
    the cell's committed limits, reports the run not correct."""
    from plumekit_torch.infer import sliding

    root = _tiny_root(tmp_path)
    ref = cell_mod.load_module(root / CONFIG["reference"], "tiny_reference")
    drawn = {}
    real_weights = segformer_weights.make_weights

    def weights(*a, **k):
        drawn["w"] = real_weights(*a, **k)     # centred in place later
        return drawn["w"]

    real_make = sliding.make_multi_granule_infer

    def make(apply_fn, *a, **k):
        def control(model, tiles):
            return ref.forward(drawn["w"], _small(), tiles, **variant)
        return real_make(control, *a, **k)

    monkeypatch.setattr(segformer_weights, "make_weights", weights)
    monkeypatch.setattr(sliding, "make_multi_granule_infer", make)
    result, checks = _run(root)
    assert result["attempted"] > 0
    assert not result["correct"], checks


def _window_loop(source: str) -> str:
    """The window's loop of a driver's ``run``: from the backlog's making
    to the stream's close."""
    start = source.index("    backlog = Backlog(pool)")
    end = source.index("        it.close()\n", start)
    return source[start:end]


def test_the_window_loop_is_the_serving_drivers():
    """``serve_bf16.run`` keeps a copy of ``serve.run``'s window loop
    (backlog, reservoir sample, latencies, pixels, the profile's trigger)
    until ``serve.run`` takes the program and the check as arguments: the
    two stay equal, line for line."""
    import inspect

    from benchmark.drivers import serve, serve_bf16

    assert _window_loop(inspect.getsource(serve_bf16.run)) \
        == _window_loop(inspect.getsource(serve.run))
