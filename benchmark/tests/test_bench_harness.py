"""The benchmark's harness on the CPU: cells found by name from files, the
frozen yardstick against the program's arithmetic, the check that no JAX
module is loaded, a run without a card, tiny runs through the serving and
training drivers, and the checks that fail when the served path or the
train step is broken, or runs at the control's lower precision.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import cell as cell_mod
from benchmark.harness.result import banned_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
SPEC = json.loads(BENCH.read_text())

#: a tiny serving mix: full-width models on 96² granules, tile 32
TINY = {"size": 96, "pool": 3, "plumes": 2, "plume_length": [10, 40],
        "plume_width": [3, 8]}


def _copy(tmp_path: Path) -> Path:
    """A checkout of the benchmark alone (folder and BENCHMARK.json)."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    return tmp_path


def _like(spec: dict, cell: str, model: str) -> None:
    """List the new ``cell`` wherever the metrics list the cell ``model``."""
    for m in spec["end_to_end"] + spec["per_layer"]:
        if model in m.get("workloads", []):
            m["workloads"].append(cell)


def _add_tiny_cells(root: Path, sample: int = 3) -> list:
    """New mix, limits and cells in the copy ``root``: files and entries
    only. Returns the new cells' names."""
    here = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((here / "traffic" / "serve-int8-1200-g4.json")
                     .read_text())
    mix["granule"].update(TINY)
    mix.update(tile=32, overlap=8, batch_tiles=8, batch_granules=2,
               check_sample=sample)
    (here / "traffic" / "tiny-serve.json").write_text(json.dumps(mix))
    names = []
    for conf in spec["configs"]:
        name = f"tiny-{conf['name']}"
        spec["workloads"].append({"name": name, "config": conf["name"],
                                  "traffic": "tiny-serve", "chips": 1,
                                  "why": "a CPU rehearsal"})
        limits = json.loads((here / "limits" / "unetpp-serve-1200.json")
                            .read_text())
        (here / "limits" / f"{name}.json").write_text(json.dumps(limits))
        _like(spec, name, "unetpp-serve-1200")
        names.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return names


def _add_tiny_train_cell(root: Path) -> str:
    """A tiny training mix, limits and cell in the copy ``root``."""
    here = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((here / "traffic" / "train-bf16-16x512.json")
                     .read_text())
    mix["granule"].update(TINY, pool=2)
    mix.update(tile=32, batch_size=4)
    (here / "traffic" / "tiny-train.json").write_text(json.dumps(mix))
    shutil.copy(here / "limits" / "unet-train-512.json",
                here / "limits" / "tiny-train.json")
    spec["workloads"].append({"name": "tiny-train", "config": "unet-b32-d4",
                              "traffic": "tiny-train", "chips": 1,
                              "why": "a CPU rehearsal"})
    _like(spec, "tiny-train", "unet-train-512")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return "tiny-train"


def _run(root: Path, cell: str, seconds: float = 2.0, seed: int = 2**31 + 5):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace", "0"])
    return bench_run.run_cell(args, torch.device("cpu"), time.perf_counter(),
                              root / "BENCHMARK.json")


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    root = _copy(tmp_path)
    here = root / "benchmark"
    conf = json.loads((here / "configs" / "unet-b32-d4.json").read_text())
    conf["model"]["base_features"] = 16
    conf["name"] = "unet-b16-d4"
    (here / "configs" / "unet-b16-d4.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "serve-int8-1200-g4.json")
                     .read_text())
    mix["batch_granules"] = 8
    (here / "traffic" / "serve-int8-1200-g8.json").write_text(json.dumps(mix))
    (here / "limits" / "unet16-serve-1200-g8.json").write_text(
        json.dumps({"max_dp": 1e-3, "mean_dp": 1e-5}))
    (here / "metrics" / "groups.serve.py").write_text(
        "LAYER = 'stream'\nUNIT = 'count'\nMOVES = 'serve_mpix_s'\n\n\n"
        "def read(rec):\n    return rec.get('groups')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "unet-b16-d4", "source": "x",
                            "file": "benchmark/configs/unet-b16-d4.json",
                            "reduced": ["base_features"], "why": "x"})
    spec["workloads"].append({"name": "unet16-serve-1200-g8",
                              "config": "unet-b16-d4",
                              "traffic": "serve-int8-1200-g8", "chips": 1,
                              "why": "x"})
    _like(spec, "unet16-serve-1200-g8", "unetpp-serve-1200")
    spec["per_layer"].append({"name": "groups.serve", "unit": "count",
                              "better": "higher", "source": "program_span",
                              "layer": "stream", "moves": "serve_mpix_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cell_mod.load_cell("unet16-serve-1200-g8", root / "BENCHMARK.json")
    assert cell.model.base_features == 16
    assert cell.mix["batch_granules"] == 8
    assert cell.limits == {"max_dp": 1e-3, "mean_dp": 1e-5}
    names = [m.name for m in cell.per_layer]
    assert "groups.serve" in names
    reader = {m.name: m.read for m in cell.per_layer}["groups.serve"]
    assert reader({"groups": 7}) == 7
    # a metric without workloads reaches every cell that reports its moves
    other = cell_mod.load_cell("unet-serve-8192", root / "BENCHMARK.json")
    assert "groups.serve" in [m.name for m in other.per_layer]


def test_every_cell_loads_with_its_metrics():
    for w in SPEC["workloads"]:
        cell = cell_mod.load_cell(w["name"])
        names = {m.name for m in cell.per_layer}
        listed = {m["name"] for m in SPEC["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])}
        assert names == listed
        for m in cell.per_layer:
            module = cell_mod.load_module(
                cell.folder / "metrics" / f"{m.name}.py", "probe")
            assert module.LAYER == m.entry["layer"]
            assert module.UNIT == m.entry["unit"]
            assert module.MOVES == m.entry["moves"]
            assert m.read({}) is None       # nothing to read: no number


def _cell_shapes():
    for w in SPEC["workloads"]:
        cell = cell_mod.load_cell(w["name"])
        yield cell, cell.mix["tile"], cell.mix["granule"]["size"]


def test_frozen_arithmetic_equals_the_programs_at_every_cell():
    from benchmark.yardstick import flops as yf
    from benchmark.yardstick import int8_ops as yi
    from plumekit_torch.config.train import UNetConfig
    from plumekit_torch.experiments import int8_conv_times as pi
    from plumekit_torch.models import flops as pf

    for cell, tile, size in _cell_shapes():
        ucfg = UNetConfig(**vars(cell.model))
        assert yf.model_flops_per_pixel(cell.model) \
            == pf.model_flops_per_pixel(ucfg)
        assert yf.PEAK_TFLOPS == pf.PEAK_TFLOPS
        if cell.mix["driver"] != "serve":
            continue
        overlap = cell.mix["overlap"]
        assert yf.sliding_redundancy(size, tile, overlap) \
            == pf.sliding_redundancy(size, tile, overlap)
        assert yi.conv_cases(cell.model, tile) == pi.conv_cases(ucfg, tile)
        assert yi.upsample_cases(cell.model, tile) \
            == pi.upsample_cases(ucfg, tile)
        for batch in (100, 256):
            for case in yi.conv_cases(cell.model, tile):
                assert yi.ops_and_bytes(case, batch) \
                    == pi.ops_and_bytes(case, batch)
                assert yi.bound(*yi.ops_and_bytes(case, batch)) \
                    == pi.bound(*pi.ops_and_bytes(case, batch))
            for case in yi.upsample_cases(cell.model, tile):
                assert yi.upsample_ops_and_bytes(case, batch) \
                    == pi.upsample_ops_and_bytes(case, batch)
                assert yi.bound(*yi.upsample_ops_and_bytes(case, batch)) \
                    == pi.bound(*pi.upsample_ops_and_bytes(case, batch))


@pytest.mark.parametrize("name,banned", [
    ("plumekit", True), ("plumekit.models.unet", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("plumekit_torch", False), ("plumekit_torch.models", False),
    ("jaxtyping", False), ("numpy", False)])
def test_no_jax_check_compares_whole_top_level_names(name, banned):
    assert banned_modules([name]) == ([name] if banned else [])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_the_folder_imports_no_jax_and_the_references_none_of_the_program():
    for path in (ROOT / "benchmark").rglob("*.py"):
        names = list(_imports(path))
        assert not banned_modules(names), path
        if path.parent.name in ("reference", "yardstick"):
            assert not [n for n in names
                        if n.split(".")[0] == "plumekit_torch"], path


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "unetpp-serve-1200",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_a_tiny_run_is_correct_and_reports_its_metrics(tmp_path):
    root = _copy(tmp_path)
    for name in _add_tiny_cells(root):
        result, checks = _run(root, name)
        assert result["correct"], checks
        assert set(result["metrics"]) == {"serve_mpix_s", "granule_p95_ms",
                                          "setup_s"}
        assert result["attempted"] > 0
        assert checks["max_dp"]["value"] < 1e-5


def _broken_answer(monkeypatch):
    """The sliding program's probabilities altered where they are made."""
    from plumekit_torch.infer import sliding

    real = sliding.make_multi_granule_infer

    def make(*a, **k):
        infer = real(*a, **k)

        def altered(variables, images):
            probs, masks = infer(variables, images)
            probs = probs.clone()
            probs[:, 5, 7] += 0.01
            return probs, masks
        return altered
    monkeypatch.setattr(sliding, "make_multi_granule_infer", make)


def _half_batch(monkeypatch):
    """The forward computes half of its tiles; the rest read logit 0."""
    from plumekit_torch.models import quantized_forward

    real = quantized_forward.make_quantized_apply

    def make(cfg):
        apply = real(cfg)

        def half(qvars, x, **k):
            out = torch.zeros(x.shape[:3] + (1,), dtype=torch.float32)
            n = x.shape[0] // 2
            out[:n] = apply(qvars, x[:n], **k)
            return out
        return half
    monkeypatch.setattr(quantized_forward, "make_quantized_apply", make)


@pytest.mark.parametrize("fault", [_broken_answer, _half_batch])
def test_a_broken_served_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = _copy(tmp_path)
    name = _add_tiny_cells(root)[0]
    fault(monkeypatch)
    result, checks = _run(root, name)
    assert not result["correct"], checks


def test_the_int4_control_fails_every_cells_limits(tmp_path):
    from benchmark.control import control_readings

    root = _copy(tmp_path)
    for name in _add_tiny_cells(root):
        cell = cell_mod.load_cell(name, root / "BENCHMARK.json")
        got = control_readings(cell, 2**31 + 3, torch.device("cpu"))
        for w in SPEC["workloads"]:
            limits = cell_mod.load_cell(w["name"]).limits
            if "max_dp" in limits:
                assert got["max_dp"] > limits["max_dp"], (name, w["name"],
                                                          got)


def test_a_tiny_training_run_is_correct(tmp_path):
    root = _copy(tmp_path)
    result, checks = _run(root, _add_tiny_train_cell(root))
    assert result["correct"], checks
    assert set(result["metrics"]) == {"train_mpix_s", "setup_s"}
    assert checks["loss_gap"]["value"] < 1e-5


def _step_unchanged(monkeypatch):
    """Each step computes its loss and hands back the state it was given."""
    from plumekit_torch.train import step as step_mod

    real = step_mod.make_multi_train_step

    def make(*a, **k):
        multi = real(*a, **k)

        def unchanged(state, chunk, steps):
            saved = {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}
            state, metrics = multi(state, chunk, steps)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(saved[n])
            return state, metrics
        return unchanged
    monkeypatch.setattr(step_mod, "make_multi_train_step", make)


def _half_train_batch(monkeypatch):
    """Each step sees the first half of its batch; the loss is the mean
    over it."""
    from plumekit_torch.train import step as step_mod

    real = step_mod.make_multi_train_step

    def make(*a, **k):
        multi = real(*a, **k)

        def half(state, chunk, steps):
            n = chunk[0].shape[1] // 2
            return multi(state, tuple(t[:, :n] for t in chunk), steps)
        return half
    monkeypatch.setattr(step_mod, "make_multi_train_step", make)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_train_batch])
def test_a_broken_train_step_is_not_correct(tmp_path, monkeypatch, fault):
    root = _copy(tmp_path)
    name = _add_tiny_train_cell(root)
    fault(monkeypatch)
    result, checks = _run(root, name)
    assert not result["correct"], checks


def test_the_fp8_control_fails_the_training_limits(tmp_path):
    from benchmark.control import train_control_readings

    root = _copy(tmp_path)
    cell = cell_mod.load_cell(_add_tiny_train_cell(root),
                              root / "BENCHMARK.json")
    got = train_control_readings(cell, 2**31 + 3, torch.device("cpu"))
    limits = cell_mod.load_cell("unet-train-512").limits
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "unetpp-serve-1200",
         "--seed", str(2**31 + 13), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
