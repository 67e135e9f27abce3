"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and per-layer metrics are files of this
folder found by name (``README.md``). The run needs as many CUDA devices as
the cell asks for and exits 3 without a result when they are not there. It
measures the PyTorch and CUDA program only, and exits 4 without a result
if JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)           # the checkout, not this folder
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device, t_start: float,
             bench: Path = ROOT / "BENCHMARK.json") -> tuple:
    """Run the cell of ``bench`` on ``device``; returns (result, checks)."""
    import torch

    from benchmark.harness.cell import load_cell, load_module

    cell = load_cell(args.workload, bench)
    kind = cell.mix["driver"]
    driver = load_module(cell.folder / "drivers" / f"{kind}.py",
                         f"benchmark_driver_{kind}")
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     t_start)
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = m.read(rec)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.entry["unit"]}
    else:
        for m in cell.end_to_end:
            value = rec["setup_s"] if m["name"] == "setup_s" \
                else driver.END_TO_END[m["name"]](rec)
            if value is None:
                raise RuntimeError(f"no reading of {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    correct = all((c["value"] <= c["limit"]) if c["rule"] == "<="
                  else (c["value"] >= c["limit"]) for c in checks.values())
    dev = torch.device(device)
    result = {"correct": correct, "attempted": rec["served"], "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": rec.get("memory_peak_bytes",
                                                      0)}}
    if args.trace and "profile" in rec:
        result["device"]["busy_s"] = rec["profile"]["busy_s"]
        result["device"]["window_s"] = rec["profile"]["window_s"]
        result["breakdown"] = rec["breakdown"]
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.harness.cell import load_cell
    from benchmark.harness.result import banned_modules, emit

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(args, torch.device("cuda", 0), T_START)
    loaded = banned_modules(sys.modules)
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
