"""The control of a cell's check: the plain reference put in the program's
place at the next precision down, compared with the reference at the
precision the cell states, at the cell's own size: for the int8 serving
cells int4 weights and activations over the granules of the cell's own
pool, for the bf16 training cell every convolution's operands through
float8 e4m3 over the same checked steps. Its readings set the upper end of
each limit; a limit that they do not exceed would pass a program that ran
at that precision.

    python3 benchmark/control.py --workload CELL --seeds N [N ...] [--qmax 7]
                                 [--fault half_batch]

prints one JSON line a seed with the numbers the cell compares. The
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import statistics
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(cell, seed: int, device, qmax: int = 7,
                     granules=None) -> dict:
    """``max_dp`` and ``mean_dp`` of the reference at ``qmax`` against the
    reference at 127 over the first ``granules`` (the mix's check sample
    by default) of the seed's pool."""
    import torch

    from benchmark.harness.cell import load_module
    from benchmark.harness.granules import make_pool
    from benchmark.harness.weights import make_weights

    ref = load_module(cell.root / cell.config["reference"],
                      "benchmark_reference")
    mix = cell.mix
    pool = make_pool(mix["granule"], seed, device)
    w = make_weights(cell.model, cell.config["init"], seed, device)
    exact = ref.build(w, cell.model, pool[0], mix["tile"], 127, device)
    low = ref.build(w, cell.model, pool[0], mix["tile"], qmax, device)
    worst, total, n = 0.0, 0.0, 0
    count = granules or mix["check_sample"]
    for k in range(count):
        x = torch.from_numpy(pool[k % len(pool)]).to(device)
        p = ref.granule_probs(exact, cell.model, x, mix["tile"],
                              mix["overlap"])
        q = ref.granule_probs(low, cell.model, x, mix["tile"],
                              mix["overlap"], qmax)
        gap = (p - q).abs()
        worst = max(worst, float(gap.max()))
        total += float(gap.double().sum())
        n += gap.numel()
    return {"max_dp": worst, "mean_dp": total / n, "granules": count}


def train_control_readings(cell, seed: int, device,
                           fault: str = "") -> dict:
    """The training cell's numbers of the fp8 reference against the bf16
    one over the cell's checked steps; with ``fault="half_batch"``, of the
    reference that sees the first half of each batch (its loss the mean
    over that half) in the program's place instead. ``left_out`` counts
    the leaves the change's number leaves out."""
    from benchmark.drivers.train import readings
    from benchmark.harness.cell import load_module
    from benchmark.harness.granules import make_pool
    from benchmark.harness.weights import make_weights

    ref = load_module(cell.root / cell.config["reference_train"],
                      "benchmark_reference_train")
    mix = cell.mix
    samples = make_pool(mix["granule"], seed, device, masks=True)
    w = make_weights(cell.model, cell.config["init"], seed, device)
    steps = mix["checked_steps"]
    exact = ref.follow(w, cell.model, mix, samples, seed, steps, device)
    if fault == "half_batch":
        draws = ref.draw_batches(samples, mix["tile"], mix["batch_size"],
                                 np.random.default_rng((seed, 0)))
        half = mix["batch_size"] // 2
        batches = [tuple(a[:half] for a in next(draws)) for _ in range(steps)]
        other = ref.follow(w, cell.model, mix, samples, seed, steps, device,
                           batches=batches)
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")
    else:
        other = ref.follow(w, cell.model, mix, samples, seed, steps, device,
                           low=True)
    out = readings(cell, other, exact)
    g = {k: float(v.double().norm()) for k, v in exact["grad"].items()}
    median = statistics.median(g.values())
    out["left_out"] = sum(v < 1e-3 * median for v in g.values())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--qmax", type=int, default=7)
    p.add_argument("--fault", default="",
                   help="training only: half_batch reads that fault instead")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        device = torch.device("cuda", 0)
        out = (train_control_readings(cell, seed, device, args.fault)
               if cell.mix["driver"] == "train"
               else control_readings(cell, seed, device, args.qmax))
        out.update(workload=args.workload, seed=seed, qmax=args.qmax,
                   fault=args.fault,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
