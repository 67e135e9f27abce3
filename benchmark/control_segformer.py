"""The control and the faults of the SegFormer cell's check, and the spread
of its reference logits. Each reading puts a reference in the program's
place and compares its granule probabilities with the fp32 reference's, as
the cell compares the program's: ``fp8``, every operand of every product,
convolution and attention product rounded to float8 e4m3 (the next
precision below the cell's bf16); ``no_dwconv``, stage 1's first block
without its depthwise conv; ``scale64``, stage 1's softmax scale at 1/64
instead of 1/8. Each reading goes through the driver's own check
(``drivers/serve_bf16.check``), so its ``correct`` is the one a run of the
cell would report had the program computed that way. ``logits`` gives the standard deviation
and mean of the fp32 reference's logits over a 2×2 grid of tiles of every
granule of the pool (the configuration's ``init`` is chosen to put the
deviation between 1 and 4). The weights are those of the cell's runs: drawn
from the seed, the classifier's bias centred on the first granule.

    python3 benchmark/control_segformer.py --workload segformer-serve-8192 \\
        --seeds N [N ...] [--readings fp8 no_dwconv scale64 logits]

prints one JSON line a seed. The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

READINGS = ("fp8", "no_dwconv", "scale64", "logits")


def readings(cell, seed: int, device, which=READINGS,
             granules=None) -> dict:
    """The readings ``which`` of seed ``seed``: for each comparison
    ``max_dp``, ``mean_dp`` and ``correct`` of the driver's check over the
    first ``granules`` (the mix's check sample by default) of the seed's
    pool."""
    import torch

    from benchmark.drivers.serve_bf16 import check
    from benchmark.harness.cell import load_module
    from benchmark.harness.granules import make_pool
    from benchmark.harness.segformer_weights import (center_logits,
                                                      corner_tiles,
                                                      make_weights)

    ref = load_module(cell.root / cell.config["reference"],
                      "benchmark_reference_segformer")
    mix, seg = cell.mix, cell.config["segformer"]
    pool = make_pool(mix["granule"], seed, device)
    w = make_weights(seg, cell.config["model"], cell.config["init"], seed,
                     device)
    tile, overlap, chunk = mix["tile"], mix["overlap"], mix["check_chunk"]
    center_logits(w, seg, ref.forward, corner_tiles(pool[0], tile, device),
                  chunk)
    out = {}
    if "logits" in which:
        values = []
        for channels in pool:
            tiles = corner_tiles(channels, tile, device)
            with torch.no_grad():
                for at in range(0, len(tiles), chunk):
                    values.append(ref.forward(w, seg, tiles[at:at + chunk])
                                  .flatten().double())
        v = torch.cat(values)
        out["logits"] = {"std": float(v.std()), "mean": float(v.mean()),
                         "tiles": 4 * len(pool)}
    compared = [r for r in which if r != "logits"]
    count = granules or mix["check_sample"]
    for r in compared:
        sample = []
        with torch.no_grad():
            for k in range(count):
                x = torch.from_numpy(pool[k % len(pool)]).to(device)
                other = ref.granule_probs(
                    w, seg, x, tile, overlap, chunk=chunk, low=r == "fp8",
                    fault=None if r == "fp8" else r)
                sample.append((k, other.cpu().numpy()))
        checks = check(cell, ref, w, pool, sample, device)
        out[r] = {"max_dp": checks["max_dp"]["value"],
                  "mean_dp": checks["mean_dp"]["value"], "granules": count,
                  "correct": all((c["value"] <= c["limit"])
                                 if c["rule"] == "<=" else
                                 (c["value"] >= c["limit"])
                                 for c in checks.values())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--readings", nargs="+", choices=READINGS,
                   default=list(READINGS))
    p.add_argument("--granules", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, torch.device("cuda", 0), args.readings,
                       args.granules)
        out.update(workload=args.workload, seed=seed,
                   limits=cell.limits, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
