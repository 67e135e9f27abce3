"""Whole ``predict_model`` calls of two source trees on one card, in turns.

Makes a root of ``--granules`` synthetic ``--px``² granules
(``io/synthetic.make_scene``, seeds 0..) and a checkpoint of
``UNetConfig()`` with seeded weights, then, for each tree of ``--trees`` in
the order given (e.g. parent, change, change, parent), starts one process
in that tree that imports its ``plumekit_torch.cli`` and times
``predict_model`` over the root ``--reps`` times per forward: plain,
``--fused`` and ``--int8``, after one untimed call of each (host clock
around the call, the card synchronised before and after; the process's
start and the kernels' builds fall outside). The trees need only their own
``plumekit_torch``: an older one serves through its own stream. Prints one
line per tree and forward with the seconds and MPix/s, the host's core
count and the card's name and power limit, and writes them to ``--out``.

``python -m plumekit_torch.experiments.serving_stream_times --trees
build/parent . . build/parent [--granules 4] [--px 2048] [--reps 2]`` on a
card (exits 1 without one)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

FORWARDS = {"plain": [], "fused": ["--fused"], "int8": ["--int8"]}

#: run in each tree's own process: times its CLI over the root
TIMER = """
import json, sys, time
import torch
from plumekit_torch import cli
root, reps, forwards = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
out = {}
for name, flags in forwards.items():
    # first use: builds, loads and warms the forward's kernels
    if cli.main(["predict_model", "--root", root, *flags]):
        sys.exit(f"predict_model {flags} failed")
    out[name] = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["predict_model", "--root", root, *flags])
        torch.cuda.synchronize()
        if rc:
            sys.exit(f"predict_model {flags} exited {rc}")
        out[name].append(time.perf_counter() - t0)
print("TIMES " + json.dumps(out))
"""


def make_root(root: str, granules: int, px: int) -> None:
    """Synthetic granules under ``root`` and a seeded ``UNetConfig()``
    checkpoint."""
    from plumekit_torch.config import UNetConfig
    from plumekit_torch.io.granule import save_granule
    from plumekit_torch.io.synthetic import SyntheticSceneConfig, make_scene
    from plumekit_torch.models import build_model
    from plumekit_torch.train.checkpoint import (save_model_config,
                                                 save_weights)

    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    for seed in range(granules):
        scene = make_scene(SyntheticSceneConfig(
            size=px, n_plumes=6, seed=seed, background_level=0.15,
            background_noise=0.04, plume_sigma_major=(40.0, 120.0),
            plume_sigma_minor=(8.0, 24.0)))
        save_granule(os.path.join(maiac, f"g{seed}.npz"), scene.granule)
    ckpt = os.path.join(root, "models", "checkpoints")
    cfg = UNetConfig()
    save_model_config(ckpt, cfg)
    save_weights(ckpt, build_model(cfg, torch.Generator().manual_seed(0)))


def time_tree(tree: str, root: str, reps: int) -> dict:
    """The TIMER's seconds per forward, run in ``tree``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run(
        [sys.executable, "-c", TIMER, root, str(reps), json.dumps(FORWARDS)],
        cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exited {proc.returncode}\n"
                           + proc.stderr[-4000:])
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("TIMES "))
    return json.loads(line[len("TIMES "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--granules", type=int, default=4)
    ap.add_argument("--px", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/serving_stream_times.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serving_stream_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    mpix = args.granules * args.px**2 / 1e6
    res = {"device": smi, "cores": os.cpu_count(), "granules": args.granules,
           "px": args.px, "runs": []}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        root = os.path.join(tmp, "root")
        make_root(root, args.granules, args.px)
        for tree in args.trees:
            times = time_tree(tree, root, args.reps)
            res["runs"].append({"tree": tree, "seconds": times})
            for name, secs in times.items():
                print(f"{tree} {name}: " + ", ".join(
                    f"{s:.3f} s ({mpix / s:.3f} MPix/s)" for s in secs)
                    + f"; {os.cpu_count()} cores", flush=True)
    for name in FORWARDS:
        per_tree: dict = {}
        for run in res["runs"]:
            per_tree.setdefault(run["tree"], []).extend(run["seconds"][name])
        res[name] = {t: float(np.median(s)) for t, s in per_tree.items()}
        print(f"{name}: median s per tree " + ", ".join(
            f"{t} {s:.3f}" for t, s in res[name].items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
