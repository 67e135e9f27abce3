"""Data-parallel train steps on the card against the one-process step on
the same global batches, at full width (``UNetConfig()``: base 32, depth
4, over fp32 masters).

Two ranks (``parallel/launch.launch``), each with half of every global
batch drawn from two synthetic granules, take ``--steps`` steps from the
same seeded weights with the augmentation codes of ``step_generator(seed,
step)``; the parent takes the same steps in one process on the global
batches. One launch runs every case of ``CASES``: bf16 compute (the
trainer's) at 16 × 512², and float64 compute at 16 × 256², where rounding
cannot reach a gradient's sign. Returned per case and step: both losses
and IoUs, the running buffers' largest distance (over each tensor's
largest magnitude), each rank's step time (host clock around a
synchronised step) and the one-process step's; after the last step the
largest parameter distance, and whether the ranks hold equal parameters
and buffers.

With as many cards as ranks, one rank a card over NCCL; with fewer, the
ranks share ``cuda:0`` over gloo, which rehearses the collectives but times
two ranks sharing one card, not a multi-card step (NCCL refuses two ranks
on one device).

``python -m plumekit_torch.experiments.data_parallel_steps [--ranks 2]
[--steps 3] [--out PATH]`` on a card (exits 1 without one)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from plumekit_torch.config.train import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.models import build_model
from plumekit_torch.train.data import make_synthetic_dataset, tile_batches
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step, step_generator

#: the steps' config: warmup 1, so the first step runs at lr 0 and the
#: later ones at the peak, as the training phase's parity steps do
TRAIN = TrainConfig(batch_size=16, tile_size=512, warmup_steps=1,
                    total_steps=4)
#: label → (compute dtype, tile)
CASES = {"bf16": ("bfloat16", 512), "float64": ("float64", 256)}
STEPS = 3
SEED = 0


def global_batches(tcfg: TrainConfig, steps: int, seed: int = SEED):
    """``steps`` global batches of the host tile stream over two synthetic
    1024² granules, drawn from ``default_rng(seed)``."""
    samples = make_synthetic_dataset(DataConfig(
        granule_size=max(1024, tcfg.tile_size), n_train_granules=2))
    stream = tile_batches(samples, tcfg.tile_size, tcfg.batch_size,
                          np.random.default_rng(seed))
    return [next(stream) for _ in range(steps)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _buffers(model):
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _steps(case, weights, part, device, group=None):
    """The case's steps from ``weights``: per step (loss, IoU), the running
    buffers after it and its ms; the model."""
    tcfg = TrainConfig(**case["train"])
    state = create_state(UNetConfig(**case["unet"]), tcfg, device)
    state.model.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in weights.items()})
    step = make_train_step(tcfg.dice_weight, tcfg.augment, group=group)
    metrics, buffers, times = [], [], []
    for i, (xs, ys) in enumerate(case["batches"]):
        x = torch.from_numpy(xs[part]).to(device)
        y = torch.from_numpy(ys[part]).to(device)
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, x, y, step_generator(tcfg.seed, i, device))
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append((float(m["loss"]), float(m["iou"])))
        buffers.append(_buffers(state.model))
    return metrics, buffers, times, state.model


def rank_steps(rank, device, payload):
    """One rank: the data-parallel steps of every case of
    ``payload["cases"]``. Returns on rank 0, per case, the losses and IoUs,
    the running buffers after each step, the parameters after the last
    (numpy), every rank's step times and whether all ranks hold the same
    parameters and buffers."""
    import torch.distributed as dist

    from plumekit_torch.parallel.data_parallel import rank_slice

    group = dist.group.WORLD
    out = {}
    for label, case in payload["cases"].items():
        part = rank_slice(case["train"]["batch_size"], group)
        metrics, buffers, times, model = _steps(case, payload["weights"],
                                                part, device, group)
        flat = torch.cat([t.detach().double().reshape(-1)
                          for t in model.state_dict().values()])
        sums = torch.stack([flat.sum(), flat.abs().sum()]).to(device)
        low, high = sums.clone(), sums.clone()
        dist.all_reduce(low, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(high, op=dist.ReduceOp.MAX, group=group)
        mine = torch.tensor(times, dtype=torch.float64, device=device)
        every = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(every, mine, group=group)
        out[label] = {"metrics": metrics, "buffers": buffers,
                      "step_ms": [t.cpu().tolist() for t in every],
                      "same_on_every_rank": bool(torch.equal(low, high)),
                      "params": {n: p.detach().cpu().numpy()
                                 for n, p in model.named_parameters()}}
        del model
    return out if rank == 0 else None


def _rel_buffer_distance(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - w).max())
               / max(float(np.abs(w).max()), 1e-30)
               for k, w in want.items())


def run(devices, cases=CASES, steps: int = STEPS, unet=UNetConfig(),
        tcfg: TrainConfig = TRAIN, backend=None) -> dict:
    """Every case's data-parallel steps on ``devices`` (one rank each, one
    launch) and its one-process steps on ``devices[0]``, from the same
    seeded weights (fp32 masters, whatever the compute dtype)."""
    from plumekit_torch.parallel.launch import launch

    weights = {k: v.numpy() for k, v in build_model(
        unet, torch.Generator().manual_seed(SEED)).state_dict().items()}
    payload = {}
    for label, (dtype, tile) in cases.items():
        t = dataclasses.replace(tcfg, tile_size=tile)
        payload[label] = {
            "unet": dataclasses.asdict(dataclasses.replace(
                unet, compute_dtype=dtype)),
            "train": dataclasses.asdict(t),
            "batches": global_batches(t, steps)}
    t0 = time.perf_counter()
    dp = launch(rank_steps, devices, backend=backend,
                args=({"cases": payload, "weights": weights},))
    launch_s = time.perf_counter() - t0
    device = torch.device(devices[0])
    out = {"ranks": len(devices), "devices": [str(d) for d in devices],
           "launch_s": launch_s}
    for label, case in payload.items():
        metrics, buffers, times, model = _steps(case, weights, slice(None),
                                                device)
        params = max(float(np.abs(dp[label]["params"][n].astype(np.float64)
                                  - p.detach().cpu().double().numpy())
                           .max())
                     for n, p in model.named_parameters())
        del model
        lr = case["train"]["learning_rate"]
        out[label] = {
            "batch": case["train"]["batch_size"],
            "tile": case["train"]["tile_size"],
            "dp_metrics": dp[label]["metrics"], "one_metrics": metrics,
            "rel_dbuffers": [_rel_buffer_distance(g, w) for g, w in
                             zip(dp[label]["buffers"], buffers)],
            "max_abs_dparam": params, "max_abs_dparam_over_lr": params / lr,
            "dp_step_ms": dp[label]["step_ms"], "one_step_ms": times,
            "same_on_every_rank": dp[label]["same_on_every_rank"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("data_parallel_steps: needs a CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(args.ranks)]
               if cards >= args.ranks else [torch.device("cuda", 0)]
               * args.ranks)
    out = run(devices, steps=args.steps)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
