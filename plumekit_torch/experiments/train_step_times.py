"""Times of the training step on a card at full width (``UNetConfig()``:
base 32, depth 4, batch norm, bf16 over fp32 masters).

Two geometries, each on two synthetic granules from ``DataConfig``:

* ``bench``: the JAX package's bench geometry for training
  (``bench.py:212-245``): batch 16, tile 128, the dataset resident on the
  card (``train/device_data.py``), 10 steps per chunk, 256² granules;
* ``config2``: ``TrainConfig()``'s defaults: batch 16, tile 512, the host
  tile iterator, 1200² granules.

Each runs 5 warm-up steps, then ``--steps`` steps timed one at a time
(synchronised after each): the draw (the host clock around the numpy draw,
or CUDA events around the draw on the card), the upload (CUDA events
around pinning and the copies) and the step body (CUDA events around the
augmentation, forward, backward and AdamW update); then as many steps as
the loop runs them, with nothing synchronised between steps (the host
clock over the run, ended by a synchronise). On the host iterator the
loop runs twice each way, in turns, after 5 untimed steps of the
prefetched stream: through the training loop's stream (the batches drawn,
stacked and uploaded on a stager thread two ahead,
``train/loop.host_chunks``) and through the serial ``host_batches``
(drawn on the calling thread). Printed per geometry: ms per
step (median, with the spread), MPix/s, TFLOP/s at three forwards' FLOPs
per pixel (``bench.py:392``'s convention) and their share of the H100's
989 TFLOP/s bf16 data-sheet peak, the host's share of a step, and the peak
memory.

With ``--profile`` each geometry also runs 5 steps the loop's way under
``torch.profiler``: the card's kernel time by class (convolutions, batch
norm, other elementwise and reductions, the optimizer, copies) and its
busy share of the wall time.

``python -m plumekit_torch.experiments.train_step_times [--steps N]
[--profile] [--out PATH]`` on a card (exits 1 without one)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from plumekit_torch.config.train import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.models.flops import PEAK_TFLOPS, model_flops_per_pixel
from plumekit_torch.train.data import make_synthetic_dataset, tile_batches
from plumekit_torch.train.device_data import (build_device_dataset,
                                              draw_tile_batch,
                                              make_device_multi_step)
from plumekit_torch.train.loop import host_batches, host_chunks
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import (make_multi_train_step, make_train_step,
                                       step_generator)

GEOMETRIES = {
    "bench": (TrainConfig(batch_size=16, tile_size=128, device_data=True,
                          steps_per_dispatch=10),
              DataConfig(granule_size=256, n_train_granules=2)),
    "config2": (TrainConfig(), DataConfig(n_train_granules=2)),
}
WARMUP = 5


def _spread(values):
    v = np.asarray(values, np.float64)
    return {"median": float(np.median(v)), "min": float(v.min()),
            "max": float(v.max()), "p10": float(np.percentile(v, 10)),
            "p90": float(np.percentile(v, 90))}


def _event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


#: kernel classes of the profile, by the first name fragment that matches
KERNEL_CLASSES = (
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("statistics (Welford)", ("welford",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_",
                     "wgrad", "dgrad", "fprop", "winograd", "fft")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("copies and casts", ("memcpy", "memset", "copy")),
    ("elementwise and reductions", ("elementwise", "reduce", "vectorized",
                                    "where", "index", "cat", "max_pool",
                                    "pool", "gather", "scatter", "fill")),
)
PROFILED_STEPS = 5


def _profile(loop, first) -> dict:
    """``loop(first, PROFILED_STEPS)`` under ``torch.profiler``: device
    time per kernel class and the card's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(first, PROFILED_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict = {}
    kernels: dict = {}
    for e in prof.events():
        # ranges such as "Optimizer.step#AdamW.step" also land on the
        # card's timeline; only kernels and copies count
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        kernels[e.name] = kernels.get(e.name, 0.0) + us
    busy = sum(by_class.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": PROFILED_STEPS, "wall_ms_per_step":
            wall_us / 1e3 / PROFILED_STEPS,
            "device_ms_per_step": {c: us / 1e3 / PROFILED_STEPS
                                   for c, us in by_class.items()},
            "busy_share": busy / wall_us if busy else None,
            "top_kernels_ms_per_step": [(n[:120], us / 1e3 / PROFILED_STEPS)
                                        for n, us in top]}


def time_geometry(name: str, steps: int, device="cuda",
                  profiled: bool = False) -> dict:
    """One geometry of :data:`GEOMETRIES`: the timed steps and the loop's
    rate (see the module docstring)."""
    tcfg, dcfg = GEOMETRIES[name]
    device = torch.device(device)
    unet_cfg = UNetConfig()
    samples = make_synthetic_dataset(dcfg, train=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_state(unet_cfg, tcfg, device)
    step = make_train_step(tcfg.dice_weight, tcfg.augment, tcfg.label_smooth)
    tile, batch = tcfg.tile_size, tcfg.batch_size
    if tcfg.device_data:
        ds = build_device_dataset(samples, tile, device)
    else:
        stream = tile_batches(samples, tile, batch,
                              np.random.default_rng((tcfg.seed, 0)))
    rows = []
    for s in range(WARMUP + steps):
        (e0, e1), e2 = _event_pair(), torch.cuda.Event(enable_timing=True)
        generator = step_generator(tcfg.seed, s, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tcfg.device_data:
            e0.record()
            xs, ys = draw_tile_batch(ds, generator, batch, tile)
            e1.record()
        else:
            xs, ys = next(stream)
            t1 = time.perf_counter()
            e0.record()
            xs = torch.from_numpy(xs).pin_memory().to(device,
                                                      non_blocking=True)
            ys = torch.from_numpy(ys).pin_memory().to(device,
                                                      non_blocking=True)
            e1.record()
        state, metrics = step(state, xs, ys, generator)
        e2.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if s >= WARMUP:
            moved = e0.elapsed_time(e1)
            rows.append({
                "wall_ms": (t2 - t0) * 1e3,
                "draw_ms": (moved if tcfg.device_data
                            else (t1 - t0) * 1e3),
                "upload_ms": 0.0 if tcfg.device_data else moved,
                "body_ms": e1.elapsed_time(e2)})
    loss = float(metrics["loss"])

    # the loop's way: chunks of steps_per_dispatch, nothing synchronised
    start = WARMUP + steps
    torch.cuda.synchronize()
    if tcfg.device_data:
        multi = make_device_multi_step(tcfg.dice_weight, tcfg.augment,
                                       tcfg.label_smooth, seed=tcfg.seed,
                                       tile=tile, batch_size=batch)

        def loop(first, n):
            nonlocal state, metrics
            k = tcfg.steps_per_dispatch
            for s in range(first, first + n, k):
                state, metrics = multi(state, ds,
                                       range(s, min(s + k, first + n)))
    else:
        multi = make_multi_train_step(tcfg.dice_weight, tcfg.augment,
                                      tcfg.label_smooth, seed=tcfg.seed)

        def loop(first, n):
            # the training loop's stream: one-step chunks from the stager
            nonlocal state, metrics
            chunks = host_chunks(samples, tile, batch,
                                 np.random.default_rng((tcfg.seed, first)),
                                 device, [1] * n)
            for s in range(first, first + n):
                state, metrics = multi(state, next(chunks), [s])
            chunks.close()

        def serial_loop(first, n):
            nonlocal state, metrics
            batches = host_batches(samples, tile, batch,
                                   np.random.default_rng((tcfg.seed, first)),
                                   device)
            for s in range(first, first + n):
                xs, ys = next(batches)
                state, metrics = step(state, xs, ys,
                                      step_generator(tcfg.seed, s, device))

    def run_ms(fn, first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(first, steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    prefetched_ms, serial_ms = [], []
    if tcfg.device_data:
        loop_ms = run_ms(loop, start)
    else:
        # the stager's first chunks and pinned blocks outside the timing,
        # as the serial loop's are (the timed steps above pinned its own)
        loop(start, WARMUP)
        start += WARMUP
        # in turns: prefetched, serial, serial, prefetched
        runs = [run_ms(fn, start + i * steps) for i, fn in
                enumerate((loop, serial_loop, serial_loop, loop))]
        prefetched_ms, serial_ms = [runs[0], runs[3]], runs[1:3]
        loop_ms = float(np.mean(prefetched_ms))
        start += 3 * steps
    loss_after = float(metrics["loss"])
    profile = _profile(loop, start + steps) if profiled else None

    px = batch * tile * tile
    flops = 3.0 * model_flops_per_pixel(unet_cfg) * px
    body = _spread([r["body_ms"] for r in rows])["median"]
    wall = _spread([r["wall_ms"] for r in rows])
    host = [(r["draw_ms"] + r["upload_ms"]) / r["wall_ms"] for r in rows]
    res = {
        "geometry": name, "batch": batch, "tile": tile,
        "device_data": tcfg.device_data,
        "steps_per_dispatch": tcfg.steps_per_dispatch,
        "granules": dcfg.n_train_granules, "granule_px": dcfg.granule_size,
        "timed_steps": steps, "warmup_steps": WARMUP,
        "wall_ms": wall,
        "body_ms": _spread([r["body_ms"] for r in rows]),
        "draw_ms": _spread([r["draw_ms"] for r in rows]),
        "upload_ms": _spread([r["upload_ms"] for r in rows]),
        "host_share": _spread(host),
        "loop_ms_per_step": loop_ms,
        "prefetched_loop_ms_per_step": prefetched_ms,
        "serial_loop_ms_per_step": serial_ms,
        "loop_mpix_s": px / loop_ms / 1e3,
        "body_mpix_s": px / body / 1e3,
        "body_tflops": flops / body / 1e9,
        "loop_tflops": flops / loop_ms / 1e9,
        "peak_tflops_bf16": PEAK_TFLOPS["bf16"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first_timed": loss, "loss_last": loss_after,
        "profile": profile}
    res["body_mfu_pct"] = 100.0 * res["body_tflops"] / PEAK_TFLOPS["bf16"]
    res["loop_mfu_pct"] = 100.0 * res["loop_tflops"] / PEAK_TFLOPS["bf16"]
    if not (np.isfinite(loss) and np.isfinite(loss_after)):
        raise AssertionError(f"train step {name}: non-finite loss")
    return res


def summary(res: dict) -> str:
    return (f"train step {res['geometry']} ({res['batch']}x{res['tile']}^2, "
            f"{'device data' if res['device_data'] else 'host iterator'}): "
            f"{res['wall_ms']['median']:.3f} ms per step alone "
            f"({res['wall_ms']['min']:.3f}-{res['wall_ms']['max']:.3f}), "
            f"body {res['body_ms']['median']:.3f} ms, draw "
            f"{res['draw_ms']['median']:.3f}, upload "
            f"{res['upload_ms']['median']:.3f}, host share "
            f"{100 * res['host_share']['median']:.1f}%; the loop "
            f"{res['loop_ms_per_step']:.3f} ms per step"
            + (" (prefetched " + "/".join(
                f"{ms:.3f}" for ms in res["prefetched_loop_ms_per_step"])
               + ", serial host_batches " + "/".join(
                f"{ms:.3f}" for ms in res["serial_loop_ms_per_step"]) + ")"
               if res["serial_loop_ms_per_step"] else "")
            + f", {res['loop_mpix_s']:.2f} MPix/s, {res['loop_tflops']:.1f} "
            f"TFLOP/s ({res['loop_mfu_pct']:.2f}% of "
            f"{res['peak_tflops_bf16']:.0f}); body "
            f"{res['body_tflops']:.1f} TFLOP/s "
            f"({res['body_mfu_pct']:.2f}%); peak memory "
            f"{res['peak_memory_gb']:.2f} GB" + _profile_summary(res))


def _profile_summary(res: dict) -> str:
    prof = res.get("profile")
    if not prof:
        return ""
    if prof["busy_share"] is None:
        return "; profile: no device time recorded (not measured)"
    parts = ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
        prof["device_ms_per_step"].items(), key=lambda kv: -kv[1]))
    return (f"; profile: card busy {100 * prof['busy_share']:.1f}% of "
            f"{prof['wall_ms_per_step']:.2f} ms per step, kernel ms per "
            f"step: {parts}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also profile 5 steps per geometry")
    ap.add_argument("--out", default="chiprun_out/train_step_times.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {"device": smi, "geometries": []}
    for name in GEOMETRIES:
        row = time_geometry(name, args.steps, profiled=args.profile)
        res["geometries"].append(row)
        print(summary(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
