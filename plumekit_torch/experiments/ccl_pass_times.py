"""Times of the CCL sweep kernel pass by pass, and of the label-count kernel.

K1/K4 (``pk_ccl_sweep``) and K2 (``pk_ccl_masks``) are three launches each:
the local pass, the border pass and the finalize pass. Their libraries also
export ``pk_ccl_sweep_passes`` and ``pk_ccl_masks_passes``, which launch the
first one, two or three of them; a pass's time is the difference of two
such prefixes (a prefix always starts from the local pass, which writes
every label it needs, so each reading starts from the same state). K3
(``fire_label_counts``) is one launch. Every time is the queued form: 20
calls between one pair of CUDA events, divided by 20, so that the host's
time per call stays out of the reading.

Scenes (the identify path's, at T = 20 thresholds of ``RGIdentifyConfig``
unless named): K1 on the identify benchmark's 1200² scene, card-made 4096²
and 8192² scenes with the same statistics and a 1024² serpentine; K2 on the
basic detector's 1200² mask and on basic's mask of the 8192² scene (it
percolates); K3 at F = 16, 64 and 128 on K1's labels at 1200² and 8192².
Each level's foreground share and component count are printed beside the
times.

``python -m plumekit_torch.experiments.ccl_pass_times [--out PATH]`` on a
card; prints one line per reading and writes the JSON to ``PATH``
(``chiprun_out/ccl_pass_times.json``)."""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch.config.identify import (BasicIdentifyConfig,
                                            RGIdentifyConfig)
from plumekit_torch.io.synthetic import SyntheticSceneConfig, make_scene
from plumekit_torch.ops.kernels import ccl_sweep, label_counts
from plumekit_torch.ops.morphology import binary_opening_cross

QUEUED = 20   # launches per event pair
PASS_NAMES = ("local", "border", "finalize")
THRESHOLDS = np.asarray(RGIdentifyConfig().thresholds, np.float32)
# the identify benchmark's scene (bench.py:267-271): 1200², 9 plumes
BENCH_SCENE = dict(size=1200, n_plumes=9, background_level=0.2,
                   background_noise=0.05, plume_amplitude=(0.6, 0.8),
                   plume_sigma_major=(9.0, 14.0),
                   plume_sigma_minor=(1.8, 2.6), fires_per_plume=(7, 9),
                   extra_fires=4)
# the basic detector's scenes: the bench scene over a clean background
# (tests/test_identify_basic_parity.py's statistics), since its one mask at
# AOD >= 0.2 percolates over the bench scene's background of 0.2
BASIC_SCENE = dict(BENCH_SCENE, background_level=0.05, background_noise=0.02,
                   plume_amplitude=(0.5, 0.8), plume_sigma_minor=(2.0, 3.0))


def device_scene(h, w, seed, device):
    """An (h, w) float32 AOD plane made on ``device`` with the identify
    benchmark scene's statistics: smooth noise about 0.2 and, per 1200²,
    nine plumes (amplitude 0.6-0.8, sigmas 9-14 by 1.8-2.6 px) and three
    round background blobs. Returns the plane and the plume origins as
    (rows, cols)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((1, 1, h, w), generator=gen, device=device)
    for _ in range(2):
        noise = F.avg_pool2d(noise, 9, stride=1, padding=4,
                             count_include_pad=False)
    noise = noise[0, 0]
    aod = torch.clamp(0.2 + 0.035 * noise / noise.std(), min=0.0)
    rng = np.random.default_rng(seed)
    rr = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cc = torch.arange(w, device=device, dtype=torch.float32)[None, :]

    def add(r, c, theta, s_major, s_minor, amp):
        reach = int(6 * s_major) + 1
        r0, r1 = max(0, int(r) - reach), min(h, int(r) + reach + 1)
        c0, c1 = max(0, int(c) - reach), min(w, int(c) + reach + 1)
        dr, dc = rr[r0:r1] - r, cc[:, c0:c1] - c
        u = dc * math.cos(theta) + dr * math.sin(theta)
        v = -dc * math.sin(theta) + dr * math.cos(theta)
        aod[r0:r1, c0:c1] += amp * torch.exp(
            -0.5 * ((u / s_major) ** 2 + (v / s_minor) ** 2))

    scale, margin = h * w / 1200**2, 48
    origins = []
    for _ in range(max(1, round(9 * scale))):
        r0 = rng.uniform(margin, h - margin)
        c0 = rng.uniform(margin, w - margin)
        theta = rng.uniform(0, np.pi)
        s_major, s_minor = rng.uniform(9.0, 14.0), rng.uniform(1.8, 2.6)
        add(r0 + s_major * np.sin(theta), c0 + s_major * np.cos(theta),
            theta, s_major, s_minor, rng.uniform(0.6, 0.8))
        origins.append((r0, c0))
    for _ in range(round(3 * scale)):
        sigma = rng.uniform(8.0, 14.0)
        add(rng.uniform(margin, h - margin), rng.uniform(margin, w - margin),
            0.0, sigma, sigma, rng.uniform(0.3, 0.6))
    return aod.contiguous(), np.asarray(origins).T


def serpentine(h, w, device, thick=3):
    """One component whose path reverses every band: ``thick``-px
    corridors that survive the opening, joined at alternating ends."""
    f = torch.full((h, w), 0.3, device=device)
    period = 2 * thick
    for top in range(0, h - thick + 1, period):
        f[top:top + thick] = 1.3
        if top + period < h:
            cols = slice(0, thick) if (top // period) % 2 == 0 \
                else slice(w - thick, w)
            f[top + thick:top + period, cols] = 1.3
    return f


def time_ms(fn, reps=5, warmup=2, calls=QUEUED):
    """Median of ``reps`` CUDA-event readings after ``warmup`` calls, each
    around ``calls`` calls of ``fn`` and divided by them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _passes_library():
    lib = ccl_sweep._library()
    if lib.pk_ccl_sweep_passes.argtypes is None:
        lib.pk_ccl_sweep_passes.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.pk_ccl_sweep_passes.restype = ctypes.c_int
        lib.pk_ccl_masks_passes.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.pk_ccl_masks_passes.restype = ctypes.c_int
    return lib


def _check(lib, err):
    if err != 0:
        raise RuntimeError(lib.pk_ccl_error_string(err).decode())


def sweep_prefix(aod, th, out, connectivity, passes):
    """The first ``passes`` passes of K1 into ``out``."""
    lib = _passes_library()
    t_count, h, w = out.shape
    _check(lib, lib.pk_ccl_sweep_passes(
        aod.data_ptr(), th.data_ptr(), out.data_ptr(), t_count, h, w,
        connectivity, passes, torch.cuda.current_stream().cuda_stream))


def masks_prefix(masks, out, connectivity, passes):
    """The first ``passes`` passes of K2 into ``out``."""
    lib = _passes_library()
    t_count, h, w = out.shape
    _check(lib, lib.pk_ccl_masks_passes(
        masks.data_ptr(), out.data_ptr(), t_count, h, w, connectivity,
        passes, torch.cuda.current_stream().cuda_stream))


def pass_split(prefix, reps):
    """ms of each pass from the queued times of the three prefixes;
    ``prefix(n)`` launches the first n passes."""
    prefixes = [time_ms(lambda n=n: prefix(n), reps=reps) for n in (1, 2, 3)]
    split = {name: prefixes[i] - (prefixes[i - 1] if i else 0.0)
             for i, name in enumerate(PASS_NAMES)}
    split["total"] = prefixes[-1]
    return split


def level_stats(labels):
    """Per level: the foreground share and the number of components (the
    pixels whose label is their own id + 1)."""
    t_count, h, w = labels.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=labels.device)
    flat = labels.view(t_count, -1)
    return {"foreground_share": [float((flat[t] > 0).float().mean())
                                 for t in range(t_count)],
            "components": [int((flat[t] == ids).sum())
                           for t in range(t_count)]}


def fire_labs(labels, f_count, rng):
    """(T, F) labs as the sweep hands them to K3: labels of real pixels,
    with the not-found 0, a duplicate and an absent label among them."""
    t_count, h, w = labels.shape
    idx = torch.from_numpy(rng.integers(0, h * w, (t_count, f_count))).to(
        labels.device)
    labs = torch.gather(labels.view(t_count, -1), 1, idx)
    labs[:, 0] = 0
    if f_count > 2:
        labs[:, 1] = labs[:, 2]
        labs[:, -1] = h * w + 7
    return labs.contiguous()


def k1_scenes(device):
    bench = make_scene(SyntheticSceneConfig(seed=0, **BENCH_SCENE))
    yield "bench_1200", torch.from_numpy(
        bench.granule.first_layer()).to(device), THRESHOLDS
    for n in (4096, 8192):
        yield f"synthetic_{n}", device_scene(n, n, n, device)[0], THRESHOLDS
    yield "serpentine_1024", serpentine(1024, 1024, device), \
        np.asarray([0.5, 0.25], np.float32)


def k2_masks(device):
    limit = BasicIdentifyConfig().aod_min_limit
    clean = torch.from_numpy(make_scene(SyntheticSceneConfig(
        seed=0, **BASIC_SCENE)).granule.first_layer()).to(device)
    yield "basic_scene_1200_mask", binary_opening_cross(
        clean >= limit)[None].contiguous()
    swath = device_scene(8192, 8192, 8192, device)[0]
    yield "basic_mask_8192", binary_opening_cross(
        swath >= limit)[None].contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/ccl_pass_times.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ccl_pass_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    res = {"device": smi, "queued_calls": QUEUED, "k1": [], "k2": [],
           "k3": []}
    for name, aod, ths in k1_scenes(dev):
        th = torch.from_numpy(ths).to(dev)
        h, w = aod.shape
        reps = 3 if h * w >= 4096**2 else 5
        out = torch.empty((len(ths), h, w), dtype=torch.int32, device=dev)
        split = pass_split(lambda n: sweep_prefix(aod, th, out, 2, n), reps)
        labels = ccl_sweep.multi_threshold_ccl_fused(aod, th)
        row = {"scene": name, "h": h, "w": w, "levels": len(ths), **split,
               "wrapper_ms": time_ms(
                   lambda: ccl_sweep.multi_threshold_ccl_fused(aod, th),
                   reps=reps),
               **level_stats(labels)}
        res["k1"].append(row)
        print(f"K1 {name} T={len(ths)}: " + ", ".join(
            f"{k} {row[k]:.3f}" for k in (*PASS_NAMES, "total",
                                          "wrapper_ms"))
              + f" ms; foreground {row['foreground_share']}, components "
              f"{row['components']}", flush=True)
        if name in ("bench_1200", "synthetic_8192"):
            for f_count in (16, 64, 128):
                labs = fire_labs(labels, f_count, rng)
                ms = time_ms(lambda: label_counts.fire_label_counts(
                    labels, labs), reps=reps)
                k3 = {"scene": name, "F": f_count, "ms": ms,
                      "gb_per_s": labels.numel() * 4 / ms / 1e6}
                res["k3"].append(k3)
                print(f"K3 {name} F={f_count}: {ms:.3f} ms "
                      f"({k3['gb_per_s']:.0f} GB/s)", flush=True)
        del out, labels, aod
        torch.cuda.empty_cache()
    for name, masks in k2_masks(dev):
        t_count, h, w = masks.shape
        reps = 3 if h * w >= 4096**2 else 5
        out = torch.empty((t_count, h, w), dtype=torch.int32, device=dev)
        split = pass_split(lambda n: masks_prefix(masks, out, 2, n), reps)
        labels = ccl_sweep.multi_threshold_ccl(masks, 2, nested=False)
        row = {"scene": name, "h": h, "w": w, "levels": t_count, **split,
               "wrapper_ms": time_ms(lambda: ccl_sweep.multi_threshold_ccl(
                   masks, 2, nested=False), reps=reps),
               **level_stats(labels)}
        res["k2"].append(row)
        print(f"K2 {name}: " + ", ".join(
            f"{k} {row[k]:.3f}" for k in (*PASS_NAMES, "total",
                                          "wrapper_ms"))
              + f" ms; foreground {row['foreground_share']}, components "
              f"{row['components']}", flush=True)
        del out, labels, masks
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
