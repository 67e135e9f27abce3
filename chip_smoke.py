"""Smoke run of plumekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the hand-written CUDA kernels of ``plumekit_torch/csrc`` (one
``nvcc`` per source, all at once) and drives the port's two paths:

* serving: K6 (fused double conv) against its plain PyTorch version at
  every U-Net block shape, the flagship U-Net (``UNetConfig()``: base 32,
  depth 4, bf16) through the fused and the plain forward, then four
  synthetic 2048² granules served end to end through ``predict_model
  --fused`` and through the plain forward;
* the rg weak labeller: K1/K4 (multi-threshold CCL) and K3 (label counts)
  against their plain versions, bit for bit, on the identify benchmark's
  1200² scene, 4096², 8192², a ragged 1201 × 997 scene and a serpentine;
  the rg sweep per scene at 1200² and 8192² with the kernels and with the
  plain versions, split by phase; then ``build_features --detector rg``
  over four synthetic 1200² granules, one of which must equal a
  ``--device cpu`` run.

Any failed check raises; there is no CPU fallback. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as JSON. Details also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

import torch.nn.functional as F  # noqa: E402

from plumekit_torch import cli, cuda_build  # noqa: E402
from plumekit_torch.config import InferConfig, UNetConfig  # noqa: E402
from plumekit_torch.infer.sliding import (  # noqa: E402
    _effective_batch, make_multi_granule_infer, tile_grid)
from plumekit_torch.infer.streaming import (  # noqa: E402
    decode_granule_channels)
from plumekit_torch.io.granule import Granule, save_granule  # noqa: E402
from plumekit_torch.models import build_model  # noqa: E402
from plumekit_torch.models.fused_forward import make_fused_apply  # noqa: E402
from plumekit_torch.models.kernels import fused_conv  # noqa: E402
from plumekit_torch.train.checkpoint import (  # noqa: E402
    save_model_config, save_weights)
from plumekit_torch.config.identify import RGIdentifyConfig  # noqa: E402
from plumekit_torch.geo.sinusoidal import (  # noqa: E402
    grid_from_extent, wgs84_to_sinusoidal)
from plumekit_torch.identify import pipeline, rg  # noqa: E402
from plumekit_torch.io.synthetic import (  # noqa: E402
    SyntheticSceneConfig, make_fire_table, make_scene, write_fire_csv)
from plumekit_torch.ops.kernels import ccl_sweep, label_counts  # noqa: E402

SEED = 0
DEV = torch.device("cuda")
ICFG = InferConfig()                  # tile 288, overlap 32, 64 tiles/batch
GRANULES, GRANULE_PX = 4, 2048
BATCH_GRANULES = 2                    # predict_model's default
# K6 vs plain: |got - ref| <= ATOL + RTOL * |ref|. Both round the conv1
# output and the result to bf16 from fp32 sums taken in another order, so a
# value may land one bf16 step (2^-7 relative) away; 2^-6 allows two.
ATOL = RTOL = 2.0 ** -6
# fused vs plain forward (bf16, BN folded vs not, 18 convs deep): the
# repo's own bound for the fused replay (tests/test_fused_forward.py:68-72)
LOGIT_RTOL, LOGIT_MIN_CORR = 5e-2, 0.999
PROB_ATOL = 5e-2                      # fused vs plain served probabilities

RG = RGIdentifyConfig()               # T = 20 thresholds 1.0 .. 0.05
THRESHOLDS = np.asarray(RG.thresholds, np.float32)
# the identify benchmark's scene (bench.py:267-271): 1200², 9 plumes
BENCH_SCENE = dict(size=1200, n_plumes=9, background_level=0.2,
                   background_noise=0.05, plume_amplitude=(0.6, 0.8),
                   plume_sigma_major=(9.0, 14.0),
                   plume_sigma_minor=(1.8, 2.6), fires_per_plume=(7, 9),
                   extra_fires=4)
FEATURE_GRANULES = 4
# at 8192² only this many plumes carry fires: locating a fire scans the
# whole lat/lon grid on the host (about a quarter second each there)
SWATH_FIRES = 64
# K1 and K3 are integer results: kernel and plain version must be equal.
# build_features on the card vs on the CPU: integer columns and masks
# exact; the in-plume AOD mean and sd are float32 sums taken in another
# order on the two devices, so rtol 1e-5
FLOAT_COLUMNS = ("plume_aod_mean", "plume_aod_sd")
FEATURE_RTOL = 1e-5


def block_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cmid, Cout, H) of the 2·depth + 1 double-conv blocks."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i)
           for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth)]
    dec = [(f[i + 1], f[i], f[i], tile >> i)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def plain_bf16_double_conv(x, w1, s1, b1, w2, s2, b2):
    """The same block as cuDNN bf16 convs in channels-last layout, as the
    plain forward runs them: the speed reference."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1)
    y = torch.relu(y * s1[:, None, None] + b1[:, None, None])
    y = F.conv2d(y, w2, padding=1)
    return torch.relu(y * s2[:, None, None] + b2[:, None, None]) \
        .permute(0, 2, 3, 1)


def check_kernel(rng, batch):
    """K6 vs its plain version at every block shape and an odd shape."""
    cases = [(cin, cmid, cout, h, h, batch) for cin, cmid, cout, h
             in block_shapes(UNetConfig(), ICFG.tile_size)]
    # odd H and W (ragged tiles), an unaligned Cin, both tile geometries
    cases += [(5, 32, 32, 37, 29, 3), (64, 256, 256, 29, 21, 3)]
    rows = []
    for cin, cmid, cout, h, w, b in cases:
        def bf(*shape, scale=1.0):
            a = rng.standard_normal(shape, dtype=np.float32) * scale
            return torch.from_numpy(a).to(DEV).to(torch.bfloat16)

        x = bf(b, h, w, cin)
        w1 = bf(3, 3, cin, cmid, scale=(2.0 / (9 * cin)) ** 0.5)
        w2 = bf(3, 3, cmid, cout, scale=(2.0 / (9 * cmid)) ** 0.5)
        s1 = torch.from_numpy(rng.uniform(0.5, 1.5, cmid).astype(np.float32)
                              ).to(DEV).bfloat16()
        s2 = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                              ).to(DEV).bfloat16()
        b1, b2 = bf(cmid, scale=0.1), bf(cout, scale=0.1)
        args = (x, w1, s1, b1, w2, s2, b2)
        got = fused_conv.fused_double_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
        ref = fused_conv.double_conv3x3_bn_relu_ref(*args)
        err = (got.float() - ref.float()).abs()
        bound = ATOL + RTOL * ref.float().abs()
        worst = float((err / bound).max())
        max_abs = float(err.max())
        row = {"cin": cin, "cmid": cmid, "cout": cout, "h": h, "w": w,
               "batch": b, "max_abs_err": max_abs, "err_over_bound": worst}
        if b == batch:
            pw1 = w1.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            pw2 = w2.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            row["ms"] = time_ms(
                lambda: fused_conv.fused_double_conv3x3_bn_relu(*args))
            row["plain_ms"] = time_ms(lambda: plain_bf16_double_conv(
                x, pw1, s1, b1, pw2, s2, b2))
            row["ref_fp32_ms"] = time_ms(
                lambda: fused_conv.double_conv3x3_bn_relu_ref(*args), reps=3)
            row["tflops"] = (2 * 9 * b * h * w * (cin * cmid + cmid * cout)
                             / row["ms"] / 1e9)
        rows.append(row)
        print(f"K6 {cin:>3}->{cmid:>3}->{cout:>3} {b:>3}x{h}x{w}: "
              f"max|err| {max_abs:.4g} (err/bound {worst:.3f})"
              + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s),"
                 f" plain cuDNN bf16 {row['plain_ms']:.3f} ms, fp32 ref "
                 f"{row['ref_fp32_ms']:.3f} ms" if "ms" in row else ""),
              flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del x, got, ref, err, bound, args
    return rows


def seeded_unet(generator):
    """UNetConfig() with seeded random weights at He scale and nontrivial
    BatchNorm parameters and running statistics."""
    model = build_model(UNetConfig(), generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(2.0 ** 0.5)
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                m.running_var.copy_(torch.rand(n, generator=generator) * 1.5
                                    + 0.5)
    return model.to(DEV).eval()


def synthetic_channels(rng, n):
    """n (H, W) float32 AOD planes: a smooth background, noise and a few
    Gaussian plumes."""
    yy, xx = np.mgrid[0:GRANULE_PX, 0:GRANULE_PX].astype(np.float32)
    out = []
    for _ in range(n):
        aod = (0.15 + 0.05 * np.sin(xx / 300.0 + rng.uniform(0, 6))
               + 0.02 * rng.standard_normal(xx.shape, dtype=np.float32))
        for _ in range(4):
            cy, cx = rng.uniform(0.1 * GRANULE_PX, 0.9 * GRANULE_PX, 2)
            sy, sx = rng.uniform(20, 120, 2)
            aod += rng.uniform(0.5, 2.0) * np.exp(
                -((yy - cy) ** 2 / (2 * sy**2) + (xx - cx) ** 2 / (2 * sx**2)))
        out.append(aod.astype(np.float32))
    return out


def check_forward(model, rng):
    """Fused vs plain forward on a 64-tile 288² batch; K6 launches once per
    block."""
    plane = synthetic_channels(rng, 1)[0]
    t = ICFG.tile_size
    starts = tile_grid(GRANULE_PX, t, t - ICFG.overlap)[:8]
    tiles = [plane[y:y + t, x:x + t] for y in starts for x in starts]
    x = np.stack([np.stack([p, np.zeros_like(p)], -1) for p in tiles])
    x = torch.from_numpy(x).to(DEV)
    fused = make_fused_apply(model.cfg)
    with torch.inference_mode():
        before = fused_conv.LAUNCHES
        got = fused(model, x)
        launches = fused_conv.LAUNCHES - before
        ref = model(x)
        fwd_ms = time_ms(lambda: fused(model, x))
        plain_ms = time_ms(lambda: model(x))
    if launches != 2 * model.cfg.depth + 1:
        raise AssertionError(f"fused forward launched K6 {launches} times")
    g, r = got.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    if not (np.isfinite(g).all() and got.shape == (len(tiles), t, t, 1)):
        raise AssertionError("fused forward: non-finite or misshapen logits")
    max_diff = float(np.abs(g - r).max())
    corr = float(np.corrcoef(g, r)[0, 1])
    scale = float(np.abs(r).max())
    print(f"forward {len(tiles)}x{t}^2: max|fused - plain| {max_diff:.4g} of max|logit|"
          f" {scale:.4g}, corr {corr:.6f}; fused {fwd_ms:.2f} ms, plain "
          f"{plain_ms:.2f} ms", flush=True)
    if not (max_diff <= LOGIT_RTOL * scale and corr > LOGIT_MIN_CORR):
        raise AssertionError("fused and plain forward disagree")
    return {"max_abs_diff": max_diff, "max_abs_logit": scale, "corr": corr,
            "fused_ms": fwd_ms, "plain_ms": plain_ms, "launches": launches}


def serve(root, fused: bool):
    argv = ["predict_model", "--root", root] + (["--fused"] if fused else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"predict_model {argv} exited {rc}")
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for i in range(GRANULES):
        with np.load(os.path.join(out, f"g{i}_pred.npz")) as d:
            probs, mask, th = d["probs"], d["mask"], float(d["threshold"])
        if probs.shape != (GRANULE_PX, GRANULE_PX) or \
                not np.isfinite(probs).all() or probs.min() < 0 or \
                probs.max() > 1:
            raise AssertionError(f"g{i}: bad probs {probs.shape}")
        if not np.array_equal(mask, probs > th):
            raise AssertionError(f"g{i}: mask != probs > threshold")
        preds[f"g{i}"] = probs
    return secs, preds


def serving_split(root, model, out_dir):
    """Seconds per layer of the fused serving loop, run as the CLI runs it
    (decode, upload, sliding inference, readback, write), each step
    synchronised so that it is timed on its own."""
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    paths = [os.path.join(maiac, f) for f in sorted(os.listdir(maiac))]
    infer = make_multi_granule_infer(make_fused_apply(model.cfg), ICFG)
    split = dict.fromkeys(["decode", "upload", "infer", "readback", "write"],
                          0.0)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out

    with torch.inference_mode():
        for i in range(0, len(paths), BATCH_GRANULES):
            group = [timed("decode", lambda p=p: decode_granule_channels(
                p, model.cfg.depth)) for p in paths[i:i + BATCH_GRANULES]]
            x = timed("upload", lambda: torch.from_numpy(
                np.stack([c for _, c, _ in group])).to(DEV))
            probs, _ = timed("infer", lambda: infer(model, x))
            probs = timed("readback", lambda: probs.cpu().numpy())
            for j, (name, _c, (h, w)) in enumerate(group):
                timed("write", lambda: cli._write_prediction(
                    out_dir, name, probs[j, :h, :w]))
    total = sum(split.values())
    print("fused serving split (s): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in split.items()),
        flush=True)
    return split


def main_path(model, rng, tmp):
    """predict_model over 4 granules of 2048², fused then plain, twice each
    in the order fused, plain, plain, fused."""
    root = os.path.join(tmp, "root")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    os.makedirs(maiac)
    lat, lon = np.meshgrid(np.linspace(30, 40, GRANULE_PX, dtype=np.float32),
                           np.linspace(-120, -110, GRANULE_PX,
                                       dtype=np.float32), indexing="ij")
    for i, aod in enumerate(synthetic_channels(rng, GRANULES)):
        save_granule(os.path.join(maiac, f"g{i}.npz"),
                     Granule({"2020001A": aod}, lat, lon, name=f"g{i}"))
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, model.cfg)
    save_weights(ckpt, model)

    # forwards per group, from the serving geometry itself
    stride = ICFG.tile_size - ICFG.overlap
    padded = ICFG.tile_size + -(-(GRANULE_PX - ICFG.tile_size) // stride) \
        * stride
    n_tiles = len(tile_grid(padded, ICFG.tile_size, stride)) ** 2
    per_group = -(-n_tiles // _effective_batch(ICFG.batch_tiles, n_tiles))
    forwards = -(-GRANULES // BATCH_GRANULES) * per_group
    mpix = GRANULES * GRANULE_PX**2 / 1e6

    fused_conv.LAUNCHES = 0
    fused_s, fused_preds = serve(root, fused=True)
    launches = fused_conv.LAUNCHES
    if launches != 9 * forwards or launches == 0:
        raise AssertionError(f"K6 launched {launches} times for {forwards} "
                             "forwards of 9 blocks")
    plain_s, plain_preds = serve(root, fused=False)
    plain_s2, _ = serve(root, fused=False)
    fused_s2, _ = serve(root, fused=True)

    max_dp, flips, confident_flips = 0.0, 0, 0
    for k in fused_preds:
        p, q = fused_preds[k], plain_preds[k]
        max_dp = max(max_dp, float(np.abs(p - q).max()))
        flip = (p > 0.5) != (q > 0.5)
        flips += int(flip.sum())
        confident_flips += int((flip & (np.abs(q - 0.5) > PROB_ATOL)).sum())
    share = flips / (GRANULES * GRANULE_PX**2)

    split_dir = os.path.join(tmp, "split")
    os.makedirs(split_dir)
    split = serving_split(root, model, split_dir)

    # the forwards alone, at the main path's batch (G granules x tiles)
    x = torch.rand((BATCH_GRANULES * n_tiles, ICFG.tile_size, ICFG.tile_size,
                    2), generator=torch.Generator().manual_seed(SEED)).to(DEV)
    fused = make_fused_apply(model.cfg)
    with torch.inference_mode():
        fused_fwd = time_ms(lambda: fused(model, x), reps=5)
        plain_fwd = time_ms(lambda: model(x), reps=5)
    res = {"granules": GRANULES, "granule_px": GRANULE_PX,
           "forwards": forwards, "k6_launches": launches,
           "fused_s": [fused_s, fused_s2], "plain_s": [plain_s, plain_s2],
           "fused_mpix_s": [mpix / fused_s, mpix / fused_s2],
           "plain_mpix_s": [mpix / plain_s, mpix / plain_s2],
           "fused_forward_ms": fused_fwd, "plain_forward_ms": plain_fwd,
           "fused_forward_mpix_s": mpix / (forwards * fused_fwd / 1e3),
           "plain_forward_mpix_s": mpix / (forwards * plain_fwd / 1e3),
           "max_abs_dprobs": max_dp, "mask_flip_share": share,
           "confident_flips": confident_flips, "fused_split_s": split}
    print(f"predict_model {GRANULES}x{GRANULE_PX}^2: K6 launches {launches} "
          f"({forwards} forwards x 9); whole call fused "
          f"{res['fused_mpix_s'][0]:.2f}/{res['fused_mpix_s'][1]:.2f} MPix/s,"
          f" plain {res['plain_mpix_s'][0]:.2f}/{res['plain_mpix_s'][1]:.2f} "
          f"MPix/s; forwards alone fused {res['fused_forward_mpix_s']:.1f}, "
          f"plain {res['plain_forward_mpix_s']:.1f} MPix/s; max|dprobs| "
          f"{max_dp:.4g}, mask flips {share:.3e} ({confident_flips} with "
          f"|p_plain - 0.5| > {PROB_ATOL})", flush=True)
    if max_dp > PROB_ATOL or confident_flips:
        raise AssertionError("fused and plain serving disagree")
    return res


# ------------------------------------------------------------- rg identify

def timed_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def device_scene(h, w, seed):
    """An (h, w) float32 AOD plane made on the card with the identify
    benchmark scene's statistics: smooth noise about 0.2 and, per 1200²,
    nine plumes (amplitude 0.6-0.8, sigmas 9-14 by 1.8-2.6 px) and three
    round background blobs. Returns the plane and the plume origins as
    (rows, cols)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    noise = torch.randn((1, 1, h, w), generator=gen, device=DEV)
    for _ in range(2):
        noise = F.avg_pool2d(noise, 9, stride=1, padding=4,
                             count_include_pad=False)
    noise = noise[0, 0]
    aod = torch.clamp(0.2 + 0.035 * noise / noise.std(), min=0.0)
    rng = np.random.default_rng(seed)
    rr = torch.arange(h, device=DEV, dtype=torch.float32)[:, None]
    cc = torch.arange(w, device=DEV, dtype=torch.float32)[None, :]

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


def serpentine(h, w, thick=3):
    """One component whose path reverses every band: ``thick``-px
    corridors that survive the opening, joined at alternating ends."""
    f = torch.full((h, w), 0.3, device=DEV)
    period = 2 * thick
    for top in range(0, h - thick + 1, period):
        f[top:top + thick] = 1.3
        if top + period < h:
            cols = slice(0, thick) if (top // period) % 2 == 0 \
                else slice(w - thick, w)
            f[top + thick:top + period, cols] = 1.3
    return f


def check_ccl(name, aod, thresholds, connectivity=2):
    """K1 vs its plain version (opening + connected_components per level):
    equal labels; kernel time over repeated launches, plain time of the
    comparison call. Returns the row and the kernel's labels."""
    th = torch.from_numpy(thresholds).to(DEV)
    got = ccl_sweep.multi_threshold_ccl_fused(aod, th, connectivity)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: ccl_sweep.multi_threshold_ccl_ref(aod, th, connectivity))
    equal = torch.equal(got, ref)
    wrong = 0 if equal else int((got != ref).sum())
    del ref
    t_count, h, w = got.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=DEV)
    components = [int((got[t].view(-1) == ids).sum()) for t in range(t_count)]
    fg = [float((got[t] > 0).float().mean()) for t in range(t_count)]
    big = h * w >= 4096**2
    ms = time_ms(lambda: ccl_sweep.multi_threshold_ccl_fused(
        aod, th, connectivity), reps=5 if big else 10)
    row = {"scene": name, "h": h, "w": w, "levels": t_count,
           "connectivity": connectivity, "equal": equal,
           "wrong_pixels": wrong, "ms": ms, "plain_ms": plain_ms,
           "gpix_levels_per_s": t_count * h * w / ms / 1e6,
           "components": components, "foreground_share": fg}
    print(f"K1 {name} {h}x{w} T={t_count} conn={connectivity}: "
          f"{'equal' if equal else f'{wrong} pixels differ'}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms; components per level "
          f"{components[0]}..{components[-1]}", flush=True)
    if not equal:
        raise AssertionError(f"K1 disagrees with its plain version on {name}")
    return row, got


def check_counts(name, labels, f_count, rng):
    """K3 vs its plain version on real labels, with the not-found 0, a
    duplicate and an absent label among the labs."""
    t_count, h, w = labels.shape
    idx = torch.from_numpy(rng.integers(0, h * w, (t_count, f_count))).to(DEV)
    labs = torch.gather(labels.view(t_count, -1), 1, idx)
    labs[:, 0] = 0
    if f_count > 2:
        labs[:, 1] = labs[:, 2]
        labs[:, -1] = h * w + 7
    labs = labs.contiguous()
    got = label_counts.fire_label_counts(labels, labs)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: label_counts.fire_label_counts_ref(labels, labs))
    err = int((got - ref).abs().max())
    ms = time_ms(lambda: label_counts.fire_label_counts(labels, labs))
    row = {"scene": name, "h": h, "w": w, "levels": t_count, "F": f_count,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "gb_per_s": labels.numel() * 4 / ms / 1e6}
    print(f"K3 {name} {h}x{w} T={t_count} F={f_count}: max|err| {err}; "
          f"kernel {ms:.3f} ms ({row['gb_per_s']:.0f} GB/s), plain "
          f"{plain_ms:.1f} ms", flush=True)
    if err:
        raise AssertionError(f"K3 disagrees with its plain version on {name}"
                             f" at F={f_count}")
    return row


def check_identify_kernels(rng):
    """K1 at the benchmark's 1200² scene, 4096², 8192², a ragged 1201 × 997
    scene (both connectivities) and a serpentine; K3 at the first three
    with F = 16, 64 and 128."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    scenes = [("bench_1200", torch.from_numpy(
        bench.granule.first_layer()).to(DEV))]
    scenes += [(f"synthetic_{n}", device_scene(n, n, SEED + n)[0])
               for n in (4096, 8192)]
    ccl_rows, count_rows = [], []
    for name, aod in scenes:
        row, labels = check_ccl(name, aod, THRESHOLDS)
        ccl_rows.append(row)
        for f_count in (16, 64, 128):
            count_rows.append(check_counts(name, labels, f_count, rng))
        del labels, aod
        torch.cuda.empty_cache()
    ragged = device_scene(1201, 997, SEED + 1)[0]
    for conn in (2, 1):
        ccl_rows.append(check_ccl("ragged", ragged, THRESHOLDS, conn)[0])
    ccl_rows.append(check_ccl("serpentine", serpentine(1024, 1024),
                              np.asarray([0.5, 0.25], np.float32))[0])
    torch.cuda.empty_cache()
    return ccl_rows, count_rows


def swath_scene(n):
    """An n² scene for rg.identify: the card-made AOD plane on the host,
    the MODIS sinusoidal lat/lon grid of make_scene at 1 km pixels, and a
    fire table with one fire at each of the first SWATH_FIRES plume
    origins."""
    aod, (rows, cols) = device_scene(n, n, SEED + 2 * n)
    xc, yc = wgs84_to_sinusoidal(-60.0, -10.0)
    half = n / 2.0 * 1000.0
    lat, lon = grid_from_extent(xc - half, yc + half, xc + half, yc - half,
                                n, n)
    rng = np.random.default_rng(SEED)
    rows = rows[:SWATH_FIRES].astype(int)
    cols = cols[:SWATH_FIRES].astype(int)
    fires = make_fire_table(lat, lon, rows, cols,
                            rng.uniform(20.0, 300.0, rows.size),
                            "2017-08-01", rng)
    return aod.cpu().numpy(), lat, lon, fires["date_time"][0], fires


def identify_split(scene, plain):
    """One rg.identify on the card, timed by phase: host fire prep
    (subset, clustering, location), K1, K3, the per-fire phase (the rest
    of the sweep: uploads, window lookups, threshold index, per-fire
    assessment, masks) and host post-processing (readback, hulls,
    tables). ``plain`` swaps the plain versions in for K1 and K3."""
    aod, lat, lon, date, fires = scene
    clock = dict.fromkeys(("host_prep", "k1", "k3", "host_post"), 0.0)

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run

    patches = {
        (pipeline, "multi_threshold_ccl_fused"): timed("k1", (
            ccl_sweep.multi_threshold_ccl_ref if plain
            else ccl_sweep.multi_threshold_ccl_fused)),
        (pipeline, "fire_label_counts"): timed("k3", (
            label_counts.fire_label_counts_ref if plain
            else label_counts.fire_label_counts)),
        (rg, "_prep_fires"): timed("host_prep", rg._prep_fires),
        (rg, "_to_host"): timed("host_post", rg._to_host),
        (rg, "_scene_results"): timed("host_post", rg._scene_results),
    }
    saved = {key: getattr(*key) for key in patches}
    try:
        for (mod, attr), fn in patches.items():
            setattr(mod, attr, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aod_table, hull_table, out = rg.identify(aod, lat, lon, date, fires,
                                                 RG, device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["per_fire"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, (aod_table.rows, hull_table.rows, out["plume_masks"],
                int(out["accepted"].shape[0]))


def same_result(a, b):
    """Equal identify results: table rows, then plume masks."""
    (at, ah, am, _), (bt, bh, bm, _) = a, b
    return at == bt and ah == bh and sorted(am) == sorted(bm) and all(
        np.array_equal(am[k], bm[k]) for k in am)


def sweep_split():
    """ms per scene of the rg sweep at 1200² (the benchmark scene) and
    8192², with the kernels and with the plain versions, in turns; the
    two must give the same tables and masks."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    g = bench.granule
    scenes = {"bench_1200": (g.first_layer(), g.lat, g.lon,
                             bench.fires["date_time"][0], bench.fires),
              "synthetic_8192": swath_scene(8192)}
    orders = {"bench_1200": (False, True, True, False),
              "synthetic_8192": (False, True, False)}
    res = {}
    for name, scene in scenes.items():
        runs = {"kernels": [], "plain": []}
        results = {}
        torch.cuda.reset_peak_memory_stats()
        for plain in orders[name]:
            ms, result = identify_split(scene, plain)
            runs["plain" if plain else "kernels"].append(ms)
            key = "plain" if plain else "kernels"
            if key in results and not same_result(results[key], result):
                raise AssertionError(f"{name}: {key} runs disagree")
            results[key] = result
            print(f"identify {name} ({'plain' if plain else 'kernels'}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + " ms", flush=True)
        if not same_result(results["kernels"], results["plain"]):
            raise AssertionError(f"{name}: kernels and plain versions give "
                                 "different tables or masks")
        kt, _kh, _km, f_cap = results["kernels"]
        if not kt:
            raise AssertionError(f"{name}: no plume accepted")
        res[name] = {"runs": runs, "plumes": len(kt), "fire_capacity": f_cap,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"identify {name}: {len(kt)} plumes, F = {f_cap}, peak "
              f"{res[name]['peak_gb']:.2f} GB", flush=True)
        del scene, results
        torch.cuda.empty_cache()
    return res


def read_features(root, base):
    """The build_features outputs of one granule: each CSV as a header and
    rows of strings, and the masks npz as a dict."""
    from plumekit_torch.config import PathsConfig

    paths = PathsConfig(root=root)
    out = {}
    for key, sub, suffix in (("aod", "aod_df_dir", "_aod.csv"),
                             ("extent", "hull_df_dir", "_extent.csv")):
        with open(os.path.join(paths.resolve(sub), base + suffix)) as f:
            out[key] = list(csv.reader(f))
    npz = os.path.join(paths.resolve("plume_mask_dir"), base + "_masks.npz")
    out["masks"] = {}
    if os.path.exists(npz):
        with np.load(npz) as d:
            out["masks"] = {k: d[k] for k in d.files}
    return out


def assert_features_equal(got, want, base):
    for key in ("aod", "extent"):
        g, w = got[key], want[key]
        if g[0] != w[0] or len(g) != len(w):
            raise AssertionError(f"{base} {key}: header or row count differ")
        for j, col in enumerate(w[0]):
            gc = np.asarray([float(r[j]) for r in g[1:]])
            wc = np.asarray([float(r[j]) for r in w[1:]])
            if col in FLOAT_COLUMNS:
                ok = np.allclose(gc, wc, rtol=FEATURE_RTOL, atol=0.0)
            else:
                ok = np.array_equal(gc, wc)
            if not ok:
                raise AssertionError(f"{base} {key}.{col}: card {gc} vs CPU "
                                     f"{wc}")
    gm, wm = got["masks"], want["masks"]
    if sorted(gm) != sorted(wm) or not all(np.array_equal(gm[k], wm[k])
                                           for k in wm):
        raise AssertionError(f"{base}: masks differ between card and CPU")


def features_path(tmp):
    """``build_features --detector rg`` over four synthetic 1200² granules
    and one fire table on the card: K1 and K3 must launch and plumes must
    be accepted; the first granule's CSVs and masks must equal a
    ``--device cpu`` run."""
    root = os.path.join(tmp, "features")
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires_dir = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires_dir)
    tables, names = [], []
    for seed in range(FEATURE_GRANULES):
        # granules 15° of longitude apart, so that each sees its own fires
        scene = make_scene(SyntheticSceneConfig(
            seed=SEED + seed, center_lon=-60.0 + 15.0 * seed, **BENCH_SCENE))
        save_granule(os.path.join(maiac, scene.granule.name + ".npz"),
                     scene.granule)
        tables.append(scene.fires)
        names.append(scene.granule.name)
    write_fire_csv(os.path.join(fires_dir, "fires.csv"),
                   {k: np.concatenate([t[k] for t in tables])
                    for k in tables[0]})
    cpu_root = os.path.join(tmp, "features_cpu")
    shutil.copytree(root, cpu_root, ignore=lambda d, files: [
        f for f in files if f.endswith(".npz") and f != names[0] + ".npz"])

    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["build_features", "--root", root, "--detector", "rg"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    if rc != 0:
        raise AssertionError(f"build_features exited {rc}")
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"build_features did not launch K1 and K3: "
                             f"{launches}")
    outputs = {n: read_features(root, n) for n in names}
    plumes = {n: len(o["aod"]) - 1 for n, o in outputs.items()}
    if not sum(plumes.values()):
        raise AssertionError("build_features accepted no plume")

    t0 = time.perf_counter()
    rc = cli.main(["build_features", "--root", cpu_root, "--detector", "rg",
                   "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"build_features --device cpu exited {rc}")
    assert_features_equal(outputs[names[0]], read_features(cpu_root, names[0]),
                          names[0])
    res = {"granules": FEATURE_GRANULES, "granule_px": BENCH_SCENE["size"],
           "seconds": secs, "s_per_granule": secs / FEATURE_GRANULES,
           "launches": launches, "plumes": plumes,
           "cpu_seconds_one_granule": cpu_s}
    print(f"build_features {FEATURE_GRANULES}x{BENCH_SCENE['size']}^2 on the "
          f"card: {secs:.2f} s ({secs / FEATURE_GRANULES:.3f} s/granule), "
          f"launches {launches}, plumes {plumes}; {names[0]} equals the "
          f"--device cpu run ({cpu_s:.2f} s)", flush=True)
    return res



def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    sources = ["fused_double_conv.cu", "ccl_sweep.cu", "label_counts.cu"]
    t0 = time.perf_counter()
    cuda_build.load_libraries(sources)
    build_s = time.perf_counter() - t0
    print(f"kernel builds + loads {build_s:.2f} s (one nvcc per source, "
          "side by side)")
    for source in sources:
        log = cuda_build.BUILD_LOG.get(source, {})
        print(f"{source}: nvcc {log.get('seconds', 0.0):.2f} s")
        for line in log.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                print(line)

    # serving: K6
    batch = BATCH_GRANULES * ICFG.batch_tiles
    kernel_rows = check_kernel(rng, batch)
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    forward = check_forward(model, rng)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        served = main_path(model, rng, tmp)
    del model
    torch.cuda.empty_cache()

    # the rg weak labeller: K1/K4 and K3
    ccl_rows, count_rows = check_identify_kernels(rng)
    sweeps = sweep_split()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        features = features_path(tmp)

    timed = [r for r in kernel_rows if "ms" in r]
    bench_ccl = next(r for r in ccl_rows if r["scene"] == "bench_1200")
    bench_counts = next(r for r in count_rows
                        if r["scene"] == "bench_1200" and r["F"] == 16)
    kernels = [{
        "name": "fused_double_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_double_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:180",
        "launches": served["k6_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed)}, {
        "name": "multi_threshold_ccl_fused", "route": "cuda",
        "source": "plumekit_torch/csrc/ccl_sweep.cu",
        "replaces": "plumekit/ops/pallas/ccl_sweep.py:544",
        "also_replaces": "plumekit/ops/pallas/ccl_banded.py:321 "
                         "(multi_threshold_ccl_banded, K4: the same kernel)",
        "launches": features["launches"]["k1"],
        "max_abs_err": max(r["wrong_pixels"] for r in ccl_rows),
        "ms": bench_ccl["ms"], "plain_ms": bench_ccl["plain_ms"],
        "at": "1200x1200, T=20"}, {
        "name": "fire_label_counts", "route": "cuda",
        "source": "plumekit_torch/csrc/label_counts.cu",
        "replaces": "plumekit/ops/pallas/label_counts.py:83",
        "launches": features["launches"]["k3"],
        "max_abs_err": max(r["max_abs_err"] for r in count_rows),
        "ms": bench_counts["ms"], "plain_ms": bench_counts["plain_ms"],
        "at": "1200x1200, T=20, F=16"}]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "build_s": build_s,
                   "builds": {k: v["seconds"]
                              for k, v in cuda_build.BUILD_LOG.items()},
                   "kernel_rows": kernel_rows, "forward": forward,
                   "serving": served, "ccl_rows": ccl_rows,
                   "count_rows": count_rows, "identify": sweeps,
                   "build_features": features, "kernels": kernels},
                  f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
