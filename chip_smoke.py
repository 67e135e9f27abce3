"""Smoke run of plumekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the hand-written CUDA kernels of ``plumekit_torch/csrc`` (one
``nvcc`` per source, all at once) and drives the port's four paths:

* megakernel serving: K7 (the whole U-Net forward in one launch) against
  its plain PyTorch version at the flagship U-Net over 128 tiles of 96²,
  one tile and a 64 × 48 depth-3 net, and against the cuDNN forward; then
  the four 2048² granules served through ``predict_model --tile 96
  --overlap 32`` from a checkpoint that says ``use_mega`` (K7 must launch
  once per forward and K6 not at all) and from one that does not; K5 (one
  fused conv) at the net's 18 conv shapes, timed on weights packed once,
  and at ragged and tiny planes for every tile geometry and image grouping
  the tile rule picks, and P1 (the gather probe, both forms) against their
  plain versions;
* serving: K6 (fused double conv) against its plain PyTorch version at
  every U-Net block shape of tile 288 and of tile 96 (timed on weights
  packed once, beside cuDNN, with the tile chosen, its fill and the bound
  per shape) and at ragged and tiny planes (one image, a batch that is no
  multiple of the images per block, planes smaller than a tile); two runs
  of K5 and of K6 must be equal bit for bit; the flagship U-Net (``UNetConfig()``: base 32,
  depth 4, bf16) through the fused and the plain forward, then four
  synthetic 2048² granules served end to end through ``predict_model
  --fused`` and through the plain forward;
* the rg weak labeller: K1/K4 (multi-threshold CCL) and K3 (label counts)
  against their plain versions, bit for bit, on the identify benchmark's
  1200² scene, 4096², 8192², a ragged 1201 × 997 scene and a serpentine,
  each timed with 20 launches per pair of CUDA events, K1 also pass by
  pass (local, border, finalize) at 1200² and 8192²; the rg sweep per
  scene at 1200² and 8192² with the kernels and with the plain versions,
  split by phase (K4's launches are K1's in the 8192² sweep); then
  ``build_features --detector rg``
  over four synthetic 1200² granules, one of which must equal a
  ``--device cpu`` run, and ``--batch-scenes 4`` over the same granules,
  which must equal the serial run;
* the basic and gaussian detectors: K2 (mask-stack CCL) against its plain
  version, bit for bit, on the bench scene's opened stack (where it must
  also equal K1 on the raw AOD), a ragged stack at both connectivities,
  independent masks, a fire raster, a serpentine, empty and full levels
  and basic's mask at 8192² (basic's two masks also pass by pass);
  ``basic.identify`` and
  ``gaussian.identify_granule`` at 1200² with the kernels and with the
  plain versions, split by phase; then ``build_features --detector basic``
  and ``--detector gaussian`` over four 1200² granules each, one of which
  must equal a ``--device cpu`` run.

Every kernel's time stands beside its bound: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
or its operations over the card's peak rate for their type, whichever is
larger, at the data sheet's rates and again at the copy rate measured in
this run. Any failed check raises; there is no CPU fallback. The last line
of standard output is ``{"ok": true, "device": {...}}``; the line before it
is the kernel table as JSON. Details also go to ``chip_smoke.json`` in the
output directory that :func:`main` makes.
"""

from __future__ import annotations

import csv
import dataclasses
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
from plumekit_torch.experiments import (  # noqa: E402
    ccl_pass_times, scalar_gather_probe)
from plumekit_torch.models.kernels import (  # noqa: E402
    conv_tiles, fused_conv, unet_mega)
from plumekit_torch.train.checkpoint import (  # noqa: E402
    save_model_config, save_weights)
from plumekit_torch.config.identify import (  # noqa: E402
    BasicIdentifyConfig, GaussianIdentifyConfig, RGIdentifyConfig)
from plumekit_torch.geo.sinusoidal import (  # noqa: E402
    grid_from_extent, wgs84_to_sinusoidal)
from plumekit_torch.identify import basic, gaussian, pipeline, rg  # noqa: E402
from plumekit_torch.io.synthetic import (  # noqa: E402
    SyntheticSceneConfig, make_fire_table, make_scene, write_fire_csv)
from plumekit_torch.ops.kernels import ccl_sweep, label_counts  # noqa: E402
from plumekit_torch.ops.morphology import binary_opening_cross  # noqa: E402

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
# megakernel serving: the tile the JAX package's megakernel admits at
# UNetConfig() (its larger tiles fall through to XLA there)
MEGA = InferConfig(tile_size=96, overlap=32)
# K7 vs its plain version: both round to bf16 at the same 22 points from
# fp32 sums taken in another order; a flipped rounding spreads through the
# convs after it, so 2% of the largest logit and correlation > 0.999.
# That bound alone would pass a kernel that rounded the last decoder block
# to bf16 before the head (the flips upstream move the logits more than
# that rounding does), so the kernel's distance to the plain version is also
# projected on what that rounding does to the plain version's logits: 0 for
# a head that reads fp32, 1 for one that reads the rounded block, apart from
# the flips' share, which falls with the square root of the logits' count
MEGA_RTOL = 2e-2
MEGA_HEAD_ROUNDING_SHARE = 0.25
PROBE_SIZE, PROBE_LOOKUPS = 1024, 1024   # the gather probe's defaults

RG = RGIdentifyConfig()               # T = 20 thresholds 1.0 .. 0.05
THRESHOLDS = np.asarray(RG.thresholds, np.float32)
# the identify benchmark's scene (bench.py:267-271): 1200², 9 plumes
BENCH_SCENE = ccl_pass_times.BENCH_SCENE
# K1, K2 and K3 are timed with this many launches per pair of CUDA events,
# so that the wrapper's host time per call stays out of the reading
QUEUED = ccl_pass_times.QUEUED
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
BASIC = BasicIdentifyConfig()         # one mask at AOD >= 0.2, win_half 10
GAUSS = GaussianIdentifyConfig()      # 3 sets of 25 thresholds, 64 raw fires
# the basic detector's scenes: the bench scene over a clean background
# (tests/test_identify_basic_parity.py's statistics), since its one mask at
# AOD >= 0.2 percolates over the bench scene's background of 0.2
BASIC_SCENE = ccl_pass_times.BASIC_SCENE
# the gaussian scenes: the bench scene with two orbit layers, null blobs
# and 7-9 fires at every plume (over the detector's 20-fire gate)
GAUSS_SCENE = dict(BENCH_SCENE, n_layers=2, null_blobs=3)
# the data sheet's rates of an H100 SXM at its 700 W limit: device memory,
# dense bf16 in the tensor cores, 32-bit arithmetic outside them (taken
# for K3's integer compares too)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_32BIT_OPS_PER_S = 67e12


def bound(n_bytes, n_ops=0, ops_per_s=PEAK_32BIT_OPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` or to do ``n_ops`` operations, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def measured_copy_rate():
    """Bytes per second of a 1 GiB device-to-device copy (read plus
    write): the memory rate this card reaches in this run."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device=DEV)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src))
    return 2 * src.numel() / (ms / 1e3)


def block_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cmid, Cout, H) of the 2·depth + 1 double-conv blocks."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i)
           for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth)]
    dec = [(f[i + 1], f[i], f[i], tile >> i)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


def time_ms(fn, reps=10, warmup=2, calls=1):
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls, each
    around ``calls`` calls of ``fn`` and divided by them (with many, the
    launches queue up and the host's time per call stays out)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def plain_bf16_double_conv(x, w1, s1, b1, w2, s2, b2):
    """The same block as cuDNN bf16 convs in channels-last layout, as the
    plain forward runs them: the speed reference."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1)
    y = torch.relu(y * s1[:, None, None] + b1[:, None, None])
    y = F.conv2d(y, w2, padding=1)
    return torch.relu(y * s2[:, None, None] + b2[:, None, None]) \
        .permute(0, 2, 3, 1)


def tile_of(tile):
    """What the kernel table says of a tile the rule picked."""
    return {"path": tile.path, "tile": [tile.th, tile.tw, tile.images],
            "fill": tile.fill, "smem": tile.smem}


def check_kernel(rng, batch):
    """K6 vs its plain version at every block shape of the serving tile
    (288) and of the megakernel's tile (96), timed on weights packed once
    beside cuDNN, and at ragged and tiny planes for every tile geometry and
    image grouping the rule picks: one image, a batch that is no multiple of
    the group, planes smaller than a tile, unaligned and odd channels. Two
    runs of the kernel must be equal bit for bit."""
    cases = [(cin, cmid, cout, h, h, batch, str(tile))
             for tile in (ICFG.tile_size, MEGA.tile_size)
             for cin, cmid, cout, h in block_shapes(UNetConfig(), tile)]
    cases += [(5, 32, 32, 37, 29, 3, "ragged"),        # mma.sync, ragged
              (64, 256, 256, 29, 21, 3, "ragged"),     # wgmma, ragged tiles
              (5, 200, 40, 37, 29, 2, "ragged"),
              (2, 512, 130, 6, 6, 3, "ragged"),        # 2 images a block, B=3
              (512, 512, 37, 3, 5, 1, "ragged"),       # 4 a block, B=1, odd
              (64, 128, 128, 18, 18, 1, "ragged")]
    rows = []
    for cin, cmid, cout, h, w, b, kind in cases:
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
        packed = fused_conv.pack_double_conv(*args[1:])
        if not torch.equal(
                fused_conv.fused_double_conv3x3_bn_relu_packed(x, packed),
                got):
            raise AssertionError("K6: two runs differ")
        ref = fused_conv.double_conv3x3_bn_relu_ref(*args)
        err = (got.float() - ref.float()).abs()
        tol = ATOL + RTOL * ref.float().abs()
        worst = float((err / tol).max())
        max_abs = float(err.max())
        tile = conv_tiles.double_conv_tile(h, w, cin, cmid, cout)
        row = {"cin": cin, "cmid": cmid, "cout": cout, "h": h, "w": w,
               "batch": b, "set": kind, "max_abs_err": max_abs,
               "err_over_bound": worst, **tile_of(tile)}
        if b == batch:
            pw1 = w1.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            pw2 = w2.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            # the kernel alone: weights packed once, as the fused forward
            # holds them; beside it the raw-weight entry, which packs per call
            row["ms"] = time_ms(
                lambda: fused_conv.fused_double_conv3x3_bn_relu_packed(
                    x, packed))
            row["wrapper_ms"] = time_ms(
                lambda: fused_conv.fused_double_conv3x3_bn_relu(*args))
            row["plain_ms"] = time_ms(lambda: plain_bf16_double_conv(
                x, pw1, s1, b1, pw2, s2, b2))
            row["ref_fp32_ms"] = time_ms(
                lambda: fused_conv.double_conv3x3_bn_relu_ref(*args), reps=3)
            row["ops"] = 2 * 9 * b * h * w * (cin * cmid + cmid * cout)
            row["bytes"] = sum(a.numel() * a.element_size() for a in args) \
                + got.numel() * got.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                row["bytes"], row["ops"], PEAK_BF16_OPS_PER_S)
            row["tflops"] = row["ops"] / row["ms"] / 1e9
        rows.append(row)
        print(f"K6 {cin:>3}->{cmid:>3}->{cout:>3} {b:>3}x{h}x{w} "
              f"[{tile.path} {tile.th}x{tile.tw}x{tile.images}, fill "
              f"{tile.fill:.2f}]: max|err| {max_abs:.4g} (err/bound "
              f"{worst:.3f})"
              + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s; "
                 f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; with "
                 f"packing {row['wrapper_ms']:.3f}), cuDNN bf16 "
                 f"{row['plain_ms']:.3f} ms, fp32 ref "
                 f"{row['ref_fp32_ms']:.3f} ms" if "ms" in row else ""),
              flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del x, got, ref, err, tol, args, packed
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


def serve(root, *flags):
    argv = ["predict_model", "--root", root, *flags]
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


def serving_split(root, model, out_dir, apply_fn, icfg, label):
    """Seconds per layer of the serving loop of one forward, run as the CLI
    runs it (decode, upload, sliding inference, readback, write), each step
    synchronised so that it is timed on its own."""
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    paths = [os.path.join(maiac, f) for f in sorted(os.listdir(maiac))]
    infer = make_multi_granule_infer(apply_fn, icfg)
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
    print(f"{label} serving split (s): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in split.items()),
        flush=True)
    return split


def serving_root(model, rng, tmp):
    """A root of 4 synthetic 2048² granules and the model's checkpoint."""
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
    return root


def serving_geometry(icfg):
    """(tiles per granule, forwards of one call), from the serving geometry
    itself."""
    stride = icfg.tile_size - icfg.overlap
    padded = icfg.tile_size + -(-(GRANULE_PX - icfg.tile_size) // stride) \
        * stride
    n_tiles = len(tile_grid(padded, icfg.tile_size, stride)) ** 2
    per_group = -(-n_tiles // _effective_batch(icfg.batch_tiles, n_tiles))
    return n_tiles, -(-GRANULES // BATCH_GRANULES) * per_group


def compare_served(got, want):
    """(max |dp|, share of mask flips, flips where the second is sure)."""
    max_dp, flips, confident_flips = 0.0, 0, 0
    for k in got:
        p, q = got[k], want[k]
        max_dp = max(max_dp, float(np.abs(p - q).max()))
        flip = (p > 0.5) != (q > 0.5)
        flips += int(flip.sum())
        confident_flips += int((flip & (np.abs(q - 0.5) > PROB_ATOL)).sum())
    return max_dp, flips / (GRANULES * GRANULE_PX**2), confident_flips


def main_path(model, root, tmp):
    """predict_model over 4 granules of 2048², fused then plain, twice each
    in the order fused, plain, plain, fused."""
    n_tiles, forwards = serving_geometry(ICFG)
    mpix = GRANULES * GRANULE_PX**2 / 1e6

    fused_conv.LAUNCHES = 0
    fused_s, fused_preds = serve(root, "--fused")
    launches = fused_conv.LAUNCHES
    if launches != 9 * forwards or launches == 0:
        raise AssertionError(f"K6 launched {launches} times for {forwards} "
                             "forwards of 9 blocks")
    plain_s, plain_preds = serve(root)
    plain_s2, _ = serve(root)
    fused_s2, _ = serve(root, "--fused")

    max_dp, share, confident_flips = compare_served(fused_preds, plain_preds)

    split_dir = os.path.join(tmp, "split")
    os.makedirs(split_dir)
    split = serving_split(root, model, split_dir, make_fused_apply(model.cfg),
                          ICFG, "fused")

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


# --------------------------------------------- megakernel serving: K7, K5, P1

def conv_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cout, H) of the 2·(2·depth + 1) single convs of the net."""
    return [shape for cin, cmid, cout, h in block_shapes(cfg, tile)
            for shape in ((cin, cmid, h), (cmid, cout, h))]


def check_single_conv(rng, batch):
    """K5 vs its plain version at every conv shape of the flagship net at
    the megakernel tile, timed on weights packed once beside one cuDNN bf16
    convolution with scale, shift and ReLU, and at ragged and tiny planes
    for every tile geometry and image grouping the rule picks. Two runs of
    the kernel must be equal bit for bit."""
    cases = [(cin, cout, h, h, batch)
             for cin, cout, h in conv_shapes(UNetConfig(), MEGA.tile_size)]
    cases += [(5, 40, 37, 29, 3),           # mma.sync, ragged
              (64, 96, 21, 29, 3),          # wgmma, ragged tiles
              (512, 512, 6, 6, 3),          # 4 images a block, B = 3
              (2, 129, 3, 5, 1),            # 7 a block, B = 1, odd Cout
              (256, 200, 18, 18, 5)]
    rows = []
    launches = 0
    for cin, cout, h, w, b in cases:
        def bf(*shape, scale=1.0):
            a = rng.standard_normal(shape, dtype=np.float32) * scale
            return torch.from_numpy(a).to(DEV).to(torch.bfloat16)

        x = bf(b, h, w, cin)
        wt = bf(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        sc = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)
                              ).to(DEV).bfloat16()
        sh = bf(cout, scale=0.1)
        args = (x, wt, sc, sh)
        before = fused_conv.SINGLE_LAUNCHES
        got = fused_conv.fused_conv3x3_bn_relu(*args)
        torch.cuda.synchronize()
        # one launch per call of the entry; the net's shapes are counted
        if fused_conv.SINGLE_LAUNCHES != before + 1:
            raise AssertionError("K5: not one launch per call")
        launches += b == batch
        packed = fused_conv.pack_single_conv(wt, sc, sh)
        if not torch.equal(fused_conv.fused_conv3x3_bn_relu_packed(x, packed),
                           got):
            raise AssertionError("K5: two runs differ")
        ref = fused_conv.conv3x3_bn_relu_ref(*args)
        err = (got.float() - ref.float()).abs()
        tol = ATOL + RTOL * ref.float().abs()
        worst = float((err / tol).max())
        tile = conv_tiles.single_conv_tile(h, w, cin, cout)
        row = {"cin": cin, "cout": cout, "h": h, "w": w, "batch": b,
               "max_abs_err": float(err.max()), "err_over_bound": worst,
               **tile_of(tile)}
        if b == batch:
            pw = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library():
                y = F.conv2d(x.permute(0, 3, 1, 2), pw, padding=1)
                return torch.relu(y * sc[:, None, None] + sh[:, None, None])

            row["ms"] = time_ms(
                lambda: fused_conv.fused_conv3x3_bn_relu_packed(x, packed))
            row["wrapper_ms"] = time_ms(
                lambda: fused_conv.fused_conv3x3_bn_relu(*args))
            row["library_ms"] = time_ms(library)
            row["plain_ms"] = time_ms(
                lambda: fused_conv.conv3x3_bn_relu_ref(*args), reps=3)
            row["ops"] = 2 * 9 * b * h * w * cin * cout
            row["bytes"] = sum(a.numel() * a.element_size() for a in args) \
                + got.numel() * got.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                row["bytes"], row["ops"], PEAK_BF16_OPS_PER_S)
            row["tflops"] = row["ops"] / row["ms"] / 1e9
        rows.append(row)
        print(f"K5 {cin:>3}->{cout:>3} {b:>3}x{h}x{w} [{tile.path} "
              f"{tile.th}x{tile.tw}x{tile.images}, fill {tile.fill:.2f}]: "
              f"max|err| {row['max_abs_err']:.4g} (err/bound {worst:.3f})"
              + (f", kernel {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s;"
                 f" bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
                 f"with packing {row['wrapper_ms']:.3f}), "
                 f"cuDNN bf16 {row['library_ms']:.3f} ms, fp32 ref "
                 f"{row['plain_ms']:.3f} ms" if "ms" in row else ""),
              flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{row}: tolerance {ATOL} + {RTOL}*|ref|")
        del x, got, ref, err, tol, args, packed
    return rows, launches


def mega_tiles(rng, n, tile):
    """n (tile, tile, 2) model inputs cut from a synthetic granule on the
    serving stride: AOD and an empty fire channel."""
    plane = synthetic_channels(rng, 1)[0]
    starts = tile_grid(GRANULE_PX, tile, tile - MEGA.overlap)
    side = int(math.ceil(n ** 0.5))
    tiles = [plane[y:y + tile, x:x + tile]
             for y in starts[:side] for x in starts[:side]]
    tiles = (tiles * -(-n // len(tiles)))[:n]     # a coarse grid repeats
    return torch.from_numpy(np.stack(
        [np.stack([p, np.zeros_like(p)], -1) for p in tiles])).to(DEV)


def compare_logits(name, got, ref, rtol):
    g, r = got.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    if not (np.isfinite(g).all() and got.shape == ref.shape):
        raise AssertionError(f"{name}: non-finite or misshapen logits")
    max_diff, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
    corr = float(np.corrcoef(g, r)[0, 1])
    if not (max_diff <= rtol * scale and corr > LOGIT_MIN_CORR):
        raise AssertionError(
            f"{name}: max|diff| {max_diff:.4g} of max|logit| {scale:.4g} "
            f"(allowed {rtol}), corr {corr:.6f}")
    return {"max_abs_diff": max_diff, "max_abs_logit": scale, "corr": corr}


def check_mega(model, rng, batch):
    """K7 vs its plain version and vs the cuDNN forward: the flagship net
    over the main path's batch of 96² tiles and over one tile, the same net
    with the weights of three other seeds over 8 tiles, and a base-8 depth-3
    net over 64 × 48 inputs; timed at the main path's batch beside
    the cuDNN and the K6 forward, and at 288² tiles."""
    apply = unet_mega.make_mega_apply(model.cfg)
    fused = make_fused_apply(model.cfg)
    x = mega_tiles(rng, batch, MEGA.tile_size)
    small_cfg = UNetConfig(base_features=8, depth=3)
    small = build_model(small_cfg, torch.Generator().manual_seed(SEED + 1)
                        ).to(DEV).eval()
    t = MEGA.tile_size
    cases = [(f"{batch}x{t}^2", model, apply, x),
             (f"1x{t}^2", model, apply, x[:1]),
             *[(f"8x{t}^2, weights of seed {seed}",
                seeded_unet(torch.Generator().manual_seed(seed)), apply, x[:8])
               for seed in (SEED + 2, SEED + 3, SEED + 4)],
             ("2x64x48 base 8 depth 3", small,
              unet_mega.make_mega_apply(small_cfg), torch.from_numpy(
                  rng.standard_normal((2, 64, 48, 2), dtype=np.float32)
              ).to(DEV))]
    res = {"cases": {}}
    with torch.inference_mode():
        for name, net, fn, inp in cases:
            before = unet_mega.LAUNCHES
            got = fn(net, inp)
            torch.cuda.synchronize()
            if unet_mega.LAUNCHES != before + 1:
                raise AssertionError(f"K7 {name}: not one launch per forward")
            weights = unet_mega.weights_of(net, torch.bfloat16, DEV)
            ref = unet_mega.mega_forward_ref(weights.folded, inp)
            row = compare_logits(f"K7 vs plain version, {name}", got, ref,
                                 MEGA_RTOL)
            rounding = unet_mega.mega_forward_ref(
                weights.folded, inp, head_in_f32=False) - ref
            row["mean_abs_diff"] = float((got - ref).abs().mean())
            row["head_rounding_share"] = float(
                ((got - ref) * rounding).sum() / (rounding * rounding).sum())
            if not abs(row["head_rounding_share"]) <= MEGA_HEAD_ROUNDING_SHARE:
                raise AssertionError(
                    f"K7 {name}: {row['head_rounding_share']:.3f} of the "
                    "last block's rounding to bf16 shows in the logits: the "
                    "kernel's head does not read fp32")
            row["vs_cudnn_forward"] = compare_logits(
                f"K7 vs cuDNN forward, {name}", got, net(inp), LOGIT_RTOL)
            res["cases"][name] = row
            print(f"K7 {name}: max|K7 - plain version| "
                  f"{row['max_abs_diff']:.4g} of max|logit| "
                  f"{row['max_abs_logit']:.4g}, corr {row['corr']:.6f}, "
                  f"mean {row['mean_abs_diff']:.4g}, share of the last "
                  f"block's rounding {row['head_rounding_share']:.4f}; vs "
                  f"cuDNN forward {row['vs_cudnn_forward']['max_abs_diff']:.4g}",
                  flush=True)
            del got, ref, rounding
        weights = unet_mega.weights_of(model, torch.bfloat16, DEV)
        torch.cuda.reset_peak_memory_stats()
        res["ms"] = time_ms(lambda: apply(model, x))
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["cudnn_forward_ms"] = time_ms(lambda: model(x))
        res["k6_forward_ms"] = time_ms(lambda: fused(model, x))
        res["ms_again"] = time_ms(lambda: apply(model, x))
        res["plain_ms"] = time_ms(
            lambda: unet_mega.mega_forward_ref(weights.folded, x), reps=2,
            warmup=1)
        # the default serving tile, which the TPU's megakernel does not admit
        big = mega_tiles(rng, batch, ICFG.tile_size)
        res["ms_288"] = time_ms(lambda: apply(model, big), reps=3, warmup=1)
        res["cudnn_forward_ms_288"] = time_ms(lambda: model(big), reps=3,
                                              warmup=1)
        res["vs_cudnn_forward_288"] = compare_logits(
            "K7 vs cuDNN forward, 288^2", apply(model, big), model(big),
            LOGIT_RTOL)
        del big
    _plan, scratch_elems = unet_mega._plan(weights.stages, *x.shape[:3])
    res["scratch_bytes"] = 2 * scratch_elems
    res["weight_bytes"] = weights.blob.numel()
    res["stages"] = len(weights.stages)
    # per tile: every conv, transposed conv and the head, 2 flops per MAC
    cfg = model.cfg
    ops = sum(2 * 9 * h * h * (cin * cmid + cmid * cout)
              for cin, cmid, cout, h in block_shapes(cfg, t))
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    ops += sum(2 * (t >> (i + 1)) ** 2 * f[i + 1] * 4 * f[i]
               for i in range(cfg.depth))
    ops += 2 * t * t * f[0] * cfg.out_channels
    res["ops"] = ops * batch
    # compulsory bytes: the input and the logits once, the weights once
    res["bytes"] = x.numel() * 2 + batch * t * t * cfg.out_channels * 4 \
        + res["weight_bytes"]
    res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["ops"],
                                             PEAK_BF16_OPS_PER_S)
    res["tflops"] = res["ops"] / res["ms"] / 1e9
    print(f"K7 forward {batch}x{t}^2: {res['ms']:.3f} / {res['ms_again']:.3f} "
          f"ms ({res['tflops']:.1f} TFLOP/s; bound {res['bound_ms']:.4f} ms by"
          f" {res['bound_by']}), cuDNN forward {res['cudnn_forward_ms']:.3f} "
          f"ms, K6 forward {res['k6_forward_ms']:.3f} ms, plain version "
          f"{res['plain_ms']:.1f} ms; scratch "
          f"{res['scratch_bytes'] / 1e6:.1f} MB, weights "
          f"{res['weight_bytes'] / 1e6:.1f} MB, peak {res['peak_gb']:.2f} GB;"
          f" at {batch}x288^2 K7 {res['ms_288']:.2f} ms, cuDNN forward "
          f"{res['cudnn_forward_ms_288']:.2f} ms", flush=True)
    return res


def mega_path(model, root, tmp, forward_ms):
    """The slice's path: ``predict_model --tile 96 --overlap 32
    --batch-granules 2`` over the 4 granules of 2048² from a checkpoint
    whose config says ``use_mega`` (every forward one launch of K7, K6
    never) and from the same weights without the flag (cuDNN), in the order
    mega, plain, plain, mega."""
    mega_ckpt = os.path.join(tmp, "mega_checkpoint")
    mega_cfg = dataclasses.replace(model.cfg, use_mega=True)
    save_model_config(mega_ckpt, mega_cfg)
    save_weights(mega_ckpt, model)
    flags = ["--tile", str(MEGA.tile_size), "--overlap", str(MEGA.overlap),
             "--batch-granules", str(BATCH_GRANULES)]
    n_tiles, forwards = serving_geometry(MEGA)
    mpix = GRANULES * GRANULE_PX**2 / 1e6

    unet_mega.LAUNCHES = fused_conv.LAUNCHES = 0
    mega_s, mega_preds = serve(root, *flags, "--checkpoint", mega_ckpt)
    launches = {"k7": unet_mega.LAUNCHES, "k6": fused_conv.LAUNCHES}
    if launches["k7"] != forwards or launches["k7"] == 0 or launches["k6"]:
        raise AssertionError(f"megakernel serving launched {launches} for "
                             f"{forwards} forwards")
    plain_s, plain_preds = serve(root, *flags)
    plain_s2, _ = serve(root, *flags)
    mega_s2, _ = serve(root, *flags, "--checkpoint", mega_ckpt)
    if unet_mega.LAUNCHES != 2 * forwards:
        raise AssertionError("the plain serving runs launched K7")
    max_dp, share, confident_flips = compare_served(mega_preds, plain_preds)

    split_dir = os.path.join(tmp, "mega_split")
    os.makedirs(split_dir)
    mega_model = build_model(mega_cfg).to(DEV).eval()
    mega_model.load_state_dict(model.state_dict())
    split = serving_split(root, mega_model, split_dir,
                          lambda m, x: m(x), MEGA, "megakernel")
    res = {"granules": GRANULES, "granule_px": GRANULE_PX,
           "tile": MEGA.tile_size, "overlap": MEGA.overlap,
           "tiles_per_granule": n_tiles, "forwards": forwards,
           "launches": launches,
           "mega_s": [mega_s, mega_s2], "plain_s": [plain_s, plain_s2],
           "mega_mpix_s": [mpix / mega_s, mpix / mega_s2],
           "plain_mpix_s": [mpix / plain_s, mpix / plain_s2],
           "forward_mpix_s": {k: mpix / (forwards * v / 1e3)
                              for k, v in forward_ms.items()},
           "max_abs_dprobs": max_dp, "mask_flip_share": share,
           "confident_flips": confident_flips, "mega_split_s": split}
    print(f"predict_model --tile {MEGA.tile_size} --overlap {MEGA.overlap} "
          f"{GRANULES}x{GRANULE_PX}^2: K7 launches {launches['k7']} "
          f"({forwards} forwards of {BATCH_GRANULES * MEGA.batch_tiles} tiles),"
          f" K6 launches {launches['k6']}; whole call use_mega "
          f"{res['mega_mpix_s'][0]:.2f}/{res['mega_mpix_s'][1]:.2f} MPix/s, "
          f"plain {res['plain_mpix_s'][0]:.2f}/{res['plain_mpix_s'][1]:.2f} "
          "MPix/s; forwards alone "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["forward_mpix_s"].items())
          + f" MPix/s; max|dprobs| {max_dp:.4g}, mask flips {share:.3e} "
          f"({confident_flips} with |p_plain - 0.5| > {PROB_ATOL})",
          flush=True)
    if max_dp > PROB_ATOL or confident_flips:
        raise AssertionError("megakernel and plain serving disagree")
    return res


def check_probe():
    """P1: both forms of the kernel equal to the probe's loop and to the
    plain version, then the probe's own entry point; ns per lookup."""
    h = w = PROBE_SIZE
    n = PROBE_LOOKUPS
    x_np = np.random.default_rng(SEED).integers(0, h * w, (h, w)) \
        .astype(np.int32)
    x = torch.from_numpy(x_np).to(DEV)
    want = scalar_gather_probe.numpy_loop(x_np, n)
    ref, plain_ms = timed_once(
        lambda: scalar_gather_probe.gather_probe_ref(x, n))
    wrong = int((ref.cpu().numpy() != want).sum())
    for chained in (True, False):
        got = scalar_gather_probe.gather_probe(x, n, chained)
        torch.cuda.synchronize()
        wrong += int((got != ref).sum())
    if wrong:
        raise AssertionError(f"P1: {wrong} positions differ from the loop")
    res = {"h": h, "w": w, "lookups": n, "wrong": wrong,
           "plain_ms": time_ms(
               lambda: scalar_gather_probe.gather_probe_ref(x, n)),
           "ms": time_ms(lambda: scalar_gather_probe.gather_probe(x, n)),
           "chained_lookups_ms": scalar_gather_probe.time_lookups(x, n, True),
           "parallel_lookups_ms": scalar_gather_probe.time_lookups(x, n,
                                                                    False)}
    res["chained_ns_per_lookup"] = res["chained_lookups_ms"] / n * 1e6
    res["parallel_ns_per_lookup"] = res["parallel_lookups_ms"] / n * 1e6
    # the plane read and written once, and per lookup two reads and a write
    res["bound_ms"], res["bound_by"] = bound(4 * (2 * h * w + 3 * n))
    # the probe as its user runs it
    scalar_gather_probe.CHAINED_LAUNCHES = 0
    scalar_gather_probe.PARALLEL_LAUNCHES = 0
    if scalar_gather_probe.main([]) != 0:
        raise AssertionError("the gather probe's entry point failed")
    res["launches"] = scalar_gather_probe.CHAINED_LAUNCHES \
        + scalar_gather_probe.PARALLEL_LAUNCHES
    if not (scalar_gather_probe.CHAINED_LAUNCHES
            and scalar_gather_probe.PARALLEL_LAUNCHES):
        raise AssertionError("the gather probe did not launch both forms")
    print(f"P1 {h}x{w}, {n} lookups: exact in both forms; chained "
          f"{res['chained_ns_per_lookup']:.1f} ns per lookup, parallel "
          f"{res['parallel_ns_per_lookup']:.2f} ns per lookup "
          f"({res['parallel_lookups_ms']:.4f} ms, a launch); whole probe "
          f"{res['ms']:.4f} ms (bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}), plain {res['plain_ms']:.4f} ms", flush=True)
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
    """An (h, w) AOD plane made on the card with the identify benchmark
    scene's statistics, and its plume origins (``ccl_pass_times``)."""
    return ccl_pass_times.device_scene(h, w, seed, DEV)


def serpentine(h, w, thick=3):
    return ccl_pass_times.serpentine(h, w, DEV, thick)


def pass_split(name, prefix, reps):
    """The queued ms of each of the three CCL passes (``prefix(n)``
    launches the first n), printed; launches made here are not counted."""
    split = ccl_pass_times.pass_split(prefix, reps)
    print(f"{name} per pass: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + " ms", flush=True)
    return split


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
        aod, th, connectivity), reps=5 if big else 10, calls=QUEUED)
    bound_ms, bound_by = bound(4 * (aod.numel() + t_count + got.numel()))
    row = {"scene": name, "h": h, "w": w, "levels": t_count,
           "connectivity": connectivity, "equal": equal,
           "wrong_pixels": wrong, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gpix_levels_per_s": t_count * h * w / ms / 1e6,
           "components": components, "foreground_share": fg}
    if name in ("bench_1200", "synthetic_8192"):
        out = torch.empty_like(got)
        row["passes"] = pass_split(f"K1 {name}", lambda n: (
            ccl_pass_times.sweep_prefix(aod, th, out, connectivity, n)),
            3 if big else 5)
        del out
    print(f"K1 {name} {h}x{w} T={t_count} conn={connectivity}: "
          f"{'equal' if equal else f'{wrong} pixels differ'}; kernel "
          f"{ms:.3f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.1f} ms; components per level "
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
    ms = time_ms(lambda: label_counts.fire_label_counts(labels, labs),
                 calls=QUEUED)
    # one compare per pixel, level and lab; labels and labs in, counts out
    bound_ms, bound_by = bound(4 * (labels.numel() + 2 * labs.numel()),
                               labels.numel() * f_count)
    row = {"scene": name, "h": h, "w": w, "levels": t_count, "F": f_count,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gb_per_s": labels.numel() * 4 / ms / 1e6}
    print(f"K3 {name} {h}x{w} T={t_count} F={f_count}: max|err| {err}; "
          f"kernel {ms:.3f} ms ({row['gb_per_s']:.0f} GB/s; bound "
          f"{bound_ms:.4f} ms by {bound_by}), plain {plain_ms:.1f} ms",
          flush=True)
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


class Patched:
    """Swap module attributes for the length of a ``with`` block."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.saved = {key: getattr(*key) for key in self.patches}
        for (mod, attr), fn in self.patches.items():
            setattr(mod, attr, fn)

    def __exit__(self, *exc):
        for (mod, attr), fn in self.saved.items():
            setattr(mod, attr, fn)


def phase_clock(keys):
    """(clock, timed): ``timed(key, fn)`` wraps ``fn`` so that each call,
    synchronised on both sides, adds its seconds to ``clock[key]``."""
    clock = dict.fromkeys(keys, 0.0)

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            clock[key] += time.perf_counter() - t0
            return out
        return run
    return clock, timed


def identify_split(scene, plain):
    """One rg.identify on the card, timed by phase: host fire prep
    (subset, clustering, location), K1, K3, the per-fire phase (the rest
    of the sweep: uploads, window lookups, threshold index, per-fire
    assessment, masks) and host post-processing (readback, hulls,
    tables). ``plain`` swaps the plain versions in for K1 and K3."""
    aod, lat, lon, date, fires = scene
    clock, timed = phase_clock(("host_prep", "k1", "k3", "host_post"))
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
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aod_table, hull_table, out = rg.identify(aod, lat, lon, date, fires,
                                                 RG, device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
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
    # a process's first run is a warm-up; at 1200² its first-use cost
    # reaches into the next run of the kernels, so the scene runs on until
    # the last three kernel runs are steady
    orders = {"bench_1200": (False, True, False, True, False, False),
              "synthetic_8192": (False, True, False)}
    res = {}
    for name, scene in scenes.items():
        runs = {"kernels": [], "plain": []}
        results = {}
        torch.cuda.reset_peak_memory_stats()
        ccl_sweep.LAUNCHES = 0
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
                     "k1_launches": ccl_sweep.LAUNCHES,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"identify {name}: {len(kt)} plumes, F = {f_cap}, K1 launches "
              f"{ccl_sweep.LAUNCHES}, peak {res[name]['peak_gb']:.2f} GB",
              flush=True)
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


def feature_root(tmp, name, scene_kw):
    """A root of FEATURE_GRANULES synthetic 1200² granules (seeds 0-3,
    centres 15° of longitude apart, so that each sees only its own fires)
    and one fire table; and a second root that holds the first granule
    only, for the ``--device cpu`` run. Returns (root, cpu_root, names)."""
    root = os.path.join(tmp, name)
    maiac = os.path.join(root, "raw", "plume_identification", "maiac")
    fires_dir = os.path.join(root, "raw", "fires")
    os.makedirs(maiac)
    os.makedirs(fires_dir)
    tables, names = [], []
    for seed in range(FEATURE_GRANULES):
        scene = make_scene(SyntheticSceneConfig(
            seed=SEED + seed, center_lon=-60.0 + 15.0 * seed, **scene_kw))
        save_granule(os.path.join(maiac, scene.granule.name + ".npz"),
                     scene.granule)
        tables.append(scene.fires)
        names.append(scene.granule.name)
    write_fire_csv(os.path.join(fires_dir, "fires.csv"),
                   {k: np.concatenate([t[k] for t in tables])
                    for k in tables[0]})
    cpu_root = os.path.join(tmp, name + "_cpu")
    shutil.copytree(root, cpu_root, ignore=lambda d, files: [
        f for f in files if f.endswith(".npz") and f != names[0] + ".npz"])
    return root, cpu_root, names


def build_features(root, *flags):
    """(seconds, exit code) of one ``build_features`` call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["build_features", "--root", root, *flags])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"build_features {flags} exited {rc}")
    return secs


def features_path(tmp):
    """``build_features --detector rg`` over four synthetic 1200² granules
    and one fire table on the card: K1 and K3 must launch and plumes must
    be accepted; the first granule's CSVs and masks must equal a
    ``--device cpu`` run; ``--batch-scenes 4`` over the same granules must
    write what the serial run wrote."""
    root, cpu_root, names = feature_root(tmp, "features", BENCH_SCENE)
    batch_root = os.path.join(tmp, "features_batch")
    shutil.copytree(root, batch_root)

    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    secs = build_features(root, "--detector", "rg")
    launches = {"k1": ccl_sweep.LAUNCHES, "k3": label_counts.LAUNCHES}
    if not (launches["k1"] > 0 and launches["k3"] > 0):
        raise AssertionError(f"build_features did not launch K1 and K3: "
                             f"{launches}")
    outputs = {n: read_features(root, n) for n in names}
    plumes = {n: len(o["aod"]) - 1 for n, o in outputs.items()}
    if not sum(plumes.values()):
        raise AssertionError("build_features accepted no plume")

    cpu_s = build_features(cpu_root, "--detector", "rg", "--device", "cpu")
    assert_features_equal(outputs[names[0]], read_features(cpu_root, names[0]),
                          names[0])

    batch_s = build_features(batch_root, "--detector", "rg",
                             "--batch-scenes", str(FEATURE_GRANULES))
    for n in names:
        assert_features_equal(read_features(batch_root, n), outputs[n], n)
    res = {"granules": FEATURE_GRANULES, "granule_px": BENCH_SCENE["size"],
           "seconds": secs, "s_per_granule": secs / FEATURE_GRANULES,
           "launches": launches, "plumes": plumes,
           "cpu_seconds_one_granule": cpu_s, "batch_scenes_seconds": batch_s}
    print(f"build_features {FEATURE_GRANULES}x{BENCH_SCENE['size']}^2 on the "
          f"card: {secs:.2f} s ({secs / FEATURE_GRANULES:.3f} s/granule), "
          f"launches {launches}, plumes {plumes}; {names[0]} equals the "
          f"--device cpu run ({cpu_s:.2f} s); --batch-scenes "
          f"{FEATURE_GRANULES} equals the serial run ({batch_s:.2f} s)",
          flush=True)
    return res


# ----------------------------------------- the basic and gaussian detectors

def check_masks(name, masks, connectivity=2, same_as=None):
    """K2 vs its plain version (connected_components per level): equal
    labels; kernel time over repeated launches, plain time of the
    comparison call. ``same_as``: labels it must also equal."""
    got = ccl_sweep.multi_threshold_ccl(masks, connectivity, nested=False)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(
        lambda: ccl_sweep.multi_threshold_ccl_masks_ref(masks, connectivity))
    equal = torch.equal(got, ref)
    wrong = 0 if equal else int((got != ref).sum())
    del ref
    if same_as is not None and not torch.equal(got, same_as):
        raise AssertionError(f"K2 on {name} differs from K1 on the raw AOD")
    t_count, h, w = got.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=DEV)
    components = [int((got[t].view(-1) == ids).sum()) for t in range(t_count)]
    fg = [float(masks[t].float().mean()) for t in range(t_count)]
    big = h * w >= 4096**2
    ms = time_ms(lambda: ccl_sweep.multi_threshold_ccl(
        masks, connectivity, nested=False), reps=5 if big else 10,
        calls=QUEUED)
    bound_ms, bound_by = bound(masks.numel() + got.numel() * 4)
    row = {"scene": name, "h": h, "w": w, "levels": t_count,
           "connectivity": connectivity, "equal": equal,
           "wrong_pixels": wrong, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "gpix_levels_per_s": t_count * h * w / ms / 1e6,
           "components": components, "foreground_share": fg}
    if name in ("basic_scene_1200_mask", "basic_mask_8192"):
        out = torch.empty_like(got)
        row["passes"] = pass_split(f"K2 {name}", lambda n: (
            ccl_pass_times.masks_prefix(masks, out, connectivity, n)),
            3 if big else 5)
        del out
    print(f"K2 {name} {h}x{w} T={t_count} conn={connectivity}: "
          f"{'equal' if equal else f'{wrong} pixels differ'}; kernel "
          f"{ms:.3f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.1f} ms; components per level {components[0]}.."
          f"{components[-1]}, foreground {fg[0]:.3f}..{fg[-1]:.3f}",
          flush=True)
    if not equal:
        raise AssertionError(f"K2 disagrees with its plain version on {name}")
    return row


def opened_stack(aod, thresholds):
    th = torch.from_numpy(np.asarray(thresholds, np.float32)).to(DEV)
    return binary_opening_cross(aod[None] > th[:, None, None]).contiguous()


def check_mask_kernel(rng):
    """K2 on the opened stack of the bench scene (also equal to K1 on the
    raw AOD), basic's mask of its own 1200² scene (sparse) and of the
    bench scene (percolating), a ragged stack at both connectivities,
    independent random masks, a fire raster, a serpentine, an empty and a
    full level, and basic's mask at 8192²."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BENCH_SCENE))
    aod = torch.from_numpy(bench.granule.first_layer()).to(DEV)
    k1 = ccl_sweep.multi_threshold_ccl_fused(
        aod, torch.from_numpy(THRESHOLDS).to(DEV))
    rows = [check_masks("bench_1200_opened", opened_stack(aod, THRESHOLDS),
                        same_as=k1)]
    del k1
    limit = torch.tensor(BASIC.aod_min_limit, device=DEV)
    clean = torch.from_numpy(make_scene(SyntheticSceneConfig(
        seed=SEED, **BASIC_SCENE)).granule.first_layer()).to(DEV)
    for name, plane in (("basic_scene_1200_mask", clean),
                        ("bench_1200_basic_mask", aod)):
        rows.append(check_masks(name, binary_opening_cross(
            plane >= limit)[None].contiguous()))
    ragged = opened_stack(device_scene(1201, 997, SEED + 1)[0], THRESHOLDS)
    for conn in (2, 1):
        rows.append(check_masks("ragged_opened", ragged, conn))
    del ragged
    independent = torch.from_numpy(rng.random((4, 1024, 1024)) < 0.45).to(DEV)
    rows.append(check_masks("independent_1024", independent))
    raster = torch.zeros((1, 1200, 1200), dtype=torch.bool, device=DEV)
    fires = rng.integers(16, 1184, (16, 2))
    for r, c in fires:                       # 16 clusters of 4 fires
        for dr, dc in ((0, 0), (0, 1), (1, 1), (2, 2)):
            raster[0, r + dr, c + dc] = True
    rows.append(check_masks("fire_raster_1200", raster))
    rows.append(check_masks("serpentine_1024",
                            (serpentine(1024, 1024) > 0.5)[None].contiguous()))
    edge = torch.zeros((2, 1200, 1200), dtype=torch.bool, device=DEV)
    edge[1] = True
    rows.append(check_masks("empty_and_full_1200", edge))
    del edge, independent, raster
    swath = device_scene(8192, 8192, SEED + 8192)[0]
    rows.append(check_masks("basic_mask_8192", binary_opening_cross(
        swath >= limit)[None].contiguous()))
    del swath
    torch.cuda.empty_cache()
    return rows


def plain_masks(opened, connectivity=2, nested=True):
    return ccl_sweep.multi_threshold_ccl_masks_ref(opened, connectivity)


def basic_split(scene, plain):
    """One basic.identify on the card, timed by phase: host fire prep, K2,
    the rest of the device program (ratio screen, threshold, opening,
    windows, per-fire compares) and host post-processing. ``plain`` swaps
    the plain version in for K2."""
    aod, lat, lon, date, fires = scene
    clock, timed = phase_clock(("host_prep", "k2", "host_post"))
    patches = {
        (basic, "_prep_fires"): timed("host_prep", basic._prep_fires),
        (basic, "multi_threshold_ccl"): timed("k2", (
            plain_masks if plain else ccl_sweep.multi_threshold_ccl)),
        (basic, "_to_host"): timed("host_post", basic._to_host),
    }
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plumes, image = basic.identify(aod, lat, lon, date, fires, BASIC,
                                       device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["device_rest"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, (plumes, image)


def gaussian_split(scene, plain):
    """One gaussian.identify_granule on the card, timed by phase: host
    fire location, in-painting, clustering (the raster, K2 and the
    per-fire centroid sums), K1, K3, the per-fire phase (the rest of the
    three sweeps per layer) and host post-processing (readback, hulls,
    tables). ``plain`` swaps the plain versions in for K1, K2 and K3."""
    granule, fires, date = scene
    clock, timed = phase_clock(("host_prep", "inpaint", "clustering", "k1",
                                "k3", "host_post"))
    patches = {
        (gaussian, "load_fires"): timed("host_prep", gaussian.load_fires),
        (gaussian, "nearest_fill"): timed("inpaint", gaussian.nearest_fill),
        (gaussian, "cluster_fire_centroids"): timed(
            "clustering", gaussian.cluster_fire_centroids),
        (pipeline, "multi_threshold_ccl_fused"): timed("k1", (
            ccl_sweep.multi_threshold_ccl_ref if plain
            else ccl_sweep.multi_threshold_ccl_fused)),
        (pipeline, "fire_label_counts"): timed("k3", (
            label_counts.fire_label_counts_ref if plain
            else label_counts.fire_label_counts)),
        (gaussian, "_to_host"): timed("host_post", gaussian._to_host),
        (gaussian, "build_scene_dataframes"): timed(
            "host_post", gaussian.build_scene_dataframes),
    }
    if plain:
        # raster_cluster_centroids looks its K2 entry up at call time
        patches[(ccl_sweep, "multi_threshold_ccl")] = plain_masks
    with Patched(patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = gaussian.identify_granule(granule, fires, date, GAUSS,
                                          device=DEV)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    ms = {k: v * 1e3 for k, v in clock.items()}
    ms["per_fire"] = total * 1e3 - sum(ms.values())
    ms["total"] = total * 1e3
    return ms, table.rows


def detector_split():
    """ms per scene of basic.identify (its 1200² scene) and per
    granule of gaussian.identify_granule (1200², two layers, null blobs),
    with the kernels and with the plain versions, in turns; the two must
    give the same plumes."""
    bench = make_scene(SyntheticSceneConfig(seed=SEED, **BASIC_SCENE))
    g = bench.granule
    aod = g.first_layer().copy()
    aod[aod < 0] = 0.0                      # as the api hands it to basic
    gscene = make_scene(SyntheticSceneConfig(seed=SEED, **GAUSS_SCENE))
    located = gaussian.load_fires(gscene.granule.lat, gscene.granule.lon,
                                  gscene.fires,
                                  gscene.fires["date_time"][0], GAUSS)[0]
    if len(located) < GAUSS.min_fires_per_scene:
        raise AssertionError(f"gaussian scene has {len(located)} fires")
    truncated = max(0, len(located) - GAUSS.max_fires)
    print(f"gaussian scene: {len(located)} raw fires located; the detector "
          f"keeps the first {GAUSS.max_fires} (its capacity, unbucketed) and "
          f"drops {truncated} before clustering, as the JAX function does, "
          "so the gaussian times below are of a truncated run", flush=True)
    runs = {
        "basic_1200": (basic_split, (aod, g.lat, g.lon,
                                     bench.fires["date_time"][0],
                                     bench.fires)),
        "gaussian_1200x2": (gaussian_split, (gscene.granule, gscene.fires,
                                             gscene.fires["date_time"][0])),
    }
    res = {}
    for name, (split, scene) in runs.items():
        timings = {"kernels": [], "plain": []}
        results = {}
        before = ccl_sweep.MASK_LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        for plain in (False, True, True, False):
            ms, result = split(scene, plain)
            key = "plain" if plain else "kernels"
            timings[key].append(ms)
            results.setdefault(key, result)
            print(f"identify {name} ({key}): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + " ms", flush=True)
        k2_launches = ccl_sweep.MASK_LAUNCHES - before
        if k2_launches <= 0:
            raise AssertionError(f"{name}: K2 was not launched")
        if name == "basic_1200":
            (kd, ki), (pd_, pi) = results["kernels"], results["plain"]
            same = kd == pd_ and np.array_equal(ki, pi)
            found = len(kd)
        else:
            same = results["kernels"] == results["plain"]
            found = len({(r[0], r[-1]) for r in results["kernels"]})
        if not same:
            raise AssertionError(f"{name}: kernels and plain versions give "
                                 "different plumes")
        if not found:
            raise AssertionError(f"{name}: no plume found")
        res[name] = {"runs": timings, "plumes": found,
                     "k2_launches": k2_launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name != "basic_1200":
            res[name]["located_fires"] = int(len(located))
            res[name]["fires_dropped_at_capacity"] = truncated
        print(f"identify {name}: {found} plumes, K2 launches {k2_launches}, "
              f"peak {res[name]['peak_gb']:.2f} GB"
              + ("" if name == "basic_1200" else
                 f"; {len(located)} raw fires truncated to {GAUSS.max_fires}"),
              flush=True)
    torch.cuda.empty_cache()
    return res


def read_extent(root, base):
    """The ``<base>_extent.csv`` of a basic or gaussian run: header and
    rows of strings."""
    from plumekit_torch.config import PathsConfig

    path = os.path.join(PathsConfig(root=root).resolve("hull_df_dir"),
                        base + "_extent.csv")
    with open(path) as f:
        return list(csv.reader(f))


def assert_extent_equal(got, want, base):
    """Card and CPU extent CSVs: ids, pixel coordinates, bounding boxes and
    the datetime exact; hull latitudes and longitudes are read from the
    same grid, rtol 1e-5."""
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f"{base}: header or row count differ "
                             f"({len(got)} vs {len(want)} rows)")
    for j, col in enumerate(want[0]):
        g, w = [r[j] for r in got[1:]], [r[j] for r in want[1:]]
        if col == "datetime":
            ok = g == w
        elif col in ("hull_lats", "hull_lons"):
            ok = np.allclose(np.asarray(g, float), np.asarray(w, float),
                             rtol=FEATURE_RTOL, atol=0.0)
        else:
            ok = np.array_equal(np.asarray(g, float), np.asarray(w, float))
        if not ok:
            raise AssertionError(f"{base} {col}: card {g} vs CPU {w}")


def detector_features_path(tmp, detector, scene_kw):
    """``build_features --detector basic|gaussian`` over four synthetic
    1200² granules on the card: the detector's kernels must launch and
    plumes must be found; the first granule's CSV must equal a
    ``--device cpu`` run."""
    root, cpu_root, names = feature_root(tmp, detector, scene_kw)
    ccl_sweep.LAUNCHES = ccl_sweep.MASK_LAUNCHES = label_counts.LAUNCHES = 0
    secs = build_features(root, "--detector", detector)
    launches = {"k1": ccl_sweep.LAUNCHES, "k2": ccl_sweep.MASK_LAUNCHES,
                "k3": label_counts.LAUNCHES}
    needed = ("k2",) if detector == "basic" else ("k1", "k2", "k3")
    if not all(launches[k] > 0 for k in needed):
        raise AssertionError(f"build_features --detector {detector} did not "
                             f"launch {needed}: {launches}")
    outputs = {n: read_extent(root, n) for n in names}
    id_cols = 1 if detector == "basic" else 2      # id, or id and datetime
    plumes = {n: len({(r[0], r[-1])[:id_cols] for r in o[1:]})
              for n, o in outputs.items()}
    if not sum(plumes.values()):
        raise AssertionError(f"build_features --detector {detector} found "
                             "no plume")
    cpu_s = build_features(cpu_root, "--detector", detector, "--device",
                           "cpu")
    assert_extent_equal(outputs[names[0]], read_extent(cpu_root, names[0]),
                        names[0])
    res = {"granules": FEATURE_GRANULES, "granule_px": scene_kw["size"],
           "seconds": secs, "s_per_granule": secs / FEATURE_GRANULES,
           "launches": launches, "plumes": plumes,
           "cpu_seconds_one_granule": cpu_s}
    print(f"build_features --detector {detector} {FEATURE_GRANULES}x"
          f"{scene_kw['size']}^2 on the card: {secs:.2f} s "
          f"({secs / FEATURE_GRANULES:.3f} s/granule), launches {launches}, "
          f"plumes {plumes}; {names[0]} equals the --device cpu run "
          f"({cpu_s:.2f} s)", flush=True)
    return res


def main() -> int:
    t_start = time.perf_counter()
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

    sources = ["unet_mega.cu", "fused_double_conv.cu", "fused_conv.cu",
               "scalar_gather_probe.cu", "ccl_sweep.cu", "label_counts.cu"]
    t0 = time.perf_counter()
    cuda_build.load_libraries(sources)
    build_s = time.perf_counter() - t0
    print(f"kernel builds + loads {build_s:.2f} s (one nvcc per source, "
          "side by side)")
    for source in sources:
        log = cuda_build.BUILD_LOG.get(source, {})
        print(f"{source}: nvcc {log.get('seconds', 0.0):.2f} s")
        for line in log.get("ptxas", "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                print(line[:240])

    # megakernel serving (K7), then K5 and P1, then serving with K6
    batch = BATCH_GRANULES * ICFG.batch_tiles
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    mega = check_mega(model, rng, batch)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        root = serving_root(model, rng, tmp)
        mega_served = mega_path(model, root, tmp, {
            "k7": mega["ms"], "cudnn": mega["cudnn_forward_ms"],
            "k6": mega["k6_forward_ms"]})
        torch.cuda.empty_cache()
        single_rows, single_launches = check_single_conv(rng, batch)
        probe = check_probe()
        kernel_rows = check_kernel(rng, batch)
        forward = check_forward(model, rng)
        served = main_path(model, root, tmp)
    del model
    torch.cuda.empty_cache()

    # the rg weak labeller: K1/K4 and K3
    ccl_rows, count_rows = check_identify_kernels(rng)
    sweeps = sweep_split()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        features = features_path(tmp)

    # the basic and gaussian detectors: K2
    mask_rows = check_mask_kernel(rng)
    detectors = detector_split()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        basic_features = detector_features_path(tmp, "basic", BASIC_SCENE)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        gaussian_features = detector_features_path(tmp, "gaussian",
                                                   GAUSS_SCENE)

    timed = [r for r in kernel_rows if r["set"] == str(ICFG.tile_size)]
    timed_mega = [r for r in kernel_rows if r["set"] == str(MEGA.tile_size)]
    single = [r for r in single_rows if "ms" in r]
    single_share = {kind: sum(r["bound_ms"] for r in single
                              if r["bound_by"] == kind)
                    for kind in ("bytes", "operations")}
    # each block has its own bound; the forward's is their sum, named by
    # whichever kind bounds the larger share of it
    k6_bound = [(r["bound_ms"], r["bound_by"]) for r in timed]
    k6_share = {kind: sum(b for b, by in k6_bound if by == kind)
                for kind in ("bytes", "operations")}
    bench_ccl = next(r for r in ccl_rows if r["scene"] == "bench_1200")
    swath_ccl = next(r for r in ccl_rows if r["scene"] == "synthetic_8192")
    bench_counts = next(r for r in count_rows
                        if r["scene"] == "bench_1200" and r["F"] == 16)
    basic_mask = next(r for r in mask_rows
                      if r["scene"] == "basic_scene_1200_mask")

    def ccl_entry(name, replaces, row, launches, errors, **extra):
        return {"name": name, "route": "cuda",
                "source": "plumekit_torch/csrc/ccl_sweep.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["wrong_pixels"] for r in errors),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None,
                "at": f"{row['h']}x{row['w']}, T={row['levels']}", **extra}

    kernels = [{
        "name": "fused_double_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_double_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:180",
        "launches": served["k6_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": sum(r["ms"] for r in timed),
        # the fp32-accumulated version the kernel is held against
        "plain_ms": sum(r["ref_fp32_ms"] for r in timed),
        "bound_ms": sum(b for b, _ in k6_bound),
        "bound_by": max(k6_share, key=k6_share.get),
        # two cuDNN bf16 convolutions with scale, shift and ReLU per block
        "library_ms": sum(r["plain_ms"] for r in timed),
        "at": f"the 9 blocks of one forward, batch {batch}",
        # the same with the per-call packing of the raw-weight entry, and
        # the nine blocks at the megakernel's tile beside cuDNN
        "ms_with_packing": sum(r["wrapper_ms"] for r in timed),
        "ms_tile_96": sum(r["ms"] for r in timed_mega),
        "library_ms_tile_96": sum(r["plain_ms"] for r in timed_mega)},
        ccl_entry("multi_threshold_ccl_fused",
                  "plumekit/ops/pallas/ccl_sweep.py:544", bench_ccl,
                  features["launches"]["k1"]
                  + gaussian_features["launches"]["k1"], ccl_rows),
        ccl_entry("multi_threshold_ccl",
                  "plumekit/ops/pallas/ccl_sweep.py:468", basic_mask,
                  basic_features["launches"]["k2"]
                  + gaussian_features["launches"]["k2"], mask_rows), {
        "name": "fire_label_counts", "route": "cuda",
        "source": "plumekit_torch/csrc/label_counts.cu",
        "replaces": "plumekit/ops/pallas/label_counts.py:83",
        "launches": features["launches"]["k3"]
        + gaussian_features["launches"]["k3"],
        "max_abs_err": max(r["max_abs_err"] for r in count_rows),
        "ms": bench_counts["ms"], "plain_ms": bench_counts["plain_ms"],
        "bound_ms": bench_counts["bound_ms"],
        "bound_by": bench_counts["bound_by"], "library_ms": None,
        "at": "1200x1200, T=20, F=16"},
        # K4 is K1's kernel under its other entry name, timed where the TPU
        # needs the banded kernel; its launches are K1's at 8192² in the
        # rg sweep (rg.identify on the swath scene)
        ccl_entry("multi_threshold_ccl_banded",
                  "plumekit/ops/pallas/ccl_banded.py:321", swath_ccl,
                  sweeps["synthetic_8192"]["k1_launches"], ccl_rows,
                  same_kernel_as="multi_threshold_ccl_fused"), {
        "name": "fused_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:259",
        # a library entry that no command calls, as in the JAX package:
        # this run's calls of the entry at the net's shapes, one launch each
        "launches": single_launches,
        "max_abs_err": max(r["max_abs_err"] for r in single_rows),
        "ms": sum(r["ms"] for r in single),
        "plain_ms": sum(r["plain_ms"] for r in single),
        "bound_ms": sum(r["bound_ms"] for r in single),
        "bound_by": max(single_share, key=single_share.get),
        # one cuDNN bf16 convolution with scale, shift and ReLU per shape
        "library_ms": sum(r["library_ms"] for r in single),
        "at": f"the 18 convs of one forward at tile {MEGA.tile_size}, "
              f"batch {batch}",
        "ms_with_packing": sum(r["wrapper_ms"] for r in single)}, {
        "name": "mega_forward", "route": "cuda",
        "source": "plumekit_torch/csrc/unet_mega.cu",
        "replaces": "plumekit/models/pallas/unet_mega.py:364",
        "launches": mega_served["launches"]["k7"],
        "max_abs_err": max(c["max_abs_diff"] for c in mega["cases"].values()),
        "ms": mega["ms"], "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"], "bound_by": mega["bound_by"],
        # the plain forward: cuDNN bf16 convolutions, BatchNorm not folded
        "library_ms": mega["cudnn_forward_ms"],
        "at": f"one forward of UNetConfig(), {batch} tiles of "
              f"{MEGA.tile_size}x{MEGA.tile_size}"}, {
        "name": "scalar_gather_probe", "route": "cuda",
        "source": "plumekit_torch/csrc/scalar_gather_probe.cu",
        "replaces": "experiments/scalar_dma_probe.py:85",
        # launches of the probe's own entry point (python -m
        # plumekit_torch.experiments.scalar_gather_probe), both forms
        "launches": probe["launches"],
        "max_abs_err": probe["wrong"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        # the bytes' time is below a kernel launch (about 0.003 ms), which
        # is what bounds the probe at this size
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None,
        "chained_ns_per_lookup": probe["chained_ns_per_lookup"],
        "parallel_ns_per_lookup": probe["parallel_ns_per_lookup"],
        "at": f"{PROBE_SIZE}x{PROBE_SIZE}, {PROBE_LOOKUPS} lookups, copy "
              "plus the parallel form"}]
    copy_rate = measured_copy_rate()
    for k in kernels:
        k["bound_at_copy_rate_ms"] = k["bound_ms"] * (
            PEAK_BYTES_PER_S / copy_rate if k["bound_by"] == "bytes" else 1.0)
    print(f"device-to-device copy rate {copy_rate / 1e9:.1f} GB/s "
          f"({100 * copy_rate / PEAK_BYTES_PER_S:.1f}% of the data sheet's "
          f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "build_s": build_s,
                   "builds": {k: v["seconds"]
                              for k, v in cuda_build.BUILD_LOG.items()},
                   "mega": mega, "mega_serving": mega_served,
                   "single_conv_rows": single_rows, "probe": probe,
                   "kernel_rows": kernel_rows, "forward": forward,
                   "serving": served, "ccl_rows": ccl_rows,
                   "count_rows": count_rows, "identify": sweeps,
                   "build_features": features, "mask_rows": mask_rows,
                   "detectors": detectors,
                   "build_features_basic": basic_features,
                   "build_features_gaussian": gaussian_features,
                   "copy_rate_gb_per_s": copy_rate / 1e9,
                   "seconds": time.perf_counter() - t_start,
                   "kernels": kernels},
                  f, indent=1)
    print(f"chip_smoke took {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
