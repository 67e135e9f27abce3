"""Smoke run of plumekit_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds the hand-written CUDA kernel from ``plumekit_torch/csrc``, holds it
against its plain PyTorch version at every U-Net block shape of the serving
path, runs the flagship U-Net (``UNetConfig()``: base 32, depth 4, bf16)
through the fused and the plain forward, then serves four synthetic 2048²
granules end to end through ``predict_model --fused`` and through the plain
forward. Any failed check raises; there is no CPU fallback. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as JSON. Details also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
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


def block_shapes(cfg: UNetConfig, tile: int):
    """(Cin, Cmid, Cout, H) of the 2·depth + 1 double-conv blocks."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i)
           for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth)]
    dec = [(f[i + 1], f[i], f[i], tile >> i)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


def time_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings after two warm-up calls."""
    for _ in range(2):
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

    t0 = time.perf_counter()
    cuda_build.load_library("fused_double_conv.cu")
    build_s = time.perf_counter() - t0
    print(f"kernel build + load {build_s:.2f} s")
    ptxas = cuda_build.BUILD_LOG.get("fused_double_conv.cu", {}).get("ptxas")
    if ptxas:
        print("\n".join(line for line in ptxas.splitlines()
                        if "registers" in line or "spill" in line))

    batch = BATCH_GRANULES * ICFG.batch_tiles
    kernel_rows = check_kernel(rng, batch)
    model = seeded_unet(torch.Generator().manual_seed(SEED))
    forward = check_forward(model, rng)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        served = main_path(model, rng, tmp)

    timed = [r for r in kernel_rows if "ms" in r]
    kernels = [{
        "name": "fused_double_conv3x3_bn_relu", "route": "cuda",
        "source": "plumekit_torch/csrc/fused_double_conv.cu",
        "replaces": "plumekit/models/pallas/fused_conv.py:180",
        "launches": served["k6_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed)}]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "build_s": build_s, "kernel_rows": kernel_rows,
                   "forward": forward, "serving": served,
                   "kernels": kernels}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
