"""Times of the whole-forward kernel K7 stage by stage, beside the fused
double conv K6 and cuDNN at the same block shapes.

K7 (``csrc/unet_mega.cu``) runs the U-Net's 2·depth + 1 stages in one
launch. ``pk_unet_mega`` takes the number of stages to run, so the stage
table cut to its first k stages is a launch of its own; stage k's time is
prefix(k) − prefix(k − 1), each prefix queued (20 launches per pair of CUDA
events). ``pk_unet_mega_stamps``, which only this script calls, launches the
whole table and writes per block and stage its start and end on the
card's global timer and the clock cycles its items spent in their double
convs; from them:

* busy share: the blocks' busy time over blocks × the stage's wall time,
  which is what a stage's tail and an idle block cost;
* conv share: the part of the busy time in double convs, the rest being
  the pool or the upsample that follows them.

Beside each stage: its plane, channels, path, tile, items and waves on the
grid, shared memory, and K6 (queued and single launch) and cuDNN's double
conv at the same block shape. Then the whole forward: K7 single and
queued, the K6 sum, the cuDNN forward, peak memory. Build facts: registers
and spills from ``ptxas -v``, blocks per SM.

``python -m plumekit_torch.experiments.mega_stage_times [--tiles 96 288]
[--batch 128] [--out PATH] [--whole-only]`` on a card; prints one line per
reading and writes the JSON to ``PATH`` (``chiprun_out/mega_stage_times.json``).
``--whole-only`` times the whole forward alone, through
``make_mega_apply``, for a tree whose kernel has no per-stage entries."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch import cuda_build
from plumekit_torch.config import UNetConfig
from plumekit_torch.models import build_model
from plumekit_torch.models.kernels import fused_conv, unet_mega

QUEUED = 20          # launches per event pair
STAMP_FIELDS = 5     # kStampFields of csrc/unet_mega.cu
SEED = 0


def block_shapes(cfg, tile):
    """(Cin, Cmid, Cout, H) of the 2·depth + 1 double-conv blocks, in the
    kernel's stage order."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i)
           for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth)]
    dec = [(f[i + 1], f[i], f[i], tile >> i)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


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


def seeded_unet(cfg, seed, device):
    """The config with seeded random weights at He scale and nontrivial
    BatchNorm parameters and running statistics (chip_smoke's net)."""
    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(2.0 ** 0.5)
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    return model.to(device).eval()


def stage_rows(weights, b, tile, blocks):
    """What the plan says of each stage: kind, plane, channels, path, tile,
    items, the split of an item over two blocks (:func:`unet_mega.
    stage_split`; 1 where the kernel has none), waves of items on
    ``blocks`` blocks."""
    rows = []
    depth = (len(weights.stages) - 1) // 2
    for i, st in enumerate(weights.stages):
        level = i if i <= depth else 2 * depth - i
        h = tile >> level
        t = unet_mega.stage_tile(st, h, h)
        items = -(-b // t.images) * -(-h // t.th) * -(-h // t.tw)
        split = getattr(unet_mega, "stage_split", lambda *a: 1)(
            st, t, items, blocks)
        rows.append({"stage": i, "kind": ("pool", "up", "head")[st["kind"]],
                     "split": split,
                     "plane": h, "channels": [st["cin"], st["cmid"],
                                              st["cout"]],
                     "path": t.path, "tile": [t.th, t.tw, t.images],
                     "smem": t.smem, "items": items,
                     "waves": items * split / blocks if blocks else None})
    return rows


def stamp_split(stamps, n_stages, blocks):
    """Per stage from one stamped launch: wall µs (first start to last
    end), busy share, conv share, start skew µs."""
    s = stamps[:n_stages * blocks * STAMP_FIELDS].view(
        n_stages, blocks, STAMP_FIELDS).cpu().numpy().astype(np.float64)
    out = []
    for k in range(n_stages):
        gs, ge, cs, ce, conv = (s[k, :, j] for j in range(STAMP_FIELDS))
        wall = ge.max() - gs.min()
        busy = (ge - gs).sum()
        out.append({"wall_us": wall / 1e3,
                    "busy_share": busy / (blocks * wall) if wall > 0 else 0.0,
                    "conv_share": conv.sum() / max((ce - cs).sum(), 1.0),
                    "start_skew_us": (gs.max() - gs.min()) / 1e3,
                    "gap_to_next_us": ((s[k + 1, :, 0].min() - ge.max()) / 1e3
                                       if k + 1 < n_stages else None)})
    return out


def stage_split_of(weights, x, reps=5):
    """Per stage of K7 on the bf16 input x: what the plan says
    (:func:`stage_rows`), its ms as the difference of queued prefixes, and
    the busy and conv shares, skew and gap from three stamped launches
    (medians)."""
    n = len(weights.stages)
    prefix = [time_ms(lambda k=k: unet_mega.launch_stages(weights, x, k),
                      reps=reps) for k in range(1, n + 1)]
    stamps = torch.zeros(n * 4096 * STAMP_FIELDS, dtype=torch.int64,
                         device=x.device)
    splits = []
    for _ in range(3):
        _, blocks = unet_mega.launch_stages(weights, x, stamps=stamps)
        torch.cuda.synchronize()
        splits.append(stamp_split(stamps, n, blocks))
    b, tile = x.shape[0], x.shape[1]
    stages = stage_rows(weights, b, tile, blocks)
    for k, st in enumerate(stages):
        st["blocks"] = blocks
        st["ms"] = prefix[k] - (prefix[k - 1] if k else 0.0)
        st["prefix_ms"] = prefix[k]
        for key in splits[0][k]:
            vals = [sp[k][key] for sp in splits if sp[k][key] is not None]
            st[key] = float(np.median(vals)) if vals else None
    return stages


def cudnn_double_conv(x, w1, s1, b1, w2, s2, b2):
    z = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1)
    z = torch.relu(z * s1[:, None, None] + b1[:, None, None])
    z = F.conv2d(z, w2, padding=1)
    return torch.relu(z * s2[:, None, None] + b2[:, None, None])


def block_times(cfg, tile, batch, rng, dev):
    """K6 (queued and single) and cuDNN's double conv at each block shape."""
    def bf(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dev).to(torch.bfloat16)

    rows = []
    for cin, cmid, cout, h in block_shapes(cfg, tile):
        x = bf(batch, h, h, cin)
        w1 = bf(3, 3, cin, cmid, scale=(2 / (9 * cin)) ** .5)
        w2 = bf(3, 3, cmid, cout, scale=(2 / (9 * cmid)) ** .5)
        s1, b1, s2, b2 = bf(cmid), bf(cmid), bf(cout), bf(cout)
        packed = fused_conv.pack_double_conv(w1, s1, b1, w2, s2, b2)
        pw1 = w1.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pw2 = w2.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        reps = 3 if tile > 96 else 5
        k6 = lambda: fused_conv.fused_double_conv3x3_bn_relu_packed(  # noqa
            x, packed)
        rows.append({
            "k6_queued_ms": time_ms(k6, reps=reps),
            "k6_ms": time_ms(k6, reps=reps, calls=1),
            "cudnn_ms": time_ms(lambda: cudnn_double_conv(
                x, pw1, s1, b1, pw2, s2, b2), reps=reps, calls=1)})
        del x, packed
    torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[96, 288])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default="chiprun_out/mega_stage_times.json")
    ap.add_argument("--whole-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_stage_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_build.load_libraries(["unet_mega.cu", "fused_double_conv.cu"])
    ptxas = {src: [line for line in log.get("ptxas", "").splitlines()
                   if "registers" in line or "spill" in line
                   or "Performance Loss" in line]
             for src, log in cuda_build.BUILD_LOG.items()}
    for src, lines in ptxas.items():
        for line in lines:
            print(f"{src}: {line.strip()[:200]}")
    cfg = UNetConfig()
    model = seeded_unet(cfg, SEED, dev)
    apply = unet_mega.make_mega_apply(cfg)
    weights = unet_mega.weights_of(model, torch.bfloat16, dev)
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"device": smi, "torch": torch.__version__, "queued_calls": QUEUED,
           "batch": args.batch, "ptxas": ptxas, "sms": sms, "tiles": {}}
    for tile in args.tiles:
        x = torch.from_numpy(rng.standard_normal(
            (args.batch, tile, tile, cfg.in_channels), dtype=np.float32)
        ).to(dev).to(torch.bfloat16)
        reps = 3 if tile > 96 else 5
        row = {}
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            apply(model, x)
            torch.cuda.synchronize()
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            row["k7_ms"] = time_ms(lambda: apply(model, x), reps=reps + 5,
                                   calls=1)
            row["k7_queued_ms"] = time_ms(lambda: apply(model, x), reps=reps)
            row["cudnn_forward_ms"] = time_ms(lambda: model(x), reps=reps,
                                              calls=1)
            if not args.whole_only:
                stages = stage_split_of(weights, x, reps)
                blocks = stages[0]["blocks"]
                blocks6 = block_times(cfg, tile, args.batch, rng, dev)
                for st, k6 in zip(stages, blocks6):
                    st.update(k6)
                row.update(blocks=blocks, blocks_per_sm=blocks / sms,
                           stages=stages,
                           k6_sum_ms=sum(r["k6_ms"] for r in blocks6),
                           k6_queued_sum_ms=sum(r["k6_queued_ms"]
                                                for r in blocks6),
                           cudnn_blocks_sum_ms=sum(r["cudnn_ms"]
                                                   for r in blocks6))
                print(f"K7 {args.batch}x{tile}^2 by stage ({blocks} blocks, "
                      f"{blocks / sms:g} per SM): stage kind plane channels "
                      "path tile items waves smem | ms busy conv | K6 "
                      "queued/single cuDNN", flush=True)
                for st in stages:
                    print(f"  {st['stage']} {st['kind']:>4} {st['plane']:>3}^2 "
                          f"{'->'.join(map(str, st['channels'])):>12} "
                          f"{st['path']:>5} {'x'.join(map(str, st['tile'])):>8}"
                          f" {st['items']:>6} {st['waves']:6.2f} "
                          f"{st['smem']:>6} | {st['ms']:.3f} "
                          f"{st['busy_share']:.3f} {st['conv_share']:.3f} | "
                          f"{st['k6_queued_ms']:.3f}/{st['k6_ms']:.3f} "
                          f"{st['cudnn_ms']:.3f}", flush=True)
            print(f"K7 {args.batch}x{tile}^2: single {row['k7_ms']:.3f} ms, "
                  f"queued {row['k7_queued_ms']:.3f}; cuDNN forward "
                  f"{row['cudnn_forward_ms']:.3f}; peak {row['peak_gb']:.3f} GB"
                  + (f"; K6 blocks {row['k6_sum_ms']:.3f} (queued "
                     f"{row['k6_queued_sum_ms']:.3f}), cuDNN blocks "
                     f"{row['cudnn_blocks_sum_ms']:.3f}"
                     if "k6_sum_ms" in row else ""), flush=True)
        res["tiles"][str(tile)] = row
        del x
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
