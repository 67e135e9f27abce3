"""Times of the fused conv kernels alone, the weights packed outside the
timed call: K6 at the nine double-conv blocks of ``UNetConfig()`` at tiles
288 and 96, K5 at the eighteen single convs at tile 96, batch 128, each
beside one cuDNN bf16 call for the same function and beside the raw-weight
entry that packs on every call; ``queued_ms`` is the kernel again with 20
launches per pair of events, which leaves the host's time per call out.
``python -m plumekit_torch.experiments.conv_kernel_times`` on a card; prints
one line per shape and writes ``chiprun_out/conv_kernel_times.json``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch.config import UNetConfig
from plumekit_torch.models.kernels import conv_tiles
from plumekit_torch.models.kernels import fused_conv as fc

BATCH = 128
QUEUED = 20   # launches per event pair of the queued reading


def block_shapes(cfg, tile):
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
    around ``calls`` calls of ``fn`` and divided by them. With one call the
    events also span the host's work between the first record and the
    launch (the card is idle when the first event is recorded); with many
    the launches queue up and the reading is the card's time per call."""
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


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(0)

    def bf(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dev).to(torch.bfloat16)

    out = {"device": smi, "k6": {}, "k5": []}
    for tile in (288, 96):
        rows = []
        for cin, cmid, cout, h in block_shapes(UNetConfig(), tile):
            x = bf(BATCH, h, h, cin)
            w1 = bf(3, 3, cin, cmid, scale=(2 / (9 * cin)) ** .5)
            w2 = bf(3, 3, cmid, cout, scale=(2 / (9 * cmid)) ** .5)
            s1, b1, s2, b2 = bf(cmid), bf(cmid), bf(cout), bf(cout)
            packed = fc.pack_double_conv(w1, s1, b1, w2, s2, b2)
            pw1 = w1.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            pw2 = w2.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def cudnn():
                z = F.conv2d(x.permute(0, 3, 1, 2), pw1, padding=1)
                z = torch.relu(z * s1[:, None, None] + b1[:, None, None])
                z = F.conv2d(z, pw2, padding=1)
                return torch.relu(z * s2[:, None, None] + b2[:, None, None])

            t = conv_tiles.double_conv_tile(h, h, cin, cmid, cout)
            row = {"cin": cin, "cmid": cmid, "cout": cout, "h": h,
                   "path": t.path, "tile": [t.th, t.tw, t.images],
                   "kernel_ms": time_ms(
                       lambda: fc.fused_double_conv3x3_bn_relu_packed(
                           x, packed)),
                   "queued_ms": time_ms(
                       lambda: fc.fused_double_conv3x3_bn_relu_packed(
                           x, packed), calls=QUEUED),
                   "wrapper_ms": time_ms(
                       lambda: fc.fused_double_conv3x3_bn_relu(
                           x, w1, s1, b1, w2, s2, b2)),
                   "cudnn_ms": time_ms(cudnn)}
            print("K6", tile, row, flush=True)
            rows.append(row)
        out["k6"][str(tile)] = rows
    for cin, cmid, cout, h in block_shapes(UNetConfig(), 96):
        for ci, co in ((cin, cmid), (cmid, cout)):
            x = bf(BATCH, h, h, ci)
            w = bf(3, 3, ci, co, scale=(2 / (9 * ci)) ** .5)
            s, b = bf(co), bf(co)
            packed = fc.pack_single_conv(w, s, b)
            pw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def cudnn():
                z = F.conv2d(x.permute(0, 3, 1, 2), pw, padding=1)
                return torch.relu(z * s[:, None, None] + b[:, None, None])

            t = conv_tiles.single_conv_tile(h, h, ci, co)
            row = {"cin": ci, "cout": co, "h": h, "path": t.path,
                   "tile": [t.th, t.tw, t.images],
                   "kernel_ms": time_ms(
                       lambda: fc.fused_conv3x3_bn_relu_packed(x, packed)),
                   "queued_ms": time_ms(
                       lambda: fc.fused_conv3x3_bn_relu_packed(x, packed),
                       calls=QUEUED),
                   "wrapper_ms": time_ms(
                       lambda: fc.fused_conv3x3_bn_relu(x, w, s, b)),
                   "cudnn_ms": time_ms(cudnn)}
            print("K5", row, flush=True)
            out["k5"].append(row)
    for tile, rows in out["k6"].items():
        print(f"K6 tile {tile}: kernel "
              f"{sum(r['kernel_ms'] for r in rows):.3f} ms (queued "
              f"{sum(r['queued_ms'] for r in rows):.3f}), wrapper "
              f"{sum(r['wrapper_ms'] for r in rows):.3f}, cuDNN "
              f"{sum(r['cudnn_ms'] for r in rows):.3f}")
    print(f"K5: kernel {sum(r['kernel_ms'] for r in out['k5']):.3f} ms "
          f"(queued {sum(r['queued_ms'] for r in out['k5']):.3f}), "
          f"wrapper {sum(r['wrapper_ms'] for r in out['k5']):.3f}, cuDNN "
          f"{sum(r['cudnn_ms'] for r in out['k5']):.3f}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/conv_kernel_times.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
