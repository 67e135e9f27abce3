"""Times of Q1, the int8 conv kernel, per conv of the int8 forward: the
eighteen 3×3 convs of ``UNetConfig()`` at a batch of 288² tiles (the
decoder blocks' first convs read the skip and the upsampled half as two
planes, the last conv writes fp32), each beside its plain version (nine
``torch._int_mm`` over shifted copies) and the cuDNN bf16 convolution of the
same shape with scale, shift and ReLU (the bf16 forward's conv, for
context). ``single_ms`` is one launch per pair of CUDA events, ``queued_ms``
20, which leaves the wrapper's host time out; the bound is the larger of the
operations at the data sheet's 1,979 int8 TOPS and the bytes at 3,350 GB/s.
Each case is also held against its plain version, bit for bit. With
``--forward`` it also profiles the whole int8 forward of a seeded
``UNetConfig()`` at the same batch (``torch.profiler``: the card's time in
Q1, in ``torch._int_mm`` and in the other kernels, and its busy share).
With ``--tiles`` it times each conv queued at both of Q1's output tiles,
16² and 8², each held bit for bit, beside the side ``conv_tile`` picks.
``python -m plumekit_torch.experiments.int8_conv_times [--batch 128]
[--tile 288] [--forward] [--tiles]`` on a card; prints one line per conv and
writes ``chiprun_out/int8_conv_times.json``."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from plumekit_torch.config import UNetConfig
from plumekit_torch.models.kernels import int8_conv

QUEUED = 20   # launches per event pair of the queued reading
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def conv_cases(cfg: UNetConfig, tile: int):
    """(c_skip, c_in, c_out, side, int8 out) of the 2·(2·depth + 1) convs of
    the int8 forward; c_skip > 0 for a decoder block's first conv, which
    reads ``concat([skip, up])``; the last conv writes fp32 for the head."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    cases = []
    for i in range(cfg.depth + 1):                # encoder and bottleneck
        cin = cfg.in_channels if i == 0 else f[i - 1]
        cases += [(0, cin, f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, True)]
    for i in reversed(range(cfg.depth)):          # decoder
        cases += [(f[i], f[i], f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, i != 0)]
    return cases


def case_inputs(rng, case, batch, device):
    """Seeded int8 planes and weights of one case, with a multiplier and a
    shift that spread the outputs over the int8 range: (x, w, a, b, scale,
    skip)."""
    c_skip, cin, cout, side, int8_out = case

    def plane(c, low):
        return torch.from_numpy(rng.integers(
            low, 128, (batch, side, side, c), dtype=np.int8)).to(device)

    # the network input is signed; every later plane follows a ReLU
    x = plane(cin, -127 if c_skip == 0 and cin < 8 else 0)
    skip = plane(c_skip, 0) if c_skip else None
    k = c_skip + cin
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, k, cout),
                                      dtype=np.int8)).to(device)
    a = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 4.0
                          / (64 * 73 * (9 * k) ** 0.5)).astype(np.float32)
                         ).to(device)
    b = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32)
                         ).to(device)
    scale = torch.tensor(16.0 / 127, dtype=torch.float32, device=device) \
        if int8_out else None
    return x, w, a, b, scale, skip


def ops_and_bytes(case, batch):
    """Integer operations and bytes moved once (inputs, weights, a, b and
    the output) of one conv."""
    c_skip, cin, cout, side, int8_out = case
    k = c_skip + cin
    px = batch * side * side
    return (2 * 9 * k * cout * px,
            px * k + 9 * k * cout + 8 * cout + px * cout * (1 if int8_out
                                                            else 4))


def bound(n_ops, n_bytes):
    """(bound_ms, bound_by) at the data sheet's int8 and memory rates."""
    by_ops = n_ops / PEAK_INT8_OPS_PER_S * 1e3
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def time_ms(fn, reps=10, warmup=2, calls=1):
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls, each
    around ``calls`` calls of ``fn`` and divided by them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return float(np.median(times))


def int8_library_conv(device):
    """Whether ``F.conv2d`` runs on int8 CUDA tensors, and what it says
    when it does not: the library call an int8 conv would be timed
    against."""
    x = torch.ones((1, 32, 8, 8), dtype=torch.int8, device=device)
    w = torch.ones((32, 32, 3, 3), dtype=torch.int8, device=device)
    try:
        F.conv2d(x, w, padding=1)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return {"runs": False, "error": str(e).splitlines()[0][:200]}
    return {"runs": True, "error": None}


#: kernel classes of the forward's profile, by substrings of kernel names:
#: Q1, cuBLASLt's int8 products (the transposed convs), and the rest
#: (quantization, pooling, the fp32 head, copies)
KERNEL_CLASSES = (("q1", ("int8_conv_kernel",)),
                  ("int_mm", ("gemm", "imma", "xmma", "cutlass", "cublas")))
PROFILED_FORWARDS = 3


def forward_profile(apply, qvars, x) -> dict:
    """``PROFILED_FORWARDS`` calls of ``apply(qvars, x)`` under
    ``torch.profiler`` after one warm-up call: the card's kernel time per
    forward by class and its busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    apply(qvars, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_FORWARDS):
            apply(qvars, x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_class.values())
    return {"forwards": PROFILED_FORWARDS,
            "wall_ms": wall_us / 1e3 / PROFILED_FORWARDS,
            "device_ms": {c: us / 1e3 / PROFILED_FORWARDS
                          for c, us in by_class.items()},
            "busy_share": busy / wall_us if busy else None}


def profile_summary(prof) -> str:
    if prof["busy_share"] is None:
        return "profile: no device time recorded (not measured)"
    parts = ", ".join(f"{c} {ms:.2f}" for c, ms in sorted(
        prof["device_ms"].items(), key=lambda kv: -kv[1]))
    return (f"profile: card busy {100 * prof['busy_share']:.1f}% of "
            f"{prof['wall_ms']:.2f} ms per forward, kernel ms: {parts}")


def time_case(rng, case, batch, device, int8_library=False):
    """One conv: Q1 against its plain version (bit for bit, raises on a
    difference), Q1 single and queued, the plain version, the cuDNN bf16
    conv and, where ``F.conv2d`` takes int8, that call."""
    c_skip, cin, cout, side, int8_out = case
    x, w, a, b, scale, skip = case_inputs(rng, case, batch, device)
    packed = int8_conv.pack_conv(w, a, b, c_skip or None)
    got = int8_conv.int8_conv3x3_packed(x, packed, scale, skip)
    ref = int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip)
    torch.cuda.synchronize()
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        diff = (got.float() - ref.float()).abs()
        raise AssertionError(
            f"Q1 differs from its plain version at {case}: "
            f"{int((diff > 0).sum())} values, max |diff| {float(diff.max())}")
    n_ops, n_bytes = ops_and_bytes(case, batch)
    row = {"c_skip": c_skip, "cin": cin, "cout": cout, "h": side,
           "batch": batch, "out": "int8" if int8_out else "fp32",
           "tile": int8_conv.conv_tile(side, side), "max_abs_err": 0.0,
           "ops": n_ops, "bytes": n_bytes,
           "single_ms": time_ms(
               lambda: int8_conv.int8_conv3x3_packed(x, packed, scale, skip)),
           "queued_ms": time_ms(
               lambda: int8_conv.int8_conv3x3_packed(x, packed, scale, skip),
               calls=QUEUED)}
    row["bound_ms"], row["bound_by"] = bound(n_ops, n_bytes)
    row["tops"] = n_ops / row["queued_ms"] / 1e9
    row["plain_ms"] = time_ms(
        lambda: int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip),
        reps=3, warmup=1)
    xf = (x if skip is None else torch.cat([skip, x], -1)).permute(
        0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wf = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    af, bf = a.to(torch.bfloat16), b.to(torch.bfloat16)

    def cudnn():
        z = F.conv2d(xf, wf, padding=1)
        return torch.relu(z * af[:, None, None] + bf[:, None, None])

    row["bf16_cudnn_ms"] = time_ms(cudnn)
    if int8_library:
        xi = xf.to(torch.int8)
        wi = w.permute(3, 2, 0, 1).contiguous()
        row["library_ms"] = time_ms(lambda: F.conv2d(xi, wi, padding=1))
    del x, w, skip, got, ref, xf, wf, packed
    return row


TILE_SIDES = (16, 8)


def time_tiles(rng, case, batch, device):
    """One conv queued at each of Q1's output tiles, each held bit for bit
    against the plain version: {"h", "picked", "queued_ms": {side: ms}}."""
    c_skip, cin, cout, side, int8_out = case
    x, w, a, b, scale, skip = case_inputs(rng, case, batch, device)
    packed = int8_conv.pack_conv(w, a, b, c_skip or None)
    ref = int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip)
    row = {"c_skip": c_skip, "cin": cin, "cout": cout, "h": side,
           "batch": batch, "picked": int8_conv.conv_tile(side, side),
           "queued_ms": {}}
    for t in TILE_SIDES:
        got = int8_conv.int8_conv3x3_packed(x, packed, scale, skip, tile=t)
        if not torch.equal(got, ref):
            raise AssertionError(f"Q1 at tile {t} differs from its plain "
                                 f"version at {case}")
        row["queued_ms"][t] = time_ms(
            lambda: int8_conv.int8_conv3x3_packed(x, packed, scale, skip,
                                                  tile=t), calls=QUEUED)
    del x, w, skip, ref, packed
    return row


def tiles_summary(row):
    ms = row["queued_ms"]
    return (f"Q1 {row['c_skip']:>3}+{row['cin']:>3}->{row['cout']:>3} "
            f"{row['batch']}x{row['h']}^2 queued: "
            + ", ".join(f"tile {t} {ms[t]:.3f} ms" for t in TILE_SIDES)
            + f"; the rule picks {row['picked']}")


def summary(row):
    return (f"Q1 {row['c_skip']:>3}+{row['cin']:>3}->{row['cout']:>3} "
            f"{row['batch']}x{row['h']}^2 {row['out']} [tile {row['tile']}]"
            f": queued {row['queued_ms']:.3f} ms ({row['tops']:.1f} TOPS), "
            f"single {row['single_ms']:.3f}, bound {row['bound_ms']:.4f} by "
            f"{row['bound_by']}, plain {row['plain_ms']:.3f}"
            f", cuDNN bf16 {row['bf16_cudnn_ms']:.3f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--tile", type=int, default=288)
    p.add_argument("--forward", action="store_true",
                   help="also profile the whole int8 forward")
    p.add_argument("--tiles", action="store_true",
                   help="also time each conv at both output tiles")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(0)
    library = int8_library_conv(dev)
    print(f"F.conv2d on int8 CUDA tensors: {library}")
    rows = []
    for case in conv_cases(UNetConfig(), args.tile):
        rows.append(time_case(rng, case, args.batch, dev, library["runs"]))
        print(summary(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    totals = {k: sum(r[k] for r in rows)
              for k in ("queued_ms", "single_ms", "plain_ms", "bf16_cudnn_ms",
                        "bound_ms", "ops")}
    print(f"Q1 over the 18 convs: queued {totals['queued_ms']:.3f} ms, single "
          f"{totals['single_ms']:.3f}, bound {totals['bound_ms']:.3f}, plain "
          f"{totals['plain_ms']:.3f}, cuDNN bf16 "
          f"{totals['bf16_cudnn_ms']:.3f}")
    out = {"device": smi, "library": library, "rows": rows,
           "totals": totals}
    if args.tiles:
        out["tiles"] = []
        for case in conv_cases(UNetConfig(), args.tile):
            out["tiles"].append(time_tiles(rng, case, args.batch, dev))
            print(tiles_summary(out["tiles"][-1]), flush=True)
            torch.cuda.empty_cache()
    if args.forward:
        from plumekit_torch.models import build_model
        from plumekit_torch.models.quantized_forward import (
            make_quantized_apply, quantize_unet)

        model = build_model(UNetConfig(), torch.Generator().manual_seed(0)
                            ).to(dev).eval()
        x = torch.rand((args.batch, args.tile, args.tile, 2),
                       generator=torch.Generator().manual_seed(0)).to(dev)
        out["forward"] = forward_profile(
            make_quantized_apply(UNetConfig()),
            quantize_unet(model, UNetConfig(), x[:9]), x)
        print("int8 forward " + profile_summary(out["forward"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/int8_conv_times.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
