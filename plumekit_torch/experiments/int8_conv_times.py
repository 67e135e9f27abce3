"""Times of the int8 forward's kernels on the card. Q1, the int8 conv, per
conv: the eighteen 3×3 convs of ``UNetConfig()`` at a batch of 288² tiles
(the decoder blocks' first convs read the skip and the upsampled half as two
planes, the last conv writes fp32), each beside its plain version (nine
``torch._int_mm`` over shifted copies) and the cuDNN bf16 convolution of the
same shape with scale, shift and ReLU (the bf16 forward's conv, for
context). Q2, the transposed conv with its requant, per upsample: beside its
plain version (``torch._int_mm`` and the eager dequant, shuffle and requant:
the forward's path before Q2) and ``torch._int_mm`` of the same product
alone. ``single_ms`` is one launch per pair of CUDA events, ``queued_ms``
20, which leaves the wrapper's host time out; the bound is the larger of the
operations at the data sheet's 1,979 int8 TOPS and the bytes at 3,350 GB/s.
Each case is also held against its plain version, bit for bit. With
``--forward`` it also profiles the whole int8 forward of a seeded
``UNetConfig()`` at the same batch (``torch.profiler``: the card's time by
class, Q1, Q2, ``torch._int_mm`` and the other kernels by their place in the
forward, and its busy share). With ``--tiles`` it times each conv and each
upsample queued at every shape the kernel may take (``shape_candidates``,
``upsample_candidates``), each held bit for bit, beside the shape the rule
picks. ``--upsamples T [T ...]`` times only Q2: each upsample at each
tile side T, alone and at every shape it may take (the rule's table).
``python -m plumekit_torch.experiments.int8_conv_times [--batch 128]
[--tile 288] [--forward] [--tiles] [--upsamples 288 256 384 512] [--out
PATH]`` on a card; prints one line per case and writes its JSON to
``--out``.

For a UNet++ config, :func:`conv_cases` and :func:`upsample_cases` list its
int8 forward's convs and upsamples, and :func:`concat_cases` and
:func:`time_concat` the ``torch.cat`` that joins each node's same-scale
planes into Q1's first source (``chip_smoke.py``'s UNet++ phase)."""

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
from plumekit_torch.models.kernels import int8_conv, int8_upsample

QUEUED = 20   # launches per event pair of the queued reading
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def conv_cases(cfg: UNetConfig, tile: int):
    """(c_skip, c_in, c_out, side, int8 out) of the 2·(2·depth + 1) convs of
    the int8 forward; c_skip > 0 for a decoder block's first conv, which
    reads ``concat([skip, up])``; the last conv writes fp32 for the head.
    A UNet++ config takes :func:`unetpp_conv_cases`."""
    if cfg.arch == "unetpp":
        return unetpp_conv_cases(cfg, tile)
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


def unetpp_conv_cases(cfg: UNetConfig, tile: int):
    """The convs of the UNet++ int8 forward at ``effective_level(cfg)`` in
    launch order, as :func:`conv_cases`: node X[i][j]'s first conv reads
    the j same-scale planes (``c_skip = j·f_i``) and the upsample; the top
    row's second convs write fp32 where a head reads them (X[0][L], and
    under deep supervision every X[0][j])."""
    from plumekit_torch.models.unetpp import decoder_nodes, effective_level

    level = effective_level(cfg)
    f = [cfg.base_features * 2**i for i in range(level + 1)]
    cases = []
    for i in range(level + 1):
        cin = cfg.in_channels if i == 0 else f[i - 1]
        cases += [(0, cin, f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, True)]
    for i, j in decoder_nodes(level):
        fp32_out = i == 0 and (j == level or cfg.deep_supervision)
        cases += [(j * f[i], f[i], f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, not fp32_out)]
    return cases


def random_plane(rng, shape, low, device):
    """A uniform int8 plane in [low, 128) drawn on ``device`` by a generator
    seeded from ``rng``: a 128-tile plane takes milliseconds there and
    seconds through numpy on the host."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    return torch.randint(low, 128, shape, generator=gen, device=device,
                         dtype=torch.int8)


def case_inputs(rng, case, batch, device):
    """Seeded int8 planes and weights of one case, with a multiplier and a
    shift that spread the outputs over the int8 range: (x, w, a, b, scale,
    skip)."""
    c_skip, cin, cout, side, int8_out = case

    def plane(c, low):
        return random_plane(rng, (batch, side, side, c), low, device)

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


def upsample_cases(cfg: UNetConfig, tile: int):
    """(c_in, c_out, side of the input) of the forward's ``depth``
    transposed convs, the bottleneck's first; of a UNet++ its
    ``L(L + 1)/2`` upsamples ``up_i_j`` in launch order."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    if cfg.arch == "unetpp":
        from plumekit_torch.models.unetpp import decoder_nodes, effective_level

        return [(f[i + 1], f[i], tile >> (i + 1))
                for i, j in decoder_nodes(effective_level(cfg))]
    return [(f[cfg.depth - u], f[cfg.depth - 1 - u], tile >> (cfg.depth - u))
            for u in range(cfg.depth)]


def upsample_inputs(rng, case, batch, device):
    """Seeded (x, kq, sw, bias, scale) of one transposed conv, with ``sw``
    and ``bias`` that spread the outputs over the int8 range."""
    cin, cout, side = case
    x = random_plane(rng, (batch, side, side, cin), 0, device)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, cin, cout),
                                       dtype=np.int8)).to(device)
    sw = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 4.0
                           / (64 * 73 * cin ** 0.5)).astype(np.float32)
                          ).to(device)
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32)
                            ).to(device)
    scale = torch.tensor(12.0 / 127, dtype=torch.float32, device=device)
    return x, kq, sw, bias, scale


def upsample_ops_and_bytes(case, batch):
    """Integer operations and bytes moved once (input, kernel, sw, bias and
    the int8 output) of one transposed conv."""
    cin, cout, side = case
    px = batch * side * side
    return (2 * px * cin * 4 * cout,
            px * cin + 4 * cin * cout + 8 * cout + 4 * px * cout)


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


#: kernels of the forward's profile known by name: Q1 and Q2 (the kernels
#: of csrc/int8_conv.cu and csrc/int8_upsample.cu; neither name holds a key
#: of the other classes), and cuBLASLt's products
Q1_KEYS = ("int8_conv_kernel",)
Q2_KEYS = ("int8_upsample_kernel",)
GEMM_KEYS = ("gemm", "imma", "xmma", "cutlass", "cublas")
PROFILED_FORWARDS = 3


def place_class(n_q1: int, depth: int, name: str) -> str:
    """The class of a kernel that is neither Q1 nor Q2, by its place in
    the forward: ``n_q1`` Q1 launches came before it. Before the first
    conv it quantizes the input; after an encoder block's second conv it
    pools; after the bottleneck's or a decoder block's second conv, up to
    the next decoder block, it belongs to the transposed conv (a product,
    by name, or its glue: dequant, shuffle, requant); after the last conv
    it is the fp32 head."""
    if n_q1 == 0:
        return "input_quant"
    if n_q1 == 2 * (2 * depth + 1):
        return "head"
    if n_q1 % 2:
        return "rest"
    if n_q1 <= 2 * depth:
        return "max_pool"
    return "int_mm" if any(k in name for k in GEMM_KEYS) else "upsample_glue"


def classify_forward(names, depth: int):
    """The class of each kernel of one forward, ``names`` in launch order:
    Q1 and Q2 by name, every other kernel by :func:`place_class`."""
    classes = []
    n_q1 = 0
    for name in names:
        low = name.lower()
        if any(k in low for k in Q1_KEYS):
            classes.append("q1")
            n_q1 += 1
        elif any(k in low for k in Q2_KEYS):
            classes.append("q2")
        else:
            classes.append(place_class(n_q1, depth, low))
    return classes


def forward_profile(apply, qvars, x) -> dict:
    """``PROFILED_FORWARDS`` calls of ``apply(qvars, x)`` under
    ``torch.profiler`` after one warm-up call: the card's kernel time per
    forward by class (:func:`classify_forward`; every forward launches the
    same kernels in the same order, so the time-ordered list cuts into
    equal runs, one per forward), the longest kernels by class and name,
    and the card's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    depth = len(qvars["ups"])
    apply(qvars, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_FORWARDS):
            apply(qvars, x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.time_range.start, e.name, e.time_range.elapsed_us())
         for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda k: k[0])
    busy = sum(us for _, _, us in kernels)
    per = len(kernels) // PROFILED_FORWARDS
    by_class: dict = {}
    by_name: dict = {}
    if kernels and per * PROFILED_FORWARDS == len(kernels):
        for f in range(PROFILED_FORWARDS):
            run = kernels[f * per:(f + 1) * per]
            for (_, name, us), cls in zip(
                    run, classify_forward([k[1] for k in run], depth)):
                by_class[cls] = by_class.get(cls, 0.0) + us
                by_name[cls, name[:90]] = by_name.get((cls, name[:90]),
                                                      0.0) + us
    elif kernels:
        by_class["unsplit"] = busy
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    per_fwd = 1e3 * PROFILED_FORWARDS
    return {"forwards": PROFILED_FORWARDS, "kernels_per_forward": per,
            "wall_ms": wall_us / per_fwd,
            "device_ms": {c: us / per_fwd for c, us in by_class.items()},
            "top_kernels_ms": [[c, n, us / per_fwd] for (c, n), us in top],
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
    tile = int8_conv.conv_tile(side, side, batch, packed.shape)
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
           "tile": tile_label(tile), "max_abs_err": 0.0,
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


def concat_cases(cfg: UNetConfig, tile: int):
    """(node, planes, channels per plane, side) of the ``torch.cat`` calls
    of the UNet++ int8 forward: node X[i][j], j ≥ 2, joins its j
    same-scale int8 planes along channels into the first source of its
    first Q1 (X[i][0] alone serves j = 1, with no copy)."""
    from plumekit_torch.models.unetpp import decoder_nodes, effective_level

    level = effective_level(cfg)
    f = [cfg.base_features * 2**i for i in range(level + 1)]
    return [(f"x{i}_{j}", j, f[i], tile >> i)
            for i, j in decoder_nodes(level) if j >= 2]


def time_concat(rng, case, batch, device):
    """One concat queued: the copy of ``planes`` int8 planes into one, its
    bytes (every input read once, the output written once) and their bound
    at 3,350 GB/s."""
    node, planes, c, side = case
    srcs = [random_plane(rng, (batch, side, side, c), 0, device)
            for _ in range(planes)]
    n_bytes = 2 * planes * batch * side * side * c
    row = {"node": node, "planes": planes, "channels": planes * c, "h": side,
           "batch": batch, "bytes": n_bytes,
           "queued_ms": time_ms(lambda: torch.cat(srcs, dim=-1),
                                calls=QUEUED)}
    row["bound_ms"], row["bound_by"] = bound(0, n_bytes)
    row["gb_per_s"] = n_bytes / row["queued_ms"] / 1e6
    del srcs
    return row


def concat_summary(row):
    per = row["channels"] // row["planes"]
    return (f"cat {row['node']} {row['planes']}x{per} ch "
            f"{row['batch']}x{row['h']}^2: queued {row['queued_ms']:.3f}"
            f" ms ({row['gb_per_s']:.0f} GB/s), bound {row['bound_ms']:.4f}")


def shape_label(shape) -> str:
    if hasattr(shape, "slices"):      # Q2's: columns a pass, slices, tiles
        return f"{shape.nb}/{shape.slices}x{shape.mt}"
    return f"{shape.nb}x{shape.mt}" + ("-fold" if shape.fold else "")


def tile_label(tile) -> str:
    return (f"{shape_label(tile.shape)} {tile.th}x{tile.tw}"
            + (f"x{tile.images}" if tile.images > 1 else ""))


def time_tiles(rng, case, batch, device):
    """One conv queued at each shape it may take (its rule's tile at that
    shape), each held bit for bit against the plain version: {"h",
    "picked", "queued_ms": {shape: ms}}."""
    c_skip, cin, cout, side, int8_out = case
    x, w, a, b, scale, skip = case_inputs(rng, case, batch, device)
    c0, c1 = (c_skip, cin) if c_skip else (cin, 0)
    ref = int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip)
    row = {"c_skip": c_skip, "cin": cin, "cout": cout, "h": side,
           "batch": batch,
           "picked": shape_label(int8_conv.conv_shape(c0, c1, cout)),
           "queued_ms": {}, "tiles": {}}
    for shape in int8_conv.shape_candidates(c0, c1, cout):
        packed = int8_conv.pack_conv(w, a, b, c_skip or None, shape)
        got = int8_conv.int8_conv3x3_packed(x, packed, scale, skip)
        if not torch.equal(got, ref):
            raise AssertionError(f"Q1 at {shape} differs from its plain "
                                 f"version at {case}")
        key = shape_label(shape)
        row["tiles"][key] = tile_label(
            int8_conv.conv_tile(side, side, batch, shape))
        row["queued_ms"][key] = time_ms(
            lambda: int8_conv.int8_conv3x3_packed(x, packed, scale, skip),
            calls=QUEUED)
    del x, w, skip, ref, got
    return row


def tiles_summary(row, name="Q1"):
    ms = row["queued_ms"]
    where = (f"{row['c_skip']:>3}+{row['cin']:>3}->{row['cout']:>3}"
             if "c_skip" in row else f"{row['cin']:>3}->{row['cout']:>3}")
    return (f"{name} {where} {row['batch']}x{row['h']}^2 queued: "
            + ", ".join(f"{k} {ms[k]:.3f} ms" for k in ms)
            + f"; the rule picks {row['picked']}")


def time_upsample(rng, case, batch, device):
    """One transposed conv: Q2 against its plain version (bit for bit,
    raises on a difference), Q2 single and queued, the plain version (the
    forward's path before Q2: ``torch._int_mm`` and eager glue) and
    ``torch._int_mm`` of the same product alone."""
    cin, cout, side = case
    x, kq, sw, bias, scale = upsample_inputs(rng, case, batch, device)
    packed = int8_upsample.pack_upsample(kq, sw, bias)
    got = int8_upsample.int8_upsample2x2_packed(x, packed, scale)
    ref = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        diff = (got.float() - ref.float()).abs()
        raise AssertionError(
            f"Q2 differs from its plain version at {case}: "
            f"{int((diff > 0).sum())} values, max |diff| {float(diff.max())}")
    n_ops, n_bytes = upsample_ops_and_bytes(case, batch)
    a2 = x.reshape(-1, cin)
    cols = int8_upsample.upsample_columns(kq)
    row = {"cin": cin, "cout": cout, "h": side, "batch": batch,
           "shape": shape_label(packed.shape), "max_abs_err": 0.0,
           "ops": n_ops, "bytes": n_bytes,
           "single_ms": time_ms(
               lambda: int8_upsample.int8_upsample2x2_packed(x, packed,
                                                             scale)),
           "queued_ms": time_ms(
               lambda: int8_upsample.int8_upsample2x2_packed(x, packed,
                                                             scale),
               calls=QUEUED),
           # the launch alone, without the op's dispatch: where the kernel
           # takes under about 0.1 ms, the queued op measures the host
           "launch_ms": time_ms(
               lambda: int8_upsample._launch(x, packed, scale), calls=QUEUED),
           "plain_ms": time_ms(
               lambda: int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias,
                                                          scale), reps=5),
           "int_mm_ms": time_ms(lambda: int8_conv.int_mm(a2, cols))}
    row["bound_ms"], row["bound_by"] = bound(n_ops, n_bytes)
    row["gb_per_s"] = n_bytes / row["queued_ms"] / 1e6
    del x, kq, got, ref, a2
    return row


def time_upsample_tiles(rng, case, batch, device):
    """One transposed conv queued at each shape it may take, each held bit
    for bit against the plain version."""
    cin, cout, side = case
    x, kq, sw, bias, scale = upsample_inputs(rng, case, batch, device)
    ref = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
    row = {"cin": cin, "cout": cout, "h": side, "batch": batch,
           "picked": shape_label(int8_upsample.upsample_shape(cin, cout)),
           "queued_ms": {}}
    for shape in int8_upsample.upsample_candidates(cin, cout):
        # the launch itself: the op takes each pass width's default item
        packed = int8_upsample.pack_upsample(kq, sw, bias, shape)
        got = int8_upsample._launch(x, packed, scale)
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()
            raise AssertionError(
                f"Q2 at {shape} differs from its plain version at {case}: "
                f"{len(bad)} values, first (b, y, x, o) {bad[:4].tolist()}, "
                f"rows y {bad[:, 1].unique()[:16].tolist()}")
        row["queued_ms"][shape_label(shape)] = time_ms(
            lambda: int8_upsample._launch(x, packed, scale), calls=QUEUED)
    del x, kq, ref
    return row


#: the phases between Q2's stamps, in order
STAMP_PHASES = ("turn", "input", "mma", "buffer", "epilogue", "store")


def upsample_stamps(rng, case, batch, device):
    """Where a pass of Q2's consumers goes, at the rule's shape: clocks
    between the stamps of block 0's consumers (``int8_upsample._launch``'s
    ``stamps``) over their first passes after two: the wait for the turn
    (the item before seen landed), for the input, the wgmmas, the wait
    for the output buffer, the epilogue and the stores' issue; the mean
    of each and its share."""
    x, kq, sw, bias, scale = upsample_inputs(rng, case, batch, device)
    packed = int8_upsample.pack_upsample(kq, sw, bias)
    stamps = torch.zeros((3, int8_upsample.STAMP_PASSES,
                          int8_upsample.STAMP_POINTS), dtype=torch.int64,
                         device=device)
    for _ in range(2):          # the second launch is the one read
        int8_upsample._launch(x, packed, scale, stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()
    rows = [r for g in range(3) for r in st[g, 2:] if r[0] and r[-1]]
    d = np.diff(np.asarray(rows, dtype=np.float64), axis=1)
    mean = d.mean(axis=0) if len(d) else np.zeros(len(STAMP_PHASES))
    total = float(mean.sum())
    return {"cin": case[0], "cout": case[1], "h": case[2], "batch": batch,
            "shape": shape_label(packed.shape), "passes": len(rows),
            "cycles": dict(zip(STAMP_PHASES, map(float, mean))),
            "share": {k: float(v / total) if total else 0.0
                      for k, v in zip(STAMP_PHASES, mean)}}


def stamps_summary(row):
    return (f"Q2 {row['cin']:>3}->{row['cout']:>3} {row['batch']}x"
            f"{row['h']}^2 [{row['shape']}] clocks a pass: " + ", ".join(
                f"{k} {row['cycles'][k]:.0f} ({100 * row['share'][k]:.0f}%)"
                for k in STAMP_PHASES) + f" over {row['passes']} passes")


def upsample_summary(row):
    return (f"Q2 {row['cin']:>3}->{row['cout']:>3} {row['batch']}x"
            f"{row['h']}^2 [{row['shape']}]: queued {row['queued_ms']:.3f} "
            f"ms ({row['gb_per_s']:.0f} GB/s; the launch alone "
            f"{row['launch_ms']:.3f}), single {row['single_ms']:.3f}"
            f", bound {row['bound_ms']:.4f} by {row['bound_by']}, plain "
            f"(int_mm + glue) {row['plain_ms']:.3f}, int_mm alone "
            f"{row['int_mm_ms']:.3f}")


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
                   help="also time and profile the whole int8 forward")
    p.add_argument("--tiles", action="store_true",
                   help="also time each case at every shape it may take")
    p.add_argument("--upsamples", type=int, nargs="+", default=None,
                   metavar="T", help="time only Q2, at these tile sides, "
                   "at every shape it may take")
    p.add_argument("--out", default="chiprun_out/int8_conv_times.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_conv_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    cfg = UNetConfig()
    rng = np.random.default_rng(0)
    if args.upsamples:
        out = {"device": smi, "batch": args.batch, "by_tile": {}}
        for tile in args.upsamples:
            rows, shapes = [], []
            for case in upsample_cases(cfg, tile):
                rows.append(time_upsample(rng, case, args.batch, dev))
                print(upsample_summary(rows[-1]), flush=True)
                shapes.append(time_upsample_tiles(rng, case, args.batch,
                                                  dev))
                print(tiles_summary(shapes[-1], "Q2"), flush=True)
                shapes[-1]["stamps"] = upsample_stamps(rng, case,
                                                       args.batch, dev)
                print(stamps_summary(shapes[-1]["stamps"]), flush=True)
                torch.cuda.empty_cache()
            out["by_tile"][tile] = {"rows": rows, "shapes": shapes}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        return 0
    library = int8_library_conv(dev)
    print(f"F.conv2d on int8 CUDA tensors: {library}")
    rows = []
    for case in conv_cases(cfg, args.tile):
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
    up_rows = []
    for case in upsample_cases(cfg, args.tile):
        up_rows.append(time_upsample(rng, case, args.batch, dev))
        print(upsample_summary(up_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    up_totals = {k: sum(r[k] for r in up_rows)
                 for k in ("queued_ms", "launch_ms", "single_ms", "plain_ms",
                           "int_mm_ms", "bound_ms", "bytes")}
    print(f"Q2 over the {len(up_rows)} upsamples: queued "
          f"{up_totals['queued_ms']:.3f} ms (the launch alone "
          f"{up_totals['launch_ms']:.3f}), single "
          f"{up_totals['single_ms']:.3f}, bound {up_totals['bound_ms']:.3f},"
          f" plain (int_mm + glue) {up_totals['plain_ms']:.3f}, int_mm alone"
          f" {up_totals['int_mm_ms']:.3f}")
    out = {"device": smi, "library": library, "rows": rows,
           "totals": totals, "upsample_rows": up_rows,
           "upsample_totals": up_totals}
    if args.tiles:
        out["tiles"] = []
        for case in conv_cases(cfg, args.tile):
            out["tiles"].append(time_tiles(rng, case, args.batch, dev))
            print(tiles_summary(out["tiles"][-1]), flush=True)
            torch.cuda.empty_cache()
        out["upsample_tiles"] = []
        for case in upsample_cases(cfg, args.tile):
            out["upsample_tiles"].append(
                time_upsample_tiles(rng, case, args.batch, dev))
            print(tiles_summary(out["upsample_tiles"][-1], "Q2"), flush=True)
            torch.cuda.empty_cache()
    if args.forward:
        from plumekit_torch.models import build_model
        from plumekit_torch.models.quantized_forward import (
            make_quantized_apply, quantize_unet)

        model = build_model(cfg, torch.Generator().manual_seed(0)
                            ).to(dev).eval()
        x = torch.rand((args.batch, args.tile, args.tile, 2),
                       generator=torch.Generator().manual_seed(0)).to(dev)
        apply = make_quantized_apply(cfg)
        qvars = quantize_unet(model, cfg, x[:9])
        out["forward"] = forward_profile(apply, qvars, x)
        out["forward"]["ms"] = time_ms(lambda: apply(qvars, x), reps=5)
        print(f"int8 forward {out['forward']['ms']:.3f} ms; "
              + profile_summary(out["forward"]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
