"""Where Q1's and Q2's time goes: ``csrc/int8_conv.cu`` built again with one
phase of each step taken out, and each copy timed against the kernel at the
same cases (queued CUDA events, 20 launches per pair). A copy's output is
wrong by design; only its time is read.

Copies: ``kernel`` (unchanged, timed first and last); ``no_epilogue`` (the
dequant, quotient, rounding and clamp of each result replaced by one
integer operation); ``fdiv`` (the quotient by ``__fdiv_rn`` per result, as
the first version of the kernel took it); ``no_mma`` (no wgmma: the staged operands are read by
nothing); ``no_store`` (nothing leaves the stash); ``no_load_a`` (the input
is never staged; the weights still are). The time a phase takes is at least
the kernel's time less the copy's. ``python -m
plumekit_torch.experiments.int8_variants [--batch 128] [--out PATH]`` on a
card; prints one line per case and copy and writes
``chiprun_out/int8_variants.json`` (or PATH)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from plumekit_torch import cuda_build
from plumekit_torch.experiments import int8_conv_times as times
from plumekit_torch.models.kernels import int8_conv, int8_upsample
from plumekit_torch.models.kernels.int8_conv import Shape

#: the quantizer's quotient, as the kernel writes it
QUOTIENT = ("    const float q0 = __fmul_rn(y, r);\n"
            "    float q = __fmaf_rn(__fmaf_rn(-s, q0, y), r, q0);\n"
            "    q = __fmaf_rn(__fmaf_rn(-s, q, y), r, q);")

#: each copy: (text of the kernel, its replacement), every one must apply
VARIANTS = {
    "kernel": [],
    "no_epilogue": [
        ("    const float y = fminf(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn("
         "acc), a),", "    return static_cast<int8_t>(acc ^ __float_as_int("
         "a + b));\n    const float y = fminf(fmaxf(__fadd_rn(__fmul_rn("
         "__int2float_rn(acc), a),"),
        ("  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), "
         "0.f);", "  return __int_as_float(acc ^ __float_as_int(a + b));")],
    "fdiv": [(QUOTIENT, "    const float q = __fdiv_rn(y, s);")],
    "no_mma": [("      WgS8<NB>::mma(acc[i], da, db);",
                "      acc[i][0] += (int)(da ^ db);")],
    "no_store": [("  for (int u = threadIdx.x; u < R * upr; u += kThreads) {",
                  "  for (int u = threadIdx.x; u < 0 * R * upr; "
                  "u += kThreads) {")],
    "no_load_a": [("    if constexpr (MODE == kRaster)\n"
                   "      load_a_raster(",
                   "    if constexpr (MODE == kRaster && false)\n"
                   "      load_a_raster("),
                  ("    else if constexpr (MODE == kFold)\n"
                   "      load_raw_fold(",
                   "    else if constexpr (MODE == kFold && false)\n"
                   "      load_raw_fold("),
                  ("    else\n      load_a_point<R>(",
                   "    else if constexpr (false)\n      load_a_point<R>(")],
}

#: (name, conv case or upsample case, shape)
CASES = (
    ("q1 2->32 288 fold", (0, 2, 32, 288, True), Shape(32, 4, True)),
    ("q1 32->32 288", (0, 32, 32, 288, True), Shape(32, 4)),
    ("q1 32->32 288 fp32", (0, 32, 32, 288, False), Shape(32, 4)),
    ("q1 64->64 144", (0, 64, 64, 144, True), Shape(64, 2)),
    ("q1 128->128 72", (0, 128, 128, 72, True), Shape(64, 2)),
    ("q1 256->256 36", (0, 256, 256, 36, True), Shape(64, 2)),
    ("q1 256->256 36 128x2", (0, 256, 256, 36, True), Shape(128, 2)),
    ("q1 512->512 18 256x1", (0, 512, 512, 18, True), Shape(256, 1)),
    ("q2 64->32 144", (64, 32, 144), Shape(64, 2)),
    ("q2 512->256 18", (512, 256, 18), Shape(128, 2)),
)


def build_variants(names):
    """Each copy's library, built side by side into the build directory."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC_DIR / "int8_conv.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"int8_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"int8_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def case_call(case, shape, batch, device, rng):
    """A no-argument call of the wrapper at one case on packed weights."""
    if len(case) == 5:
        c_skip, cin, cout, side, int8_out = case
        x, w, a, b, scale, skip = times.case_inputs(rng, case, batch, device)
        packed = int8_conv.pack_conv(w, a, b, c_skip or None, shape)
        return lambda: int8_conv.int8_conv3x3_packed(x, packed, scale, skip)
    x, kq, sw, bias, scale = times.upsample_inputs(rng, case, batch, device)
    packed = int8_upsample.pack_upsample(kq, sw, bias, shape)
    return lambda: int8_upsample.int8_upsample2x2_packed(x, packed, scale)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--out", default="chiprun_out/int8_variants.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = build_variants(list(VARIANTS))
    order = list(VARIANTS) + ["kernel"]
    rows = []
    for name, case, shape in CASES:
        call = case_call(case, shape, args.batch, dev,
                         np.random.default_rng(0))
        row = {"case": name, "ms": {}}
        for variant in order:
            # the wrappers load their library through this table
            cuda_build._LOADED["int8_conv.cu"] = libs[variant]
            ms = times.time_ms(call, calls=times.QUEUED)
            key = variant if variant not in row["ms"] else variant + "_2"
            row["ms"][key] = ms
        rows.append(row)
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in row["ms"].items()),
              flush=True)
        torch.cuda.empty_cache()
    cuda_build._LOADED.pop("int8_conv.cu", None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "batch": args.batch, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
