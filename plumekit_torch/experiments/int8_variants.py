"""Where Q1's and Q2's time goes: ``csrc/int8_conv.cu`` and
``csrc/int8_upsample.cu`` built again with one phase of each step taken
out, and each copy timed against the kernel at the same cases (queued CUDA
events, 20 launches per pair). A copy's output is wrong by design; only its
time is read.

Copies: ``kernel`` (unchanged, timed first and last); ``no_epilogue`` (the
dequant, quotient, rounding and clamp of each result replaced by one
integer operation); ``clamp_y`` (Q2's epilogue clamps y to ±128·s before
the quotient even where no quotient can overflow); ``no_sync`` (Q2's wait
of the storing warp for the other warps' epilogues taken out);
``no_mma_wait`` (Q2's wait for its wgmmas taken out); ``fdiv`` (Q1's
quotient by ``__fdiv_rn`` per result, as its first version took it);
``no_mma`` (no wgmma: the staged operands are read by nothing);
``no_store`` (nothing leaves the stash or the output tile); ``no_load_a``
(the input is never staged: Q1's loads skipped, Q2's stages released
without a copy; the weights still are). The time a phase
takes is at least the kernel's time less the copy's. ``python -m
plumekit_torch.experiments.int8_variants [--batch 128] [--cases q2]
[--out PATH]`` on a card; prints one line per case and copy and writes
``chiprun_out/int8_variants.json`` (or PATH)."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from plumekit_torch import cuda_build
from plumekit_torch.experiments import int8_conv_times as times
from plumekit_torch.models.kernels import int8_conv, int8_upsample
from plumekit_torch.models.kernels.int8_conv import Shape

#: the sources each copy is built from, and the header they share
SOURCES = ("int8_conv.cu", "int8_upsample.cu")
HEADER = "int8_wgmma.cuh"

#: the quantizer's quotient, as the header writes it
QUOTIENT = ("    const float q0 = __fmul_rn(y, r);\n"
            "    float q = __fmaf_rn(__fmaf_rn(-s, q0, y), r, q0);\n"
            "    q = __fmaf_rn(__fmaf_rn(-s, q, y), r, q);")

#: each copy: (file, text of the kernel, its replacement); every one must
#: apply exactly once
VARIANTS = {
    "kernel": [],
    "no_epilogue": [
        (HEADER,
         "    const float y = fminf(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn("
         "acc), a),", "    return static_cast<int8_t>(acc ^ __float_as_int("
         "a + b));\n    const float y = fminf(fmaxf(__fadd_rn(__fmul_rn("
         "__int2float_rn(acc), a),"),
        ("int8_conv.cu",
         "  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), "
         "0.f);", "  return __int_as_float(acc ^ __float_as_int(a + b));"),
        ("int8_upsample.cu",
         "  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);",
         "  return (uint32_t)acc ^ __float_as_uint(a + b);\n"
         "  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);")],
    "clamp_y": [("int8_upsample.cu", "        if (no_overflow)\n",
                 "        if (false)\n")],
    "no_sync": [("int8_upsample.cu", "        if (tid < 32) {\n"
                 "          bar_sync(1 + C + g);\n", "        if (tid < 32) {\n")],
    "no_mma_wait": [("int8_upsample.cu",
                     "        wgmma_commit();\n        wgmma_wait<0>();",
                     "        wgmma_commit();")],
    "fdiv": [(HEADER, QUOTIENT, "    const float q = __fdiv_rn(y, s);")],
    "no_mma": [
        ("int8_conv.cu", "      WgS8<NB>::mma(acc[i], da, db);",
         "      acc[i][0] += (int)(da ^ db);"),
        ("int8_upsample.cu",
         "            WgS8<NB>::mma(acc[i], desc_sw(at + i * 64 * KB + 32 * s,"
         " KB), db);",
         "            acc[i][0] += (int)(desc_sw(at + i * 64 * KB + 32 * s, "
         "KB) ^ db);")],
    "no_store": [
        ("int8_conv.cu",
         "  for (int u = threadIdx.x; u < R * upr; u += kThreads) {",
         "  for (int u = threadIdx.x; u < 0 * R * upr; u += kThreads) {"),
        ("int8_upsample.cu",
         "          for (int st = 0; st < NB / cb; ++st) {",
         "          for (int st = 0; st < 0 * NB / cb; ++st) {")],
    "no_load_a": [
        ("int8_conv.cu",
         "    if constexpr (MODE == kRaster)\n      load_a_raster(",
         "    if constexpr (MODE == kRaster && false)\n      load_a_raster("),
        ("int8_conv.cu", "    else\n      load_raw_fold(",
         "    else if constexpr (false)\n      load_raw_fold("),
        ("int8_upsample.cu",
         "          mbar_expect_tx(full, (uint32_t)(p.kb * p.n * p.k));\n"
         "          tma_load_3d(dst, &p.x_map, c * p.kb, j0, r0, full);",
         "          mbar_arrive(full);")],
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
    ("q2 512->256 18", (512, 256, 18), None),
    ("q2 256->128 36", (256, 128, 36), None),
    ("q2 128->64 72", (128, 64, 72), None),
    ("q2 64->32 144", (64, 32, 144), None),
)


def build_variants(names, sources=SOURCES):
    """Each copy's libraries, one per source of ``sources``, built side by
    side into the build directory: {name: {source: library}}. Every edit
    of a copy must apply, whichever sources are built."""
    procs = {}
    for name in names:
        out_dir = cuda_build.BUILD_DIR / "variants" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        texts = {f: (cuda_build.CSRC_DIR / f).read_text()
                 for f in (*SOURCES, HEADER)}
        for f, old, new in VARIANTS[name]:
            if texts[f].count(old) != 1:
                raise RuntimeError(f"{name}: {f} no longer holds {old!r}")
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (out_dir / f).write_text(text)
        # the copy's sources find its header beside them first
        shutil.copy(cuda_build.CSRC_DIR / "conv_tiles.cuh", out_dir)
        for src in sources:
            so = out_dir / src.replace(".cu", ".so")
            procs[name, src] = (so, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                 str(out_dir / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for (name, src), (so, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{err}")
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(so))
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
    p.add_argument("--cases", default="",
                   help="only the cases whose name starts with this")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    picked = [c for c in CASES if c[0].startswith(args.cases)]
    libs = build_variants(list(VARIANTS), sorted(
        {"int8_conv.cu" if len(case) == 5 else "int8_upsample.cu"
         for _, case, _ in picked}))
    order = list(VARIANTS) + ["kernel"]
    rows = []
    for name, case, shape in picked:
        call = case_call(case, shape, args.batch, dev,
                         np.random.default_rng(0))
        row = {"case": name, "ms": {}}
        for variant in order:
            # the wrappers load their libraries through this table
            cuda_build._LOADED.update(libs[variant])
            print(f"{name}: {variant} ...", file=sys.stderr, flush=True)
            ms = times.time_ms(call, calls=times.QUEUED)
            key = variant if variant not in row["ms"] else variant + "_2"
            row["ms"][key] = ms
        rows.append(row)
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in row["ms"].items()),
              flush=True)
        torch.cuda.empty_cache()
    for src in SOURCES:
        cuda_build._LOADED.pop(src, None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "batch": args.batch, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
