"""The whole-forward kernel K7 beside the designs its redesign dropped, stage
by stage, in one process on one card.

Each variant is the committed source of ``csrc/unet_mega.cu`` with named
text edits (built by ``nvcc`` into a temporary directory with the flags of
``cuda_build``), or the committed kernel launched with another stage table:

* ``lean``: the kernel as committed;
* ``general``: the general instantiation for every plan (it also holds the
  wgmma head and the chunked upsample, which the flagship net never runs);
* ``noinline_mma``: the mma.sync double conv behind a ``__noinline__`` call,
  compiled apart from the wgmma code;
* ``chunked_up``: the wgmma stages' upsample staged chunk by chunk from
  device memory and written as 4-byte pairs (the parent's), so no split
  either;
* ``no_split``, ``no_reuse``: the committed kernel with the bottleneck not
  split, or with every plane in a room of its own.

Times are queued (20 launches per pair of CUDA events); stage k is
prefix(k) − prefix(k − 1). ``python -m
plumekit_torch.experiments.mega_variants [--tiles 96 288] [--out PATH]``
on a card; writes ``chiprun_out/mega_variants.json``."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from plumekit_torch import cuda_build
from plumekit_torch.config import UNetConfig
from plumekit_torch.experiments.mega_stage_times import seeded_unet, time_ms
from plumekit_torch.models.kernels import unet_mega

NOINLINE = '''template <bool HEAD>
__device__ __noinline__ void mma_double_conv_call(uint16_t* smem,
                                                  const MegaStage& st,
                                                  Item it, uint16_t* keep) {
  double_conv_tile<kTile, kTile, kKC, HEAD>(smem, st.src, st.w, it.b0, st.H,
                                            st.W, it.ty0, it.tx0,
                                            HEAD ? nullptr : st.out, st.head,
                                            keep, kKeepPitch);
}

// One mma.sync item:'''

#: name → (source edits (old, new), plan options)
VARIANTS = {
    "lean": ([], {}),
    "general": ([("general = general || (st.kind",
                  "general = true || (st.kind")], {}),
    "noinline_mma": ([
        ("// One mma.sync item:", NOINLINE),
        ("""    double_conv_tile<kTile, kTile, kKC, true>(mma_smem, st.src, st.w, it.b0,
                                              st.H, st.W, it.ty0, it.tx0,
                                              nullptr, st.head);""",
         "    mma_double_conv_call<true>(mma_smem, st, it, nullptr);"),
        ("""  double_conv_tile<kTile, kTile, kKC, false>(mma_smem, st.src, st.w, it.b0,
                                             st.H, st.W, it.ty0, it.tx0,
                                             st.out, st.head, keep,
                                             kKeepPitch);""",
         "  mma_double_conv_call<false>(mma_smem, st, it, keep);")], {}),
    "chunked_up": ([("st.rows = st.kind == kUp &&",
                     "st.rows = st.kind == kUp && st.path == 0 &&")],
                   {"split": False}),
    "no_split": ([], {"split": False}),
    "no_reuse": ([], {"reuse": False}),
}


def build(name, edits, tmp):
    """The variant's library path; the committed one for no edits."""
    if not edits:
        return str(cuda_build._lib_path("unet_mega.cu"))
    src_dir = os.path.join(tmp, name)
    shutil.copytree(cuda_build.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, "unet_mega.cu")
    text = open(path).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: no {old[:40]!r} in the source")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         os.path.join(src_dir, "lib.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def prefixes(lib, weights, x, opts, reps):
    """Queued ms of the first k stages, k = 1 .. stages, of the variant's
    stage table."""
    b, h, w, _ = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan, elems = unet_mega._plan(
        weights.stages, b, h, w, reuse=opts.get("reuse", True),
        blocks=sms if opts.get("split", True) else None)
    arr = (ctypes.c_longlong * plan.size)(*plan.ravel().tolist())
    scratch = torch.empty(elems, dtype=x.dtype, device=x.device)
    logits = torch.empty((b, h, w, 1), dtype=torch.float32, device=x.device)

    def launch(k):
        err = lib.pk_unet_mega(
            x.data_ptr(), weights.blob.data_ptr(), scratch.data_ptr(),
            logits.data_ptr(), ctypes.addressof(arr), k, b,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.pk_error_string(err).decode())

    return [time_ms(lambda k=k: launch(k), reps=reps)
            for k in range(1, len(plan) + 1)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[96, 288])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default="chiprun_out/mega_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_build.load_libraries(["unet_mega.cu"])
    res = {"device": smi, "batch": args.batch, "tiles": {}, "ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: build(name, edits, tmp)
                  for name, (edits, _opts) in VARIANTS.items()}
        libs = {}
        for name, b in builds.items():
            if isinstance(b, str):
                libs[name] = b
                continue
            _out, err = b.communicate()
            if b.returncode:
                raise RuntimeError(f"variant {name} does not build:\n{err}")
            res["ptxas"][name] = [line.strip() for line in err.splitlines()
                                  if "spill" in line or "registers" in line]
            libs[name] = os.path.join(tmp, name, "lib.so")
        model = seeded_unet(UNetConfig(), 0, dev)
        weights = unet_mega.weights_of(model, torch.bfloat16, dev)
        rng = np.random.default_rng(0)
        order = list(VARIANTS) + ["lean"]
        for tile in args.tiles:
            x = torch.from_numpy(rng.standard_normal(
                (args.batch, tile, tile, 2), dtype=np.float32)
            ).to(dev).to(torch.bfloat16)
            rows = []
            for name in order:
                cuda_build._LOADED["unet_mega.cu"] = ctypes.CDLL(libs[name])
                lib = unet_mega._library()
                pre = prefixes(lib, weights, x, VARIANTS[name][1],
                               reps=3 if tile > 96 else 5)
                stages = [pre[0]] + [b - a for a, b in zip(pre, pre[1:])]
                rows.append({"variant": name, "ms": pre[-1],
                             "stages": stages})
                print(f"{name:>13} {args.batch}x{tile}^2: {pre[-1]:.3f} ms; "
                      "stages " + " ".join(f"{v:.3f}" for v in stages),
                      flush=True)
            res["tiles"][str(tile)] = rows
            del x
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
