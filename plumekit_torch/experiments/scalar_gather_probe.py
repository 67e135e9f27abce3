"""Probe of dependent gathers on the card (P1).

Replaces the Pallas TPU probe ``experiments/scalar_dma_probe.py`` (``run``,
:85), which asks whether that chip can start per-element DMAs at computed
offsets: the pointer-jump primitive of the CCL kernels. The function is the
same: a copy of an (H, W) int32 plane of flat pixel ids in which N strided
positions are replaced by a two-hop lookup, ``out[r, c] = x[x[r, c] // W,
x[r, c] % W]``. On an NVIDIA GPU any thread can load from a computed address,
so the probe measures what such a lookup costs, in two forms of the CUDA
kernel ``plumekit_torch/csrc/scalar_gather_probe.cu``: all N lookups chained
in one thread (the latency a union-find ``find`` pays per hop pair) and one
thread per lookup (the throughput). Both must equal the plain version.

    python -m plumekit_torch.experiments.scalar_gather_probe [--size 1024]
        [--reps 1024] [--device cuda|cpu]

checks both forms against a numpy loop and prints ns per lookup for each
(on the CPU it checks the plain version only and times nothing).
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

#: launches of the lookup kernel since import, by form
CHAINED_LAUNCHES = 0
PARALLEL_LAUNCHES = 0

_TIMED_REPEATS = 200   # launches per timing, back to back in one call

_ROWS = 32   # the probe's static grid: 32 rows of N / 32 positions


def probe_grid(h: int, w: int, n: int):
    """(positions per row, row stride, column stride) of the probe's static
    grid in an (h, w) plane: 32 rows of N/32 positions, strided to span the
    plane (``experiments/scalar_dma_probe.py:50-51``)."""
    if n < _ROWS or n % _ROWS:
        raise ValueError(f"the probe takes a multiple of {_ROWS} lookups, "
                         f"got {n}")
    per_row = n // _ROWS
    stride_r = max(1, h // _ROWS)
    stride_c = max(1, w // per_row)
    if (_ROWS - 1) * stride_r >= h or (per_row - 1) * stride_c >= w:
        raise ValueError(f"{n} lookups do not fit a {h}x{w} plane")
    return per_row, stride_r, stride_c


def probe_positions(h: int, w: int, n: int):
    """(rows, cols) of the N positions (``scalar_dma_probe.py:59-60``)."""
    per_row, stride_r, stride_c = probe_grid(h, w, n)
    i = np.arange(n)
    return (i // per_row) * stride_r, (i % per_row) * stride_c


def gather_probe_ref(x: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version: tensor indexing."""
    h, w = x.shape
    rows, cols = (torch.from_numpy(a).to(x.device)
                  for a in probe_positions(h, w, n))
    out = x.clone()
    out[rows, cols] = x.reshape(-1)[x[rows, cols].long()]
    return out


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("scalar_gather_probe.cu", "pk_scalar_gather_probe",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])


def gather_probe(x: torch.Tensor, n: int, chained: bool = False,
                 out: torch.Tensor | None = None,
                 repeats: int = 1) -> torch.Tensor:
    """x: (H, W) int32 with values in [0, H·W). Returns the copy of ``x``
    with the N probe positions looked up twice. ``chained`` runs all
    lookups in one thread, each waiting for the one before it. With ``out``
    (a tensor that already holds the copy) only the lookups run, ``repeats``
    launches back to back: what the probe times. A CPU tensor takes the
    plain version."""
    if x.device.type == "cpu":
        return gather_probe_ref(x, n)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous (H, W) int32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    h, w = x.shape
    per_row, stride_r, stride_c = probe_grid(h, w, n)
    copy = out is None
    if copy:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like x")
    lib = _library()
    global CHAINED_LAUNCHES, PARALLEL_LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_scalar_gather_probe(
            x.data_ptr(), out.data_ptr(), h, w, n, per_row, stride_r,
            stride_c, int(chained), int(copy), repeats, stream)
    if err != 0:
        raise RuntimeError("gather probe kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    if chained:
        CHAINED_LAUNCHES += repeats
    else:
        PARALLEL_LAUNCHES += repeats
    return out


def numpy_loop(x: np.ndarray, n: int) -> np.ndarray:
    """The loop of ``experiments/scalar_dma_probe.py:99-106``."""
    h, w = x.shape
    expected = x.copy()
    for r, c in zip(*probe_positions(h, w, n)):
        v = x[r, c]
        expected[r, c] = x[v // w, v % w]
    return expected


def time_lookups(x: torch.Tensor, n: int, chained: bool, reps: int = 5):
    """Median ms per launch of the lookups alone (the plane copy left out),
    over runs of launches made back to back from one call, so that the
    card's time per launch is read and not the caller's time per call."""
    out = gather_probe(x, n, chained)
    gather_probe(x, n, chained, out=out, repeats=_TIMED_REPEATS)   # warm-up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        gather_probe(x, n, chained, out=out, repeats=_TIMED_REPEATS)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / _TIMED_REPEATS)
    return float(np.median(times))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--reps", type=int, default=1024, help="lookup count")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available; pass --device cpu to check the plain "
              "version", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    h = w = args.size
    n = args.reps
    x_np = np.random.default_rng(0).integers(0, h * w, (h, w)).astype(np.int32)
    expected = numpy_loop(x_np, n)
    x = torch.from_numpy(x_np).to(device)
    print(f"device: {device}  size {h}x{w}  lookups {n}")
    forms = [("plain", None)] if device.type == "cpu" else \
        [("chained", True), ("parallel", False)]
    for name, chained in forms:
        got = gather_probe(x, n, bool(chained)).cpu().numpy()
        ok = bool((got == expected).all())
        print(f"{name}: exact: {ok}")
        if not ok:
            print("mismatches:", int((got != expected).sum()))
            return 1
        if device.type == "cuda":
            ms = time_lookups(x, n, chained)
            print(f"{name}: per kernel {ms:.4f} ms  per lookup "
                  f"{ms / n * 1e6:.1f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
