"""How many of a profiler session's kernels come back in its trace, by the
session's distance in time from the process's first session.

Each arm is one process, all arms side by side on the card. An arm opens
``torch.profiler`` sessions (CPU and CUDA activities) at fixed offsets
from its first one (``--at``, seconds); each session launches ``--pairs``
pairs of a one-element add and a spin of about a millisecond
(``torch.cuda._sleep``), so the adds' kernels spread over the session at
known places. Between sessions an arm idles (``idle``) or keeps the card
busy with small kernels (``busy``); the ``eager`` arms set
``TEARDOWN_CUPTI=1`` and ``DISABLE_CUPTI_LAZY_REINIT=1`` in the process
before its first session, which make PyTorch tear CUPTI down after each
session and set it up again at the next; ``warmed`` idles and traces
through the port's :func:`plumekit_torch.utils.timers.profile_trace`,
which opens each session with empty kernels.
The ``eager`` processes do not exit by themselves (on an H100 with torch
2.11): the parent ends every arm at the last offset plus 120 s.

Printed per session: its offset, the adds in its trace of those launched,
and the first and last add that came back. ``python -m
plumekit_torch.experiments.profiler_sessions [--at 0 20 ...] [--pairs N]
[--arms A ...] [--out PATH]`` on a card (exits 1 without one)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ARMS = {
    "idle": {},
    "busy": {},
    "eager_idle": {"TEARDOWN_CUPTI": "1", "DISABLE_CUPTI_LAZY_REINIT": "1"},
    "eager_busy": {"TEARDOWN_CUPTI": "1", "DISABLE_CUPTI_LAZY_REINIT": "1"},
    "warmed": {},
}
SPIN_CYCLES = 1_500_000        # about 0.8 ms at the H100's clocks


def session(torch, pairs: int, log_dir: str, warmed: bool) -> dict:
    """One session of ``pairs`` (add, spin) pairs: which adds came back.
    ``warmed``: through :func:`plumekit_torch.utils.timers.profile_trace`,
    else ``torch.profiler`` as it comes."""
    from plumekit_torch.utils.timers import profile_trace

    t = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    if warmed:
        with profile_trace(log_dir) as trace:
            for _ in range(pairs):
                t.add_(1)
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        path = trace.path
    else:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(pairs):
                t.add_(1)
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    # the pairs' launches: after profile_trace's warm-up, before its
    # witness
    first = len(launches) - 2 * pairs - 1 if warmed else 0
    launches = launches[first:first + 2 * pairs]
    order = {e.get("args", {}).get("correlation"): i
             for i, e in enumerate(launches)}
    # launches alternate add, spin: an add's kernel is an even launch's
    kept = sorted(order[c] // 2 for c in (
        e.get("args", {}).get("correlation") for e in events
        if e.get("cat") == "kernel") if c in order and order[c] % 2 == 0)
    return {"launched": pairs, "launches_seen": len(launches),
            "adds_back": len(kept),
            "first_back": kept[0] if kept else None,
            "last_back": kept[-1] if kept else None}


def busy_until(torch, deadline: float) -> int:
    """Small kernels on the card until ``deadline``; returns how many."""
    x = torch.ones(1024, device="cuda")
    n = 0
    while time.perf_counter() < deadline:
        for _ in range(200):
            x.mul_(1.0)
        n += 200
        torch.cuda.synchronize()
    return n


def run_arm(arm: str, at, pairs: int) -> int:
    import torch

    torch.zeros(1, device="cuda")
    # set as the port would set them: in the process, before its first
    # session
    os.environ.update(ARMS[arm])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as log_dir:
        for k, offset in enumerate(at):
            between = 0
            if "busy" in arm:
                between = busy_until(torch, t0 + offset)
            else:
                time.sleep(max(0.0, t0 + offset - time.perf_counter()))
            row = session(torch, pairs, log_dir, arm == "warmed")
            row.update(arm=arm, session=k, at_s=time.perf_counter() - t0,
                       kernels_between=between)
            print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--at", type=float, nargs="+",
                    default=[0, 10, 30, 60, 120, 180])
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--arms", nargs="+", choices=sorted(ARMS),
                    default=sorted(ARMS))
    ap.add_argument("--arm", choices=sorted(ARMS), default=None,
                    help="run one arm in this process")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device", file=sys.stderr)
        return 1
    if args.arm is not None:
        return run_arm(args.arm, args.at, args.pairs)
    procs = {}
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")}
    for arm in args.arms:
        procs[arm] = subprocess.Popen(
            [sys.executable, "-m", "plumekit_torch.experiments."
             "profiler_sessions", "--arm", arm, "--pairs", str(args.pairs),
             "--at", *map(str, args.at)],
            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    limit = time.perf_counter() + max(args.at) + 120
    results = {}
    for arm, proc in procs.items():
        try:
            out, err = proc.communicate(
                timeout=max(1.0, limit - time.perf_counter()))
            status = f"exit {proc.returncode}"
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            status = "killed at the time limit"
        rows = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
        results[arm] = {"status": status, "sessions": rows,
                        "stderr_tail": err[-600:]}
        cells = "; ".join(
            f"{r['at_s']:.0f} s: {r['adds_back']}/{r['launched']} "
            f"[{r['first_back']}..{r['last_back']}]" for r in rows)
        print(f"{arm} ({status}): {cells}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
