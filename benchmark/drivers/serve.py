"""The serving driver: a closed-loop backlog of granules through the
program's multi-granule stream, as ``predict_model --int8 --batch-granules
G`` serves it, without the file decode and the ``.npz`` write.

Set-up makes the mix's pool of distinct granules and the configuration's
weights from the seed, builds the program's model, calibrates its int8
forward on a 3×3 grid of tiles of the first granule (the command's rule,
``harness.granules.calibration_tiles``),
builds the sliding program and warms it with whole groups. The window then
drains an endless backlog that cycles the pool: the backlog is handed to
``stream_inference`` as ``predecoded`` granules, so its decode pool, the
stager's pinned uploads on the side stream, the forwards, the stitching and
the readback all run in the window. A granule's latency runs from the
stream's pull of it off the backlog to the yield of its probabilities.

With tracing on, the driver also wraps the sliding program and its forward
(CUDA events, host spans) and profiles a few seconds of whole groups.

After the window, a sample of the granules served in it, drawn from the
seed, is held against the plain reference (``reference`` in the
configuration file), which rebuilds the int8 model from the same weights
and calibration granule."""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.cell import Cell, load_module
from benchmark.harness.granules import calibration_tiles, make_pool
from benchmark.harness.profile import Session, top, warm_up
from benchmark.harness.weights import make_weights


class Backlog:
    """The ``predecoded`` map of an endless backlog: granule ``g<k>`` is
    pool item ``k mod P``, handed out as ``(name, channels, (H, W))``; the
    pull time of each name is kept."""

    def __init__(self, pool: List[np.ndarray], start: int = 0):
        self.pool = pool
        self.start = start
        self.pulled: Dict[str, float] = {}

    def names(self, count=None):
        k = self.start
        while count is None or k < self.start + count:
            name = f"g{k}"
            self.pulled[name] = time.perf_counter()
            yield name
            k += 1

    def __bool__(self):
        return True

    def __contains__(self, name):
        return True

    def pop(self, name):
        item = self.pool[int(name[1:]) % len(self.pool)]
        return name, item, item.shape[:2]


def _join_stagers(timeout: float = 60.0) -> None:
    from plumekit_torch.io.prefetch import STAGER_NAME

    for t in threading.enumerate():
        if t.name == STAGER_NAME:
            t.join(timeout)


class Trace:
    """Spans and events of a traced window, recorded by the wrappers the
    driver hands to the program."""

    def __init__(self, session: Session, profile_at: float,
                 profile_seconds: float):
        self.session = session
        self.profile_at = profile_at
        self.profile_until = None
        self.profile_seconds = profile_seconds
        self.groups: List[dict] = []      # per infer_fn call
        self.last_yield = None

    def wrap_apply(self, apply_fn):
        def apply(variables, tiles):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = apply_fn(variables, tiles)
            b.record()
            self.groups[-1]["forwards"].append((a, b, int(tiles.shape[0])))
            return out
        return apply

    def wrap_infer(self, infer_fn):
        def infer(variables, images):
            now = time.perf_counter()
            s = self.session
            opened = s is not None and not s.stopped and not s.active \
                and now >= self.profile_at
            if opened:      # its synchronise is no wait for the stager
                s.start()
                self.profile_until = time.perf_counter() \
                    + self.profile_seconds
                now = time.perf_counter()
            elif self.last_yield is not None:
                self.session_span("stager_wait", self.last_yield, now)
            group = {"called": now, "forwards": [], "opened": opened,
                     "profiled": s is not None and s.active}
            self.groups.append(group)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            probs, masks = infer_fn(variables, images)
            e1.record()
            t_ret = time.perf_counter()
            self.session_span("infer_fn", now, t_ret)
            e1.synchronize()
            group["done"] = time.perf_counter()
            self.session_span("device_wait", t_ret, group["done"])
            group["events"] = (e0, e1)
            return probs, masks
        return infer

    def session_span(self, name, t0, t1):
        if self.session is not None:
            self.session.host_span(name, t0, t1)

    def on_yield(self, t: float, first: bool) -> None:
        g = self.groups[-1]
        if first:
            g["first_yield"] = t
            self.session_span("readback", g["done"], t)
        elif self.last_yield is not None:
            self.session_span("consumer", self.last_yield, t)
        self.last_yield = t
        g["last_yield"] = t

    def after_group(self) -> None:
        """Close the profiled part once it has run its seconds, at the end
        of a group."""
        s = self.session
        if s is not None and s.active and self.profile_until is not None \
                and time.perf_counter() >= self.profile_until:
            s.stop()


def _build_program(cell: Cell, w, pool, device, trace):
    """The program's serving path of the mix: model, int8 calibration,
    sliding program, and the variables it reads."""
    from plumekit_torch.config.train import InferConfig, UNetConfig
    from plumekit_torch.infer.sliding import make_multi_granule_infer
    from plumekit_torch.models import build_model
    from plumekit_torch.models.quantized_forward import (make_quantized_apply,
                                                         quantize_unet)

    mix = cell.mix
    if mix["forward"] != "int8":
        raise ValueError(f"the serving driver serves the int8 forward, not "
                         f"{mix['forward']!r}")
    ucfg = UNetConfig(**vars(cell.model))
    with torch.device("meta"):
        model = build_model(ucfg)
    model.to_empty(device=device)
    model.load_state_dict(w)
    model.eval()
    qvars = quantize_unet(model, ucfg, calibration_tiles(
        pool[0], mix["tile"], ucfg.depth))
    del model
    apply_fn = make_quantized_apply(ucfg)
    if trace is not None:
        apply_fn = trace.wrap_apply(apply_fn)
    icfg = InferConfig(tile_size=mix["tile"], overlap=mix["overlap"],
                       batch_tiles=mix["batch_tiles"],
                       threshold=mix["threshold"])
    infer = make_multi_granule_infer(apply_fn, icfg,
                                     channels=ucfg.in_channels)
    if trace is not None:
        infer = trace.wrap_infer(infer)
    return qvars, infer, ucfg.depth


def _stream(backlog, names, infer, variables, depth, device, mix):
    from plumekit_torch.infer.streaming import stream_inference

    return stream_inference(names, infer, variables, depth, device,
                            batch_granules=mix["batch_granules"],
                            predecoded=backlog)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a serving cell; returns the driver's record."""
    mix = cell.mix
    device = torch.device(device)
    on_card = device.type == "cuda"
    pool = make_pool(mix["granule"], seed, device)
    w = make_weights(cell.model, cell.config["init"], seed, device)
    # tracing reads CUDA events and the device's profile: on the card only
    session = Session(device) if (trace and on_card) else None
    tr = Trace(session, float("inf"), mix["profile_seconds"]) \
        if session is not None else None
    variables, infer, depth = _build_program(cell, w, pool, device, tr)
    g = mix["batch_granules"]
    with torch.inference_mode():
        warm = Backlog(pool, start=10**9)
        for _ in _stream(warm, warm.names(g * mix["warmup_groups"]), infer,
                         variables, depth, device, mix):
            pass
    _join_stagers()
    if session is not None:
        warm_up(device)
    if tr is not None:
        tr.groups.clear()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    backlog = Backlog(pool)
    rng = np.random.default_rng([int(seed), 0xC4EC])
    sample: List[tuple] = []
    latencies: List[float] = []
    pixels = 0
    served = 0
    t0 = time.perf_counter()
    t_last = t0
    t_end = t0 + seconds
    if tr is not None:
        tr.profile_at = t0 + mix["profile_start"] * seconds
    with torch.inference_mode():
        it = _stream(backlog, backlog.names(), infer, variables, depth,
                     device, mix)
        in_group = 0
        for name, probs in it:
            t = time.perf_counter()
            if t > t_end:
                break
            if tr is not None:
                tr.on_yield(t, first=in_group == 0)
            in_group = (in_group + 1) % g
            latencies.append(t - backlog.pulled[name])
            pixels += probs.size
            t_last = t
            k = int(name[1:])
            if len(sample) < mix["check_sample"]:
                sample.append((k, probs))
            else:
                j = int(rng.integers(0, served + 1))
                if j < len(sample):
                    sample[j] = (k, probs)
            served += 1
            if tr is not None and in_group == 0:
                tr.after_group()
        window_s = time.perf_counter() - t0
        it.close()
    _join_stagers()
    if session is not None and session.active:
        session.stop()
    # the rate's time runs to the last completion in the window: work
    # completes a group at a time, and a window cut mid-group would count
    # the group's time without its pixels
    record = {"setup_s": setup_s, "seconds": seconds, "window_s": window_s,
              "rate_window_s": t_last - t0
              - (session.overhead_s if session is not None else 0.0),
              "served": served, "pixels": pixels, "latencies": latencies,
              "model": cell.model, "mix": mix}
    if on_card:
        torch.cuda.synchronize(device)
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if tr is not None:
        record.update(_trace_record(tr, session, t_end))
    del variables, infer, it
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record["checks"] = check(cell, seed, w, pool, sample, device)
    return record


def _trace_record(tr: Trace, session, t_end: float) -> dict:
    """Per-group times of the groups that finished in the window, and the
    profiler's reading."""
    groups = [gr for gr in tr.groups
              if "events" in gr and gr.get("last_yield", t_end + 1) <= t_end]
    prev_yield = None
    stager, readback, stitch, forwards = [], [], [], []
    profiled_tiles = []
    for gr in groups:
        e0, e1 = gr["events"]
        infer_ms = e0.elapsed_time(e1)
        fw = [a.elapsed_time(b) for a, b, _ in gr["forwards"]]
        forwards += fw
        stitch.append(infer_ms - sum(fw))
        readback.append((gr["first_yield"] - gr["done"]) * 1e3)
        if prev_yield is not None and not gr["opened"]:
            stager.append((gr["called"] - prev_yield) * 1e3)
        prev_yield = gr["last_yield"]
        if gr["profiled"]:
            profiled_tiles += [n for _, _, n in gr["forwards"]]
    out = {"groups": len(groups), "stager_wait_ms": stager,
           "readback_ms": readback, "stitch_ms": stitch,
           "forward_ms": forwards}
    if session is not None and session.stopped:
        reading = session.reading()
        reading["forward_tiles"] = profiled_tiles
        out["profile"] = reading
        out["breakdown"] = {"device_ops": top(reading["kernels"]),
                            "idle_gaps": top(reading["idle"])}
    return out


def check(cell: Cell, seed: int, w, pool, sample, device) -> Dict[str, dict]:
    """The sampled granules' probabilities against the plain reference:
    the widest and the mean gap, each beside its limit."""
    ref = load_module(cell.root / cell.config["reference"],
                      "benchmark_reference")
    mix = cell.mix
    checks = {}
    if not sample:
        return {"granules_checked": {"value": 0, "limit": 1, "rule": ">="}}
    model = ref.build(w, cell.model, pool[0], mix["tile"], 127, device)
    worst, total, n = 0.0, 0.0, 0
    for k, probs in sample:
        channels = torch.from_numpy(pool[k % len(pool)]).to(device)
        p_ref = ref.granule_probs(model, cell.model, channels, mix["tile"],
                                  mix["overlap"])
        gap = (torch.from_numpy(np.ascontiguousarray(probs)).to(device)
               - p_ref).abs()
        worst = max(worst, float(gap.max()))
        total += float(gap.double().sum())
        n += gap.numel()
    checks["granules_checked"] = {"value": len(sample), "limit": 1,
                                  "rule": ">="}
    for name in ("max_dp", "mean_dp"):
        value = worst if name == "max_dp" else total / n
        checks[name] = {"value": value, "limit": cell.limits[name],
                        "rule": "<="}
    return checks


def _p95_ms(rec):
    return float(np.percentile(rec["latencies"], 95)) * 1e3 \
        if rec["latencies"] else None


#: the end-to-end metrics this driver measures, from its record
END_TO_END = {
    "serve_mpix_s": lambda rec: rec["pixels"] / 1e6 / rec["rate_window_s"],
    "granule_p95_ms": _p95_ms,
}
