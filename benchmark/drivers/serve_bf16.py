"""The bf16 serving driver: a closed-loop backlog of granules through the
program's multi-granule stream with the SegFormer's bf16 forward, as
``predict_model --batch-granules G`` serves a SegFormer checkpoint, without
the file decode and the ``.npz`` write.

The cell ``segformer-serve-8192`` runs it: SegFormer-B5 at its published
widths (``configs/segformer-b5-c1024.json``) over a backlog cycling a pool
of 8 seeded 8192² granules (the scene of ``serve-int8-8192-g4``), 4 a
group, at the slide geometry it was evaluated with on Cityscapes: 1024²
tiles at stride 768 (overlap 256), 11 × 11 = 121 tiles a granule, 11
forwards of 44 tiles a group, fp32 probabilities read back. Its users are
swath-scale EO backlogs served by a transformer segmenter at its own crop
and stride; nearly every second of the window is the SegFormer forward
(efficient attention, large products, depthwise convs, LayerNorms and the
head's upsampling side by side).

Set-up makes the mix's pool and the configuration's weights from the seed
(``harness/segformer_weights.py``), centres the reference's logits over
four tiles of the pool's first granule by the classifier's bias
(``center_logits``), builds the program's SegFormer and the sliding program
and warms them with whole groups. The window then drains
the endless backlog through ``stream_inference`` exactly as the serving
driver does (``drivers/serve.py``: its backlog, spans, trace record and
end-to-end metrics are imported from there). With tracing on, the
program's recorder (``plumekit_torch.utils.timers``) is on for the window
too, and the record keeps its spans that ended by the window's end and its
counters. After the window, a sample of the granules served in it, drawn
from the seed, is held against the fp32 plain reference (``reference`` in
the configuration file) on the card, a few tiles at a time.

The program's SegFormer modules are imported first, so that a tree without
them fails within seconds."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from plumekit_torch.config.segformer import SegFormerConfig
from plumekit_torch.models.segformer import SegFormer  # noqa: F401

from benchmark.drivers.serve import (END_TO_END, Backlog, Trace,  # noqa: F401
                                     _join_stagers, _trace_record)
from benchmark.harness.cell import Cell, load_module
from benchmark.harness.granules import make_pool
from benchmark.harness.profile import Session, warm_up
from benchmark.harness.segformer_weights import (center_logits, corner_tiles,
                                                  make_weights)


def _build_program(cell: Cell, w, device, trace):
    """The program's bf16 SegFormer, the sliding program of the mix, and
    the variables it reads."""
    from plumekit_torch.config.train import InferConfig
    from plumekit_torch.infer.sliding import make_multi_granule_infer
    from plumekit_torch.models import build_model

    mix = cell.mix
    if mix["forward"] != "bf16":
        raise ValueError(f"the bf16 serving driver serves the bf16 forward, "
                         f"not {mix['forward']!r}")
    model_fields = {k: v for k, v in cell.config["model"].items()
                    if k != "arch"}
    cfg = SegFormerConfig(**cell.config["segformer"], **model_fields)
    if cfg.compute_dtype != "bfloat16":
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: this driver "
                         "serves the bf16 forward")
    with torch.device("meta"):
        model = build_model(cfg)
    model.to_empty(device=device)
    model.load_state_dict(w)
    model.eval()

    def apply_fn(m, tiles):
        return m(tiles)

    if trace is not None:
        apply_fn = trace.wrap_apply(apply_fn)
    icfg = InferConfig(tile_size=mix["tile"], overlap=mix["overlap"],
                       batch_tiles=mix["batch_tiles"],
                       threshold=mix["threshold"])
    infer = make_multi_granule_infer(apply_fn, icfg,
                                     channels=cfg.in_channels)
    if trace is not None:
        infer = trace.wrap_infer(infer)
    return model, infer, cfg.depth


def _stream(backlog, names, infer, variables, depth, device, mix):
    from plumekit_torch.infer.streaming import stream_inference

    return stream_inference(names, infer, variables, depth, device,
                            batch_granules=mix["batch_granules"],
                            predecoded=backlog)


def _program_record(t_end: float) -> dict:
    """The recorder's spans that ended by ``t_end`` (perf_counter
    seconds) and its counters; the recorder is turned off."""
    from plumekit_torch.utils import timers

    got = timers.drain()
    timers.disable()
    end_ns = int(t_end * 1e9)
    return {"spans": [s for s in got["spans"] if s["t1_ns"] <= end_ns],
            "counters": got["counters"]}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a bf16 serving cell; returns the driver's record."""
    from plumekit_torch.utils import timers

    mix = cell.mix
    device = torch.device(device)
    on_card = device.type == "cuda"
    pool = make_pool(mix["granule"], seed, device)
    w = make_weights(cell.config["segformer"], cell.config["model"],
                     cell.config["init"], seed, device)
    ref = load_module(cell.root / cell.config["reference"],
                      "benchmark_reference_segformer")
    center_logits(w, cell.config["segformer"], ref.forward,
                  corner_tiles(pool[0], mix["tile"], device),
                  mix["check_chunk"])
    # tracing reads CUDA events and the device's profile: on the card only
    session = Session(device) if (trace and on_card) else None
    tr = Trace(session, float("inf"), mix["profile_seconds"]) \
        if session is not None else None
    variables, infer, depth = _build_program(cell, w, device, tr)
    g = mix["batch_granules"]
    if trace:
        timers.enable()
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
    timers.drain()                      # the warm-up's spans
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
    record = {"setup_s": setup_s, "seconds": seconds, "window_s": window_s,
              "rate_window_s": t_last - t0
              - (session.overhead_s if session is not None else 0.0),
              "served": served, "pixels": pixels, "latencies": latencies,
              "model": cell.model, "model_fields": cell.config["model"],
              "segformer": cell.config["segformer"], "mix": mix}
    if on_card:
        torch.cuda.synchronize(device)
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace:
        record["program"] = _program_record(t_end)
    if tr is not None:
        record.update(_trace_record(tr, session, t_end))
    del variables, infer, it
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record["checks"] = check(cell, ref, w, pool, sample, device)
    return record


def check(cell: Cell, ref, w, pool, sample, device) -> Dict[str, dict]:
    """The sampled granules' probabilities against the fp32 plain
    reference ``ref``: the widest and the mean gap, each beside its
    limit."""
    mix = cell.mix
    if not sample:
        return {"granules_checked": {"value": 0, "limit": 1, "rule": ">="}}
    worst, total, n = 0.0, 0.0, 0
    for k, probs in sample:
        channels = torch.from_numpy(pool[k % len(pool)]).to(device)
        p_ref = ref.granule_probs(w, cell.config["segformer"], channels,
                                  mix["tile"], mix["overlap"],
                                  chunk=mix["check_chunk"])
        gap = (torch.from_numpy(np.ascontiguousarray(probs)).to(device)
               - p_ref).abs()
        worst = max(worst, float(gap.max()))
        total += float(gap.double().sum())
        n += gap.numel()
    checks = {"granules_checked": {"value": len(sample), "limit": 1,
                                   "rule": ">="}}
    for name in ("max_dp", "mean_dp"):
        value = worst if name == "max_dp" else total / n
        checks[name] = {"value": value, "limit": cell.limits[name],
                        "rule": "<="}
    return checks
