"""The training driver: the program's train step fed by its host iterator,
as ``train_model`` runs it without checkpoints or evaluations.

Set-up makes the mix's granules with their plume masks and the
configuration's weights from the seed, builds the program's train state
(model, AdamW, warmup schedule) with those weights, the step of
``train/step.make_multi_train_step`` and the feed of
``train/loop.host_chunks``, and drives that state through its first
``checked_steps`` steps with the window's own call and feed. The loss of
each, the first gradient (AdamW's first moment after one step over 1 − β1)
and each leaf's change after the last are kept for the check. The window
then runs the same state and feed for its seconds; its rate counts every
step it ran, up to the synchronise that closes it.

After the window the plain reference (``reference_train`` in the
configuration file) follows the same checked steps from the same weights
on batches it draws itself, and the readings are compared."""

from __future__ import annotations

import gc
import itertools
import statistics
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness.cell import Cell, load_module
from benchmark.harness.granules import make_pool
from benchmark.harness.profile import Session, top, warm_up
from benchmark.harness.weights import make_weights

BETA1 = 0.9


def _program(cell: Cell, w, samples, seed: int, device):
    from plumekit_torch.config.train import TrainConfig, UNetConfig
    from plumekit_torch.train.data import GranuleSample
    from plumekit_torch.train.loop import host_chunks
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_multi_train_step

    mix = cell.mix
    ucfg = UNetConfig(**vars(cell.model))
    tcfg = TrainConfig(batch_size=mix["batch_size"], tile_size=mix["tile"],
                       learning_rate=mix["learning_rate"],
                       weight_decay=mix["weight_decay"],
                       warmup_steps=mix["warmup_steps"],
                       total_steps=mix["total_steps"],
                       dice_weight=mix["dice_weight"], augment=mix["augment"],
                       seed=seed)
    state = create_state(ucfg, tcfg, device)
    state.model.load_state_dict(w)
    step = make_multi_train_step(tcfg.dice_weight, tcfg.augment,
                                 tcfg.label_smooth, seed=seed)
    feed = host_chunks([GranuleSample(channels=c, mask=m) for c, m in samples],
                       tcfg.tile_size, tcfg.batch_size,
                       np.random.default_rng((seed, 0)), device,
                       itertools.repeat(1))
    return state, step, feed


def _leaves(state) -> Dict[str, torch.nn.Parameter]:
    return dict(state.model.named_parameters())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a training cell; returns the driver's record."""
    mix = cell.mix
    device = torch.device(device)
    on_card = device.type == "cuda"
    samples = make_pool(mix["granule"], seed, device, masks=True)
    w = make_weights(cell.model, cell.config["init"], seed, device)
    state, step_fn, feed = _program(cell, w, samples, seed, device)
    leaves = _leaves(state)
    losses, grads = [], None
    done = 0
    for s in range(mix["checked_steps"]):
        state, metrics = step_fn(state, next(feed), range(done, done + 1))
        done += 1
        losses.append(float(metrics["loss"]))
        if s == 0:
            grads = {k: state.optimizer.state[p]["exp_avg"].detach()
                     .clone() / (1.0 - BETA1) for k, p in leaves.items()}
    change = {k: (p.detach() - w[k].float()) for k, p in leaves.items()}
    if on_card:
        torch.cuda.synchronize(device)
    session = Session(device) if (trace and on_card) else None
    if session is not None:
        warm_up(device)
    setup_s = time.perf_counter() - t_start

    px = mix["batch_size"] * mix["tile"] ** 2
    waits, events = [], []
    profiled = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    profile_at = t0 + mix["profile_start"] * seconds
    profile_until = None
    steps = 0
    while time.perf_counter() < t_end:
        if session is not None:
            now = time.perf_counter()
            if not session.active and not session.stopped \
                    and now >= profile_at:
                session.start()
                profile_until = time.perf_counter() + mix["profile_seconds"]
            elif session.active and now >= profile_until:
                session.stop()
        a = time.perf_counter()
        chunk = next(feed)
        b = time.perf_counter()
        if session is not None:
            session.host_span("data_wait", a, b)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        state, metrics = step_fn(state, chunk, range(done, done + 1))
        if session is not None:
            e1.record()
            events.append((e0, e1))
            session.host_span("step_call", b, time.perf_counter())
            profiled += int(session.active)
        waits.append(b - a)
        done += 1
        steps += 1
    if on_card:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if session is not None and session.active:
        session.stop()
    feed.close()
    record = {"setup_s": setup_s, "seconds": window_s, "window_s": window_s,
              "rate_window_s": window_s
              - (session.overhead_s if session is not None else 0.0),
              "served": steps, "steps": steps, "pixels": steps * px,
              "model": cell.model, "mix": mix}
    if on_card:
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if session is not None:
        record["step_ms"] = [a.elapsed_time(b) for a, b in events]
        record["data_wait_ms"] = [x * 1e3 for x in waits]
        if session.stopped:
            reading = session.reading()
            reading["steps"] = profiled
            record["profile"] = reading
            record["breakdown"] = {"device_ops": top(reading["kernels"]),
                                   "idle_gaps": top(reading["idle"])}
    del state, step_fn, feed, leaves, metrics
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    record["checks"] = check(cell, seed, w, samples, losses, grads, change,
                             device)
    return record


def _norm(t) -> float:
    return float(t.double().norm())


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep=None) -> float:
    """The worst leaf's gap of norms, ``|‖prog‖ − ‖ref‖|``, over the larger
    of the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    norms = {k: _norm(ref[k]) for k in names}
    median = statistics.median(norms.values())
    return max(abs(_norm(prog[k]) - norms[k]) / max(norms[k], median, 1e-30)
               for k in names)


def readings(cell: Cell, prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training cell compares: the worst step's relative
    loss gap, the first gradient's worst leaf and the change's worst leaf
    (leaves whose reference gradient is under a thousandth of the median
    leaf's left out: they move by round-off alone under AdamW)."""
    g_norms = {k: _norm(v) for k, v in ref["grad"].items()}
    median = statistics.median(g_norms.values())
    moving = {k for k, v in g_norms.items() if v >= 1e-3 * median}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
    }


def check(cell: Cell, seed: int, w, samples, losses, grads, change,
          device) -> Dict[str, dict]:
    ref_mod = load_module(cell.root / cell.config["reference_train"],
                          "benchmark_reference_train")
    ref = ref_mod.follow(w, cell.model, cell.mix, samples, seed,
                         cell.mix["checked_steps"], device)
    got = readings(cell, {"loss": losses, "grad": grads, "change": change},
                   ref)
    return {name: {"value": value, "limit": cell.limits[name], "rule": "<="}
            for name, value in got.items()}


#: the end-to-end metrics this driver measures, from its record
END_TO_END = {
    "train_mpix_s": lambda rec: rec["pixels"] / 1e6 / rec["window_s"],
}
