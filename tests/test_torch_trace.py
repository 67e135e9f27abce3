"""The port's span-and-counter recorder (``plumekit_torch/utils/timers``):
off by default and then free of records, spans nested per thread and
counters summed across threads, the spans of the granule stream, the
sliding program and the train step where the work happens (no span open
across a ``yield``), outputs bit for bit the same with the recorder on,
``StageTimes`` recording through it, and the benchmark's placement of
program spans on the profiler's timeline and of device idle time under
them (``benchmark/harness/spans.py``)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.harness.profile import Session
from benchmark.harness.spans import (anchor, attribute_idle, innermost,
                                     to_profiler_us)
from plumekit_torch.config import InferConfig, TrainConfig, UNetConfig
from plumekit_torch.infer.sliding import make_multi_granule_infer
from plumekit_torch.infer.streaming import stream_inference
from plumekit_torch.io.prefetch import STAGER_NAME, device_prefetch
from plumekit_torch.models import UNet
from plumekit_torch.models.fused_forward import make_fused_apply
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step, step_generator
from plumekit_torch.utils import StageTimes, timers

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
ICFG = dict(tile_size=32, overlap=8, batch_tiles=4)
CPU = torch.device("cpu")
GRANULES = 5
G = 2


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    timers.disable()
    timers.drain()
    yield
    timers.disable()
    timers.drain()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _granules():
    rng = np.random.default_rng(7)
    return {f"g{i}": (f"g{i}", rng.random((64, 64, 2)).astype(np.float32),
                      (64, 64)) for i in range(GRANULES)}


def _served(on: bool, pause_s: float = 0.0):
    """One stream of the tiny granules; returns [(name, probs, the yield's
    perf_counter_ns)] and what the recorder drained."""
    torch.manual_seed(0)
    model = UNet(UNetConfig(**KW)).eval()
    infer = make_multi_granule_infer(make_fused_apply(UNetConfig(**KW)),
                                     InferConfig(**ICFG))
    pre = _granules()
    if on:
        timers.enable()
    out = []
    for name, probs in stream_inference(list(pre), infer, model, 2, CPU,
                                        batch_granules=G, decode_workers=1,
                                        predecoded=pre):
        out.append((name, probs, time.perf_counter_ns()))
        time.sleep(pause_s)
    timers.disable()
    return out, timers.drain()


@pytest.fixture(scope="module")
def served():
    off, nothing = _served(False)
    on, drained = _served(True, pause_s=0.005)
    return off, nothing, on, drained


def _named(drained, name):
    return [s for s in drained["spans"] if s["name"] == name]


def test_off_records_nothing_and_span_is_the_shared_no_op():
    assert not timers.enabled()
    a, b = timers.span("x"), timers.span("y", device=CPU, group=3)
    assert a is b
    with a:
        timers.count("c", 5)
    st = StageTimes()
    with st.stage("s"):
        pass
    assert st.counts["s"] == 1
    assert timers.drain() == {"spans": [], "counters": {}}


def test_an_off_stream_records_nothing(served):
    _, nothing, _, _ = served
    assert nothing == {"spans": [], "counters": {}}


def test_spans_nest_per_thread_and_counters_add_up_across_threads():
    timers.enable()
    ready = threading.Barrier(2)

    def work():
        with timers.span("w.outer", k=1):
            ready.wait(5)
            with timers.span("w.inner"):
                timers.count("n", 2)

    t = threading.Thread(target=work, name="worker")
    with timers.span("m.outer"):
        t.start()
        ready.wait(5)
        with timers.span("m.inner"):
            timers.count("n")
    t.join(5)
    assert not t.is_alive()
    got = timers.drain()
    by = {s["name"]: s for s in got["spans"]}
    assert by["m.inner"]["parent"] == by["m.outer"]["id"]
    assert by["w.inner"]["parent"] == by["w.outer"]["id"]
    assert by["m.outer"]["parent"] is None is by["w.outer"]["parent"]
    assert by["w.outer"]["thread"] == by["w.inner"]["thread"] == "worker"
    assert by["m.outer"]["thread"] == threading.current_thread().name
    assert by["w.outer"]["attrs"] == {"k": 1}
    assert all(s["t0_ns"] <= s["t1_ns"] for s in got["spans"])
    assert "device_ms" not in by["m.outer"]
    assert got["counters"] == {"n": 3}
    assert timers.drain() == {"spans": [], "counters": {}}


def test_counters_lose_no_update_under_many_threads():
    timers.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            timers.count("hits") for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert timers.drain()["counters"] == {"hits": 16 * 2000}


def test_the_stagers_spans_carry_its_thread_name():
    timers.enable()
    items = list(device_prefetch(range(4), device_put=lambda x: x * 2))
    assert items == [0, 2, 4, 6]
    got = timers.drain()
    stage = _named(got, "stream.stage")
    assert len(stage) == 4
    assert {s["thread"] for s in stage} == {STAGER_NAME}
    assert {s["thread"] for s in _named(got, "stream.queue_wait")} == {
        threading.current_thread().name}
    # four items and the stream's end
    assert got["counters"]["stream.queue.gets"] == 5


def test_stream_spans_per_group_granule_pull_and_tile_batch(served):
    _, _, on, got = served
    groups = -(-GRANULES // G)
    readback = _named(got, "stream.readback")
    assert sorted(s["attrs"]["group"] for s in readback) == \
        list(range(groups))
    for name in ("stream.images", "stream.infer", "stream.readback.copy"):
        assert len(_named(got, name)) == groups
    # no CUDA event to wait on from the CPU
    assert _named(got, "stream.readback.device_wait") == []
    assert len(_named(got, "stream.stage")) == GRANULES
    c = got["counters"]
    assert len(_named(got, "stream.queue_wait")) == c["stream.queue.gets"] \
        == GRANULES + 1
    assert c["stream.groups"] == groups and c["stream.granules"] == GRANULES
    assert c["stream.readback.bytes"] == GRANULES * 64 * 64 * 4
    forward = _named(got, "sliding.forward")
    assert len(forward) == c["sliding.forwards"] > groups
    assert sum(s["attrs"]["tiles"] for s in forward) == c["sliding.tiles"]
    assert len(_named(got, "sliding.infer")) == groups
    assert len(_named(got, "sliding.stitch")) == groups


def test_each_groups_spans_carry_its_index(served):
    _, _, on, got = served
    ids = {s["id"]: s for s in got["spans"]}
    for s in got["spans"]:
        if s["name"].startswith("stream.readback."):
            assert s["attrs"]["group"] == ids[s["parent"]]["attrs"]["group"]
        if s["name"] == "sliding.infer":
            parent = ids[s["parent"]]
            assert parent["name"] == "stream.infer"
    # the granules of group k are yielded after its readback and before
    # group k + 1 is stacked
    done = {s["attrs"]["group"]: s["t1_ns"]
            for s in _named(got, "stream.readback")}
    start = {s["attrs"]["group"]: s["t0_ns"]
             for s in _named(got, "stream.images")}
    for i, (name, _, t) in enumerate(on):
        assert name == f"g{i}"
        k = i // G
        assert done[k] <= t
        assert k + 1 not in start or t < start[k + 1]


def test_no_span_is_open_across_a_yield(served):
    _, _, on, got = served
    me = threading.current_thread().name
    mine = [s for s in got["spans"] if s["thread"] == me]
    assert mine
    for _, _, t in on:
        assert not [s["name"] for s in mine if s["t0_ns"] < t < s["t1_ns"]]
    # hence no span of one group holds a span of the next
    for a in mine:
        for b in mine:
            ga, gb = a["attrs"].get("group"), b["attrs"].get("group")
            if ga is not None and gb is not None and ga != gb:
                assert not (a["t0_ns"] <= b["t0_ns"] and b["t1_ns"]
                            <= a["t1_ns"])


def test_the_stream_is_bit_for_bit_the_same_with_the_recorder_on(served):
    off, _, on, _ = served
    assert [n for n, _, _ in off] == [n for n, _, _ in on]
    for (_, p, _), (_, q, _) in zip(off, on):
        assert p.dtype == q.dtype and np.array_equal(p, q)


def test_a_train_step_records_its_four_children_in_order():
    ucfg = UNetConfig(**KW)
    tcfg = TrainConfig(batch_size=2, tile_size=32, warmup_steps=1,
                       total_steps=4)
    state = create_state(ucfg, tcfg, CPU)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(2, 32, 32, 2)).astype(np.float32))
    ys = torch.from_numpy((rng.random((2, 32, 32, 1)) < 0.3)
                          .astype(np.float32))
    step = make_train_step(augment=True)
    timers.enable()
    step(state, xs, ys, step_generator(0, 0, CPU))
    got = timers.drain()
    (top,) = _named(got, "train.step")
    children = sorted((s for s in got["spans"] if s["parent"] == top["id"]),
                      key=lambda s: s["t0_ns"])
    assert [s["name"] for s in children] == [
        "train.augment", "train.forward", "train.backward",
        "train.optimizer"]
    for a, b in zip(children, children[1:]):
        assert a["t1_ns"] <= b["t0_ns"]
    assert top["t0_ns"] <= children[0]["t0_ns"]
    assert children[-1]["t1_ns"] <= top["t1_ns"]
    assert got["counters"] == {"train.steps": 1}


def test_stage_times_record_through_span():
    st = StageTimes()
    timers.enable()
    with st.stage("decode"):
        time.sleep(0.002)
    (s,) = timers.drain()["spans"]
    assert s["name"] == "decode"
    assert st.totals["decode"] == pytest.approx(
        (s["t1_ns"] - s["t0_ns"]) * 1e-9)
    assert st.totals["decode"] >= 0.002


def test_to_profiler_us_maps_a_synthetic_anchor_exactly():
    at = (5_000_000, 1000.0, "synthetic")
    assert to_profiler_us(5_000_000, at) == 1000.0
    assert to_profiler_us(5_250_000, at) == 1250.0
    assert to_profiler_us(4_999_000, at) == 999.0


def test_idle_goes_to_the_innermost_span_and_the_rest_is_untraced():
    spans = [("a", 0.0, 100.0), ("b", 10.0, 40.0), ("c", 20.0, 30.0),
             ("d", 60.0, 70.0), ("e", 150.0, 160.0)]
    assert innermost(spans) == [
        (0.0, 10.0, "a"), (10.0, 20.0, "b"), (20.0, 30.0, "c"),
        (30.0, 40.0, "b"), (40.0, 60.0, "a"), (60.0, 70.0, "d"),
        (70.0, 100.0, "a"), (150.0, 160.0, "e")]
    got = attribute_idle([(5.0, 25.0), (65.0, 120.0)], spans)
    us = {k: round(v * 1e6, 6) for k, v in got.items()}
    assert us == {"a": 35.0, "b": 10.0, "c": 5.0, "d": 5.0, "e": 0.0,
                  "untraced": 20.0}


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs CUDA")
def test_program_spans_land_on_the_profilers_clock():
    """Program spans and ``record_function`` ranges opened back to back,
    each pair nested both ways: one offset of the mapping fits every pair,
    and it lies within 50 us of zero."""
    session = Session(torch.device("cuda"))
    session.start()
    timers.enable()
    for _ in range(50):
        with torch.profiler.record_function("clock.outer"):
            with timers.span("clock.inner"):
                time.sleep(1e-4)
        with timers.span("clock.outer"):
            with torch.profiler.record_function("clock.inner"):
                time.sleep(1e-4)
    session.stop()
    spans = timers.drain()["spans"]
    at = anchor(session)
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {n: sorted((e.time_range.start, e.time_range.end)
                        for e in session.events
                        if e.name == n and e.device_type != cuda)
              for n in ("clock.outer", "clock.inner")}
    mapped = {n: [(to_profiler_us(s["t0_ns"], at),
                   to_profiler_us(s["t1_ns"], at))
                  for s in spans if s["name"] == n]
              for n in ("clock.outer", "clock.inner")}
    assert [len(v) for v in ranges.values()] == [50, 50]
    # e, the mapped time less the true one: a span inside a range opens
    # after it and closes before it, a range inside a span likewise
    lo, hi = [], []
    for (r0, r1), (s0, s1) in zip(ranges["clock.outer"],
                                  mapped["clock.inner"]):
        hi.append(s0 - r0)
        lo.append(s1 - r1)
    for (r0, r1), (s0, s1) in zip(ranges["clock.inner"],
                                  mapped["clock.outer"]):
        lo.append(s0 - r0)
        hi.append(s1 - r1)
    print(f"anchor {at[2]}: offset within [{max(lo):.2f}, {min(hi):.2f}] us")
    assert max(lo) <= min(hi)
    assert -50.0 <= max(lo) and min(hi) <= 50.0
