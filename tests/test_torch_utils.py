"""``plumekit_torch/utils`` against ``plumekit/utils``: the package split
(every old import still works), ``Timer`` and ``StageTimes`` with the JAX
package's semantics, ``profile_trace`` writing a Chrome trace on the CPU,
and ``checked``, the NaN guard, which raises naming the op, a
``plumekit::`` custom op included."""

import json
import logging
import time

import numpy as np
import pytest
import torch

from plumekit.utils.timers import StageTimes as JaxStageTimes
from plumekit.utils.timers import Timer as JaxTimer
from plumekit_torch.utils import (MetricsWriter, StageTimes, Timer, checked,
                                  get_logger, profile_trace)
from plumekit_torch.utils import timers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_split_package_keeps_every_name():
    from plumekit.utils import logging as jax_logging
    from plumekit_torch.utils import logging as port_logging
    from plumekit_torch.utils.metrics import MetricsWriter as writer

    assert port_logging.get_logger is get_logger and writer is MetricsWriter
    assert isinstance(get_logger("plumekit_torch.test"), logging.Logger)
    assert port_logging._FMT == jax_logging._FMT


def test_stage_times_and_timer_behave_as_the_jax_package():
    """The same blocks through both packages: the same stage names and
    counts, totals at least the time slept, host values waited on as
    no-ops, and the handle's value passed through."""
    runs = {}
    for name, st_cls, timer_cls in (("jax", JaxStageTimes, JaxTimer),
                                    ("port", StageTimes, Timer)):
        st = st_cls()
        for i in range(3):
            with st.stage("decode", sync={"a": np.ones(2), "b": [1, (2,)]}):
                time.sleep(0.002)
            with st.stage("forward") as h:
                out = h.sync(np.full(3, i))
            assert out.tolist() == [i] * 3
        with timer_cls() as t:
            time.sleep(0.003)
        runs[name] = (dict(st.counts), sorted(st.summary()), t.elapsed)
        assert st.totals["decode"] >= 0.006 and t.elapsed >= 0.003
    assert runs["jax"][:2] == runs["port"][:2] == (
        {"decode": 3, "forward": 3}, ["decode", "forward"])


def test_stage_time_counts_a_block_that_raises():
    st = StageTimes()
    with pytest.raises(ValueError):
        with st.stage("bad"):
            raise ValueError("boom")
    assert st.counts["bad"] == 1 and st.totals["bad"] >= 0


def test_sync_waits_once_per_cuda_device(monkeypatch):
    """Nested tuples, lists and dicts are walked; only CUDA tensors make
    the clock wait, each device once. (No card here: the walk is held on
    tensors that report a CUDA device.)"""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", int(self.flatten()[0]))

    a, b = (torch.tensor([k]).as_subclass(OnCard) for k in (0, 1))
    x = {"p": (a, [b, a]), "q": np.zeros(2), "r": torch.zeros(1)}
    assert timers._sync(x) is x
    assert sorted(str(d) for d in seen) == ["cuda:0", "cuda:1"]
    seen.clear()
    timers._sync([torch.ones(2), 3.0, "host"])
    assert seen == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert trace.path is not None and trace.path.startswith(
        str(tmp_path / "trace"))
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_trace_warns_when_the_card_brings_back_nothing(
        tmp_path, caplog):
    """On the CPU alone the card is not traced and nothing is logged; the
    card's check on a session without any event of the card (what a
    session that lost the card's activity brings back) logs a WARNING
    naming the file and leaves ``card_events`` at 0."""
    with caplog.at_level(logging.WARNING, logger="plumekit_torch"):
        with profile_trace(str(tmp_path / "trace")) as trace:
            torch.ones(8, 8) @ torch.ones(8, 8)
        assert trace.card_events is None and not caplog.records
        timers._check_card(trace)
    assert trace.card_events == 0
    (record,) = caplog.records
    assert record.levelno == logging.WARNING
    assert "no event of the card" in record.getMessage()
    assert trace.path in record.getMessage()


def test_profile_trace_warm_up_grows_with_the_process_age(monkeypatch):
    """The empty kernels that open a session tracing the card: the minimum
    at import, then ``WARMUP_PER_S`` more for every second."""
    now = time.perf_counter()
    monkeypatch.setattr(timers, "_IMPORTED", now)
    assert timers._warmup_kernels() == timers.WARMUP_MIN
    monkeypatch.setattr(timers, "_IMPORTED", now - 1000.0)
    assert timers._warmup_kernels() == int(
        timers.WARMUP_MIN + 1000.0 * timers.WARMUP_PER_S)


def test_profiler_sessions_experiment_needs_a_card():
    from plumekit_torch.experiments import profiler_sessions

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiler_sessions.main(["--pairs", "1"]) == 1


def test_checked_passes_a_clean_function_and_raises_on_nan():
    def fn(x, *, k=2.0):
        return torch.log(x) * k

    guarded = checked(fn)
    x = torch.tensor([1.0, 2.0, 4.0])
    torch.testing.assert_close(guarded(x, k=3.0), fn(x, k=3.0), rtol=0,
                               atol=0)
    assert guarded.__name__ == "fn"
    with pytest.raises(FloatingPointError, match="aten.log"):
        guarded(torch.tensor([1.0, -1.0]))
    # integer outputs and infinities are no NaN
    assert checked(lambda t: (t // 2, t.float() / 0))(
        torch.tensor([3]))[0].item() == 1


def test_checked_sees_the_plumekit_custom_ops():
    """K6's op (``plumekit::fused_double_conv3x3``, its plain version on
    the CPU) with a NaN pixel: the first op that produces a NaN is the
    custom op itself, named in the error."""
    from plumekit_torch.models.kernels.fused_conv import \
        fused_double_conv3x3_op

    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 8, 8, 4), generator=g)
    w1 = torch.randn((3, 3, 4, 8), generator=g)
    w2 = torch.randn((3, 3, 8, 8), generator=g)
    ones, zeros = torch.ones(8), torch.zeros(8)
    args = (w1, ones, zeros, w2, ones, zeros, 8, 8)
    guarded = checked(fused_double_conv3x3_op)
    torch.testing.assert_close(guarded(x, *args),
                               fused_double_conv3x3_op(x, *args))
    x[1, 3, 3, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="plumekit.fused_double_conv3x3"):
        guarded(x, *args)
