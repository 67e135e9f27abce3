"""The small parts of the port's training slice against the JAX package's:
losses, the learning-rate schedule, the D4 augmentation, the FLOP count,
the metrics CSV and the configs, on the same numpy inputs."""

import csv
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.config.train import DataConfig as JaxDataConfig
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import flops as jax_flops
from plumekit.models import losses as jax_losses
from plumekit.train.augment import _apply_d4
from plumekit.train.state import make_schedule as jax_make_schedule
from plumekit.utils.metrics import MetricsWriter as JaxMetricsWriter
from plumekit_torch.config import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.models import flops, losses
from plumekit_torch.train.augment import apply_d4, augment_batch
from plumekit_torch.train.state import make_schedule
from plumekit_torch.train.step import step_generator
from plumekit_torch.utils import MetricsWriter

LOSS_RTOL = 1e-6    # fp32 sums of 2048 terms, in another order
# optax evaluates the schedule in fp32, and its warmup as (0 − lr)·(1 −
# s/w) + lr, which cancels near step 0: rtol 1e-6 and atol 1e-6·lr
LR_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits_labels(seed=0, soft=False):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(2, 32, 32, 1))).astype(np.float32)
    logits[0, :4, :4] = 0.0                  # the gradient's kink
    labels = rng.random(logits.shape).astype(np.float32)
    if not soft:
        labels = (labels < 0.3).astype(np.float32)
    mask = (rng.random(logits.shape) < 0.7).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_losses_match_jax(masked, soft):
    logits, labels, mask = _logits_labels(1, soft)
    m_np = mask if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    mj = None if m_np is None else jnp.asarray(m_np)
    pairs = [
        (losses.bce_with_logits(lt, yt, m_t),
         jax_losses.bce_with_logits(lj, yj, mj)),
        (losses.dice_loss(lt, yt, m_t), jax_losses.dice_loss(lj, yj, mj)),
        (losses.dice_bce_loss(lt, yt, 0.3, m_t),
         jax_losses.dice_bce_loss(lj, yj, 0.3, mj)),
        (losses.dice_bce_loss(lt, yt, 0.5, m_t, label_smooth=0.1),
         jax_losses.dice_bce_loss(lj, yj, 0.5, mj, label_smooth=0.1)),
        (losses.iou(lt > 0, yt > 0.5), jax_losses.iou(lj > 0, yj > 0.5)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


def test_loss_gradient_matches_jax_at_the_kink():
    """At a logit of exactly 0 the gradient follows jnp.maximum and
    jnp.abs, so a train step's gradients match the JAX step's."""
    import jax

    logits, labels, _ = _logits_labels(2)
    want = jax.grad(lambda a: jax_losses.dice_bce_loss(
        a, jnp.asarray(labels), 0.5, label_smooth=0.05))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    losses.dice_bce_loss(lt, torch.from_numpy(labels), 0.5,
                         label_smooth=0.05).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(learning_rate=1e-3, warmup_steps=5, total_steps=20),
    dict(learning_rate=2e-4, warmup_steps=0, total_steps=7),
    dict(learning_rate=1e-3, warmup_steps=10, total_steps=4),
])
def test_schedule_matches_optax(kw):
    """The lr of steps 0 … total+5, and the optimizer's lr sequence over
    real steps: the first update at lr 0, the tail at 0.05·lr."""
    cfg = TrainConfig(**kw)
    want = jax_make_schedule(JaxTrainConfig(**kw))
    sched = make_schedule(cfg)
    steps = range(cfg.total_steps + 6)
    got = [sched(s) for s in steps]
    atol = LR_RTOL * cfg.learning_rate
    np.testing.assert_allclose(got, [float(want(s)) for s in steps],
                               rtol=LR_RTOL, atol=atol)
    assert got[0] == 0.0 or cfg.warmup_steps == 0
    assert sched(10**6) == pytest.approx(0.05 * cfg.learning_rate,
                                         rel=LR_RTOL)

    from plumekit_torch.train.state import create_state

    state = create_state(UNetConfig(base_features=2, depth=1), cfg, "cpu")
    seen = []
    for _ in range(min(len(got), 12)):
        seen.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    np.testing.assert_allclose(seen, got[:len(seen)], rtol=LR_RTOL,
                               atol=atol)


@pytest.mark.parametrize("code", range(8))
def test_d4_code_matches_jax(code):
    """Each of the 8 codes transforms inputs and labels as
    ``_apply_d4``, bit for bit."""
    rng = np.random.default_rng(code)
    xs = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    codes = torch.full((3,), code)
    got = apply_d4(torch.from_numpy(xs), codes).numpy()
    want = np.stack([np.asarray(_apply_d4(jnp.asarray(x), code))
                     for x in xs])
    assert np.array_equal(got, want)


def test_augment_pairs_inputs_and_labels_per_sample():
    """One code per sample, the same for inputs and labels, drawn from the
    step's generator: the same (seed, step) draws the same codes."""
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(16, 8, 8, 1)).astype(np.float32))
    ax, ay = augment_batch(step_generator(0, 5, "cpu"), xs, xs.clone())
    assert torch.equal(ax, ay)
    bx, _ = augment_batch(step_generator(0, 5, "cpu"), xs, xs)
    assert torch.equal(ax, bx)
    cx, _ = augment_batch(step_generator(0, 6, "cpu"), xs, xs)
    assert not torch.equal(ax, cx)
    # every output sample is one of its input's 8 transforms
    for i in range(16):
        views = [apply_d4(xs[i:i + 1], torch.tensor([c])) for c in range(8)]
        assert any(torch.equal(ax[i:i + 1], v) for v in views)


@pytest.mark.parametrize("kw", [
    dict(), dict(base_features=8, depth=2),
    dict(in_channels=3, out_channels=2, depth=3), dict(arch="unetpp"),
    dict(arch="unetpp", deep_supervision=True),
    dict(arch="unetpp", deep_supervision=True, prune_level=2),
    dict(arch="unetpp", deep_supervision=True, out_channels=2, depth=3,
         prune_level=1)])
def test_flops_match_jax(kw):
    assert flops.model_flops_per_pixel(UNetConfig(**kw)) == \
        jax_flops.model_flops_per_pixel(JaxUNetConfig(**kw))
    assert flops.sliding_redundancy(2048, 288, 32) == \
        jax_flops.sliding_redundancy(2048, 288, 32)


def test_flops_peak_is_the_h100_data_sheet():
    assert flops.PEAK_TFLOPS == {"bf16": 989.0, "int8": 1979.0}
    got = flops.mfu(100.0, 367808.0 * 3)
    assert got == {"tflops": 110.3, "pct_peak": 11.2}
    # UNet++ at UNetConfig(arch="unetpp"): 2.47x the U-Net's 367,808
    assert flops.model_flops_per_pixel(UNetConfig(arch="unetpp")) \
        == 908480.0


def test_metrics_writer_matches_jax(tmp_path):
    """Same rows, and the header extended on a resume that logs a new key,
    byte for byte."""
    for writer_cls, name in ((MetricsWriter, "port"),
                             (JaxMetricsWriter, "jax")):
        path = str(tmp_path / name / "m.csv")
        w = writer_cls(path)
        w.write(1, {"loss": 0.5, "iou": np.float32(0.25)})
        w.write(2, {"loss": 0.4, "iou": 0.3})
        w = writer_cls(path)                 # resume
        w.write(3, {"loss": 0.3, "iou": 0.35, "eval_iou": 0.2})
    port, jax = ((tmp_path / n / "m.csv").read_text() for n in ("port", "jax"))
    assert port == jax
    rows = list(csv.DictReader(port.splitlines()))
    assert [r["step"] for r in rows] == ["1", "2", "3"]
    assert rows[0]["eval_iou"] == "" and rows[2]["eval_iou"] == "0.2"


def test_configs_read_as_in_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(
        JaxDataConfig())
