"""The port's quantized training transfers (``quantize_transfer``) and its
prefetched host stream against the JAX package's: the quantized samples
and tile stream bit for bit, the quantized loop against the JAX dequant
step over the JAX quantized stream, the quantized loop within the JAX
package's own bounds of the float loop (``tests/test_quant_transfer.py``:
loss abs 5e-3, eval IoU 0.02; K-step chunks 1e-3), the card-resident
quantized set, and the loop's prefetched stream against the serial
``host_batches``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import DataConfig as JaxDataConfig
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.train import data as jax_data
from plumekit.train.state import create_state as jax_create_state
from plumekit.train.step import make_train_step as jax_make_train_step
from plumekit_torch import cli
from plumekit_torch.config import DataConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.ops.quant import dequantize
from plumekit_torch.train import checkpoint as ckpt
from plumekit_torch.train import data
from plumekit_torch.train.device_data import (build_device_dataset,
                                              draw_tile_batch)
from plumekit_torch.train.loop import host_batches, host_chunks, train
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step, step_generator

SMALL = dict(in_channels=2, base_features=8, depth=2,
             compute_dtype="float32")
DATA = dict(granule_size=96, n_train_granules=2, n_eval_granules=1)
LOSS_ABS = 5e-3      # tests/test_quant_transfer.py:114
IOU_ABS = 0.02       # tests/test_quant_transfer.py:115
CHUNK_ABS = 1e-3     # tests/test_quant_transfer.py:123
LOSS_RTOL = 1e-4     # fp32; the dequant may sit one ulp from XLA's FMA
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples():
    return data.make_synthetic_dataset(DataConfig(**DATA), train=True)


def _tcfg(tmp_path, **kw):
    base = dict(batch_size=4, tile_size=32, total_steps=6, warmup_steps=2,
                log_every=3, checkpoint_every=1000, augment=False,
                checkpoint_dir=str(tmp_path / "ckpt"))
    return TrainConfig(**{**base, **kw})


def _run(tmp_path, **kw):
    return train(UNetConfig(**SMALL), _tcfg(tmp_path, **kw),
                 DataConfig(**DATA), device="cpu")


def test_quantized_samples_and_tiles_are_the_jax_ones(samples):
    jax_samples = jax_data.make_synthetic_dataset(JaxDataConfig(**DATA))
    got = data.quantize_samples(samples)
    want = jax_data.quantize_samples(jax_samples)
    for g, w in zip(got, want):
        assert g.channels.dtype == np.uint16 and g.mask.dtype == np.uint8
        np.testing.assert_array_equal(g.channels, w.channels)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.lo, w.lo)
        np.testing.assert_array_equal(g.scale, w.scale)
    ours = data.tile_batches_quant(got, 32, 4, np.random.default_rng(7),
                                   steps=3)
    theirs = jax_data.tile_batches_quant(want, 32, 4,
                                         np.random.default_rng(7), steps=3)
    floats = data.tile_batches(samples, 32, 4, np.random.default_rng(7),
                               steps=3)
    for (q, lo, scale, y8), jq, (xs, ys) in zip(ours, theirs, floats):
        for a, b in zip((q, lo, scale, y8), jq):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        # the same tiles as the float stream, within half a step
        back = dequantize(torch.from_numpy(q), torch.from_numpy(lo)[
            :, None, None, :], torch.from_numpy(scale)[:, None, None, :])
        assert np.all(np.abs(back.numpy() - xs)
                      <= scale[:, None, None, :] / 2 + 1e-6)
        np.testing.assert_array_equal(y8, np.rint(ys * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="sidecars"):
        next(data.tile_batches_quant(samples, 32, 4,
                                     np.random.default_rng(0)))


def test_quantized_loop_matches_the_jax_dequant_step(tmp_path):
    """Three steps of the quantized loop from carried-over parameters equal
    the JAX ``make_train_step(dequant=True)`` over the JAX quantized
    stream."""
    data_kw = dict(granule_size=64, n_train_granules=1, n_eval_granules=1)
    tcfg = _tcfg(tmp_path, batch_size=2, total_steps=3, warmup_steps=1,
                 learning_rate=1e-3, log_every=1, quantize_transfer=True)
    jstate = jax_create_state(jax.random.PRNGKey(0), JaxUNetConfig(**SMALL),
                              JaxTrainConfig(batch_size=2, tile_size=32,
                                             total_steps=3, warmup_steps=1,
                                             learning_rate=1e-3))
    start = create_state(UNetConfig(**SMALL), tcfg, "cpu")
    start.model.load_state_dict(from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})))
    ckpt.save_checkpoint(tcfg.checkpoint_dir, start, 0)
    hist = train(UNetConfig(**SMALL), tcfg, DataConfig(**data_kw),
                 device="cpu")

    jsamples = jax_data.quantize_samples(
        jax_data.make_synthetic_dataset(JaxDataConfig(**data_kw)))
    stream = jax_data.tile_batches_quant(jsamples, 32, 2,
                                         np.random.default_rng((0, 0)))
    jstep = jax_make_train_step(0.5, augment=False, dequant=True)
    losses = []
    for i in range(3):
        jstate, m = jstep(jstate, tuple(jnp.asarray(a) for a in next(stream)),
                          jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(hist["loss"], losses, rtol=LOSS_RTOL)


def test_quantized_loop_lies_within_the_jax_bounds_of_the_float_loop(
        tmp_path):
    hf = _run(tmp_path / "f")
    hq = _run(tmp_path / "q", quantize_transfer=True)
    assert hq["loss"] == pytest.approx(hf["loss"], abs=LOSS_ABS)
    assert hq["eval_iou"][-1] == pytest.approx(hf["eval_iou"][-1],
                                               abs=IOU_ABS)
    hk = _run(tmp_path / "k", quantize_transfer=True, steps_per_dispatch=3)
    assert hk["loss"] == pytest.approx(hq["loss"], abs=CHUNK_ABS)


def test_card_resident_quantized_set(tmp_path, samples):
    """The quantized set stores 5 of the float set's 12 bytes per pixel and
    draws the float set's tiles within half a step; its loop lies within
    the JAX bounds of the float card-resident loop."""
    flt = build_device_dataset(samples, 32, CPU)
    qnt = build_device_dataset(samples, 32, CPU, quantized=True)
    assert qnt.channels.dtype == torch.int16 and qnt.masks.dtype == \
        torch.uint8
    assert flt.lo is None and qnt.lo.shape == (2, 2)
    nbytes = [sum(t.numel() * t.element_size() for t in (d.channels, d.masks))
              for d in (flt, qnt)]
    assert 12 * nbytes[1] == 5 * nbytes[0]    # 2·2 + 1 against 2·4 + 4 B/px
    for step in range(3):
        xs, ys = draw_tile_batch(flt, step_generator(0, step, CPU), 4, 32)
        xq, yq = draw_tile_batch(qnt, step_generator(0, step, CPU), 4, 32)
        assert xq.dtype == yq.dtype == torch.float32
        assert float((xq - xs).abs().max()) <= float(qnt.scale.max()) / 2 \
            + 1e-6
        assert torch.equal(yq, ys)
    hf = _run(tmp_path / "f", device_data=True)
    hq = _run(tmp_path / "q", device_data=True, quantize_transfer=True)
    assert hq["loss"] == pytest.approx(hf["loss"], abs=LOSS_ABS)
    assert hq["eval_iou"][-1] == pytest.approx(hf["eval_iou"][-1],
                                               abs=IOU_ABS)


def test_prefetched_stream_gives_the_losses_of_host_batches(tmp_path,
                                                            samples):
    """The loop's stream (drawn, stacked and uploaded on the stager) and the
    serial ``host_batches`` feed the same steps the same batches."""
    tcfg = _tcfg(tmp_path)
    rng = (tcfg.seed, 0)
    chunks = host_chunks(samples, 32, 4, np.random.default_rng(rng), CPU,
                         [1, 3, 2])
    serial = host_batches(samples, 32, 4, np.random.default_rng(rng), CPU)
    got = [b for chunk in chunks for b in zip(*chunk)]
    assert len(got) == 6
    for xs, ys in got:
        sx, sy = next(serial)
        assert torch.equal(xs, sx) and torch.equal(ys, sy)

    step = make_train_step(augment=False)
    state = create_state(UNetConfig(**SMALL), tcfg, CPU)
    serial = host_batches(samples, 32, 4, np.random.default_rng(rng), CPU)
    losses = []
    for s in range(6):
        state, m = step(state, *next(serial), step_generator(0, s, CPU))
        if (s + 1) % 3 == 0:
            losses.append(float(m["loss"]))
    hist = train(UNetConfig(**SMALL), tcfg, DataConfig(**DATA), device="cpu")
    assert hist["loss"] == losses


def test_train_model_takes_quantize_transfer(tmp_path, caplog):
    import logging

    with caplog.at_level(logging.INFO):
        assert cli.main(["train_model", "--root", str(tmp_path), "--device",
                         "cpu", "--quantize-transfer", "--granule-size", "64",
                         "--tile", "32", "--batch-size", "2", "--steps",
                         "2"]) == 0
    assert "final eval IoU" in caplog.text
