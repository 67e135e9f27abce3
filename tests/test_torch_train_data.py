"""The port's training data against the JAX package's: synthetic and
weakly labelled granules, the host tile stream from the same numpy
generator, and the device-resident dataset and its draw rule (on CPU
tensors here). The device draws' random values come from a torch
generator, not from ``jax.random``, so the rule is held against the JAX
function's clip-and-slice on given values."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from plumekit.config.train import DataConfig as JaxDataConfig
from plumekit.train import data as jax_data
from plumekit.train import device_data as jax_device_data
from plumekit_torch.config import DataConfig
from plumekit_torch.train import data, device_data
from plumekit_torch.train.step import step_generator

DATA = dict(granule_size=96, n_train_granules=2, n_eval_granules=1)
TILE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples():
    """(port, JAX) synthetic training samples, plus a sub-tile granule
    (edge-padded by both packages)."""
    port = data.make_synthetic_dataset(DataConfig(**DATA), train=True)
    jax_s = jax_data.make_synthetic_dataset(JaxDataConfig(**DATA),
                                            train=True)
    small = DataConfig(**dict(DATA, granule_size=24, n_train_granules=1))
    port += data.make_synthetic_dataset(small, train=True)
    jax_s += jax_data.make_synthetic_dataset(
        JaxDataConfig(**dict(DATA, granule_size=24, n_train_granules=1)),
        train=True)
    return port, jax_s


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_dataset_equals_jax(train):
    port = data.make_synthetic_dataset(DataConfig(**DATA), train=train)
    want = jax_data.make_synthetic_dataset(JaxDataConfig(**DATA), train=train)
    assert len(port) == len(want)
    for p, w in zip(port, want):
        assert p.channels.dtype == w.channels.dtype == np.float32
        assert np.array_equal(p.channels, w.channels)
        assert np.array_equal(p.mask, w.mask)


def test_weak_label_dataset_equals_jax():
    """One 128² granule labelled by the rg detector in each package: the
    same channels and the same union of accepted plume masks."""
    cfg = dict(granule_size=128, n_train_granules=1)
    port = data.make_weak_label_dataset(DataConfig(**cfg), device="cpu")
    want = jax_data.make_weak_label_dataset(JaxDataConfig(**cfg))
    assert port[0].mask.any()
    assert np.array_equal(port[0].channels, want[0].channels)
    assert np.array_equal(port[0].mask, want[0].mask)


@pytest.mark.parametrize("seed", [0, (3, 40)])
def test_tile_batches_equal_jax_bit_for_bit(samples, seed):
    """The same numpy generator draws the same tiles: the training stream
    (seeded as the loop seeds it on a resume) and the 4-batch eval stream."""
    port, want = samples
    got = data.tile_batches(port, TILE, 4, np.random.default_rng(seed))
    ref = jax_data.tile_batches(want, TILE, 4, np.random.default_rng(seed))
    for _ in range(6):
        (gx, gy), (wx, wy) = next(got), next(ref)
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    got = list(data.tile_batches(port, TILE, 4, np.random.default_rng(1),
                                 steps=4))
    ref = list(jax_data.tile_batches(want, TILE, 4, np.random.default_rng(1),
                                     steps=4))
    assert len(got) == len(ref) == 4
    for (gx, gy), (wx, wy) in zip(got, ref):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_device_dataset_equals_jax(samples):
    port, want = samples
    ds = device_data.build_device_dataset(port, TILE, "cpu")
    ref = jax_device_data.build_device_dataset(want, TILE)
    for name in ("channels", "masks", "plume_rows", "plume_cols",
                 "plume_count", "heights", "widths"):
        assert np.array_equal(getattr(ds, name).numpy(),
                              np.asarray(getattr(ref, name))), name


def _jax_rule(ref, tile, i, use_plume, p, jy, jx, cy_u, cx_u):
    """The body of the JAX ``draw_tile_batch``'s ``one`` on given integer
    draws: its clip rule and its slices."""
    xs, ys = [], []
    for b in range(len(i)):
        g = int(i[b])
        h, w = ref.heights[g], ref.widths[g]
        cnt = ref.plume_count[g]
        plume = bool(use_plume[b]) & (cnt > 0)
        cy_p = jnp.clip(ref.plume_rows[g, p[b]] - tile // 2 + jy[b], 0,
                        h - tile)
        cx_p = jnp.clip(ref.plume_cols[g, p[b]] - tile // 2 + jx[b], 0,
                        w - tile)
        cy = jnp.where(plume, cy_p, cy_u[b])
        cx = jnp.where(plume, cx_p, cx_u[b])
        C = ref.channels.shape[-1]
        xs.append(lax.dynamic_slice(ref.channels, (g, cy, cx, 0),
                                    (1, tile, tile, C))[0])
        ys.append(lax.dynamic_slice(ref.masks, (g, cy, cx),
                                    (1, tile, tile))[0][..., None])
    return np.stack(xs), np.stack(ys)


def test_draw_rule_with_given_values_equals_jax_rule(samples):
    """Given draw values (plume-centred draws near every edge, uniform
    draws at both ends of their range), the port's clip-and-slice equals
    the JAX rule's tiles."""
    port, want = samples
    ds = device_data.build_device_dataset(port, TILE, "cpu")
    ref = jax_device_data.build_device_dataset(want, TILE)
    rng = np.random.default_rng(7)
    B = 24
    i = rng.integers(0, ds.channels.shape[0], B)
    use_plume = rng.random(B) < 0.6
    cnt = ds.plume_count.numpy()[i]
    p = (rng.random(B) * np.maximum(cnt, 1)).astype(np.int64)
    jy, jx = rng.integers(-8, 9, B), rng.integers(-8, 9, B)
    span_y = ds.heights.numpy()[i] - TILE + 1
    span_x = ds.widths.numpy()[i] - TILE + 1
    cy_u = np.where(np.arange(B) % 3 == 0, span_y - 1,
                    rng.integers(0, 1 << 30, B) % span_y)
    cx_u = np.where(np.arange(B) % 4 == 0, 0,
                    rng.integers(0, 1 << 30, B) % span_x)

    def u(k, n):      # a uniform whose floor(u·n) is k
        return torch.from_numpy((k + 0.5) / n)

    draws = device_data.Draws(
        granule=torch.from_numpy(i), plume=torch.from_numpy(use_plume),
        u_pixel=u(p, np.maximum(cnt, 1)), jy=torch.from_numpy(jy),
        jx=torch.from_numpy(jx), u_y=u(cy_u, span_y), u_x=u(cx_u, span_x))
    gx, gy = device_data.tiles_from_draws(ds, draws, TILE)
    wx, wy = _jax_rule(ref, TILE, i, use_plume, p, jy, jx, cy_u, cx_u)
    assert np.array_equal(gx.numpy(), wx) and np.array_equal(gy.numpy(), wy)


def test_device_draws_are_counter_based(samples):
    """The batch of step s is a function of (seed, s) alone: two draws of
    one step are equal, another step draws another batch, every tile lies
    in its granule's valid extent, and about half are plume-centred."""
    port, _ = samples
    ds = device_data.build_device_dataset(port, TILE, "cpu")

    def batch(seed, step):
        return device_data.draw_tile_batch(
            ds, step_generator(seed, step, "cpu"), 64, TILE)

    a, b, c = batch(0, 9), batch(0, 9), batch(0, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert torch.isfinite(a[0]).all() and a[0].shape == (64, TILE, TILE, 2)
    draws = device_data.draw_values(ds, step_generator(0, 9, "cpu"), 64)
    g, cy, cx = device_data.draw_origins(ds, draws, TILE)
    assert ((cy >= 0) & (cy + TILE <= ds.heights[g])).all()
    assert ((cx >= 0) & (cx + TILE <= ds.widths[g])).all()
    assert 0.3 < float((a[1] > 0.5).flatten(1).any(1).float().mean()) < 1.0


def test_device_multi_step_resume_continues_the_schedule(samples):
    """Steps 0-5 in one call equal steps 0-2, then 3-5 from the state saved
    and restored in between (the same draws and codes per step)."""
    from plumekit_torch.config import TrainConfig, UNetConfig
    from plumekit_torch.train.state import create_state

    port, _ = samples
    ds = device_data.build_device_dataset(port, TILE, "cpu")
    ucfg = UNetConfig(base_features=4, depth=2, compute_dtype="float32")
    tcfg = TrainConfig(batch_size=2, tile_size=TILE, warmup_steps=1,
                       total_steps=6, learning_rate=1e-3)
    multi = device_data.make_device_multi_step(seed=5, tile=TILE,
                                               batch_size=2)
    one = create_state(ucfg, tcfg, "cpu")
    one, m_one = multi(one, ds, range(6))
    two = create_state(ucfg, tcfg, "cpu")
    two, _ = multi(two, ds, range(3))
    saved = {k: v for k, v in two.state_dict().items()}
    import copy

    resumed = create_state(ucfg, dataclasses.replace(tcfg, seed=99), "cpu")
    resumed.load_state_dict(copy.deepcopy(saved))
    resumed, m_two = multi(resumed, ds, range(3, 6))
    assert resumed.step == one.step == 6
    assert torch.equal(m_one["loss"], m_two["loss"])
    for (name, a), b in zip(one.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
