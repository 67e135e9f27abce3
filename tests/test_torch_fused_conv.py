"""plumekit_torch's single conv (K5) and double-conv block (K6) against the
JAX package's Pallas kernels, run in interpret mode on the CPU, on the same
numpy inputs. On the CPU the port's wrappers run their plain versions; the
CUDA kernels themselves are held against those plain versions on the card by
tests/test_torch_kernels_cuda.py (which imports no JAX) and by
``chip_smoke.py``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models.pallas.fused_conv import (
    fold_batchnorm as jax_fold_batchnorm,
    fused_conv3x3_bn_relu as jax_single_conv,
    fused_double_conv3x3_bn_relu as jax_double_conv,
)
from plumekit_torch.models.kernels import fused_conv

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import double_conv_case as _inputs  # noqa: E402

# the cases of tests/test_pallas_kernels.py's double-conv test, plus Cin = 2
# (the U-Net's first block) and an odd width
CASES = [
    ((1, 16, 24, 4), 8, 8, 8),
    ((2, 32, 40, 6), 12, 10, 16),
    ((1, 10, 16, 4), 8, 4, 8),
    ((2, 16, 16, 2), 8, 8, 8),
    ((1, 12, 13, 4), 8, 6, 4),
]
# fp32: the same sums in another order
F32_TOL = 1e-4
# bf16: both sides round the conv1 output and the result to bf16 from fp32
# sums taken in another order; allow two bf16 steps (2^-7 relative each)
BF16_ATOL = BF16_RTOL = 2.0 ** -6


@pytest.mark.parametrize("shape,cm,co,tm", CASES)
def test_double_conv_matches_jax_fp32(shape, cm, co, tm):
    arrays = _inputs(0, shape, cm, co)
    want = jax_double_conv(*[jnp.asarray(a) for a in arrays], tile_rows=tm,
                           interpret=True)
    got = fused_conv.fused_double_conv3x3_bn_relu(
        *[torch.from_numpy(a) for a in arrays])
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape,cm,co,tm", CASES[:2] + CASES[3:])
def test_double_conv_matches_jax_bf16(shape, cm, co, tm):
    """bf16 activations, weights, scales and shifts, as the fused forward
    casts them (plumekit/models/fused_forward.py:42-43)."""
    arrays = _inputs(1, shape, cm, co)
    want = jax_double_conv(
        *[jnp.asarray(a, jnp.bfloat16) for a in arrays], tile_rows=tm,
        interpret=True)
    got = fused_conv.fused_double_conv3x3_bn_relu(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_ATOL + BF16_RTOL * np.abs(want)).all(), err.max()


# the single-conv cases of tests/test_pallas_kernels.py (:17-43, :72-80):
# (shape, Cout, tile_rows), then an odd width and the U-Net's first conv
SINGLE_CASES = [
    ((2, 16, 24, 2), 8, 8),
    ((2, 16, 24, 8), 16, 8),
    ((1, 10, 16, 4), 4, 8),        # odd H: the TPU tile shrinks to 2 rows
    ((1, 12, 13, 4), 6, 4),
    ((2, 16, 16, 2), 32, 16),
]


@pytest.mark.parametrize("shape,co,tm", SINGLE_CASES)
def test_single_conv_matches_jax_fp32(shape, co, tm):
    """fp32: rtol = atol = 1e-5, the JAX test's own bound against XLA."""
    x, w, scale, shift = _inputs(4, shape, co, co)[:4]
    want = jax_single_conv(*map(jnp.asarray, (x, w, scale, shift)),
                           tile_rows=tm, interpret=True)
    got = fused_conv.fused_conv3x3_bn_relu(
        *map(torch.from_numpy, (x, w, scale, shift)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,co,tm", [((1, 8, 16, 8), 8, 16),
                                         SINGLE_CASES[1]])
def test_single_conv_matches_jax_bf16(shape, co, tm):
    """bf16 in and out, fp32 accumulation: the JAX test's 0.05."""
    arrays = _inputs(5, shape, co, co)[:4]
    want = jax_single_conv(*[jnp.asarray(a, jnp.bfloat16) for a in arrays],
                           tile_rows=tm, interpret=True)
    got = fused_conv.fused_conv3x3_bn_relu(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in arrays])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


def test_single_conv_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(fused_conv, "_library", refuse)
    arrays = [torch.from_numpy(a) for a in _inputs(3, (1, 8, 8, 3), 4, 4)[:4]]
    before = fused_conv.SINGLE_LAUNCHES
    out = fused_conv.fused_conv3x3_bn_relu(*arrays)
    assert torch.equal(out, fused_conv.conv3x3_bn_relu_ref(*arrays))
    assert fused_conv.SINGLE_LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_conv.fused_conv3x3_bn_relu(arrays[0].to("meta"), *arrays[1:])


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(2)
    gamma, beta, mean = (rng.normal(size=16).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.1, 3, 16).astype(np.float32)
    want = jax_fold_batchnorm(*map(jnp.asarray, (gamma, beta, mean, var)))
    got = fused_conv.fold_batchnorm(*map(torch.from_numpy,
                                         (gamma, beta, mean, var)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version and is not counted as a
    launch; a tensor on any other non-CUDA device is refused."""
    import plumekit_torch.cuda_build as cuda_build

    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(fused_conv, "_library", refuse)
    arrays = [torch.from_numpy(a) for a in _inputs(3, (1, 8, 8, 3), 4, 4)]
    before = fused_conv.LAUNCHES
    out = fused_conv.fused_double_conv3x3_bn_relu(*arrays)
    ref = fused_conv.double_conv3x3_bn_relu_ref(*arrays)
    assert torch.equal(out, ref)
    assert fused_conv.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_conv.fused_double_conv3x3_bn_relu(
            arrays[0].to("meta"), *arrays[1:])
