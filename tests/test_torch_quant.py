"""plumekit_torch.ops.quant against plumekit.ops.quant on the same numpy
inputs: the uint16 payload and the prob codecs bit for bit, the dequant
within one float32 ulp of the value (XLA on the CPU may contract
``q·scale + lo`` into one FMA; the port multiplies and adds in two
roundings), the non-finite refusal and a constant channel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.ops import quant as jax_quant
from plumekit_torch.ops import quant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channels(seed, shape=(37, 53, 2)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    return x * np.asarray([2.3, 1.0], np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_uint16_is_the_jax_payload(seed):
    x = _channels(seed)
    q, lo, scale = quant.quantize_uint16(x)
    jq, jlo, jscale = jax_quant.quantize_uint16(x)
    assert q.dtype == np.uint16 and q.shape == x.shape
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(scale, jscale)


def test_dequantize_within_one_ulp_of_jax():
    x = _channels(3)
    q, lo, scale = quant.quantize_uint16(x)
    want = np.asarray(jax_quant.dequantize(jnp.asarray(q), lo, scale))
    for payload in (torch.from_numpy(q),
                    torch.from_numpy(quant.uint16_bits(q))):
        got = quant.dequantize(payload, torch.from_numpy(lo),
                               torch.from_numpy(scale)).numpy()
        assert got.dtype == np.float32
        ulp = np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= ulp), payload.dtype
    # and the decode lies within half a step of the input
    assert np.all(np.abs(got - x) <= scale / 2 + 1e-6)


def test_prob_codecs_are_the_jax_codecs():
    rng = np.random.default_rng(4)
    p = rng.random((5, 33, 31)).astype(np.float32)
    # exact halves of the code: round half to even, as jnp.round
    p[0, 0, :4] = np.asarray([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0
    p[0, 1, :2] = [0.0, 1.0]
    got = quant.quantize_probs_uint8(torch.from_numpy(p)).numpy()
    want = np.asarray(jax_quant.quantize_probs_uint8(jnp.asarray(p)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    back = quant.dequantize_probs_uint8(got)
    np.testing.assert_array_equal(back,
                                  jax_quant.dequantize_probs_uint8(want))
    assert back.dtype == np.float32
    assert np.abs(back - p).max() <= 1 / 510 + 1e-7


def test_non_finite_is_refused_and_a_constant_channel_decodes():
    x = _channels(5)
    x[3, 4, 1] = np.nan
    with pytest.raises(ValueError, match="finite"):
        quant.quantize_uint16(x)
    x[3, 4, 1] = np.inf
    with pytest.raises(ValueError, match="finite"):
        quant.quantize_uint16(x)
    c = np.zeros((8, 8, 2), np.float32)
    c[..., 0] = 0.7
    q, lo, scale = quant.quantize_uint16(c)
    jq, jlo, jscale = jax_quant.quantize_uint16(c)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    back = quant.dequantize(torch.from_numpy(q), torch.from_numpy(lo),
                            torch.from_numpy(scale)).numpy()
    assert np.isfinite(back).all()
    np.testing.assert_allclose(back, c, atol=1e-5)
