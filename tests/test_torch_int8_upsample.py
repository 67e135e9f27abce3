"""plumekit_torch's int8 transposed conv Q2
(``models/kernels/int8_upsample.py``): its plain version against the JAX
package's ``_quant_act(_upsample_q(...))`` on the same numpy inputs, the
weight packing and its cache, the shape rule, the wrapper's devices, and a
plain emulation of the CUDA kernel's index scheme (tests/
torch_int8_emulation.py: pixel runs as GEMM rows, the s8 wgmma descriptor
addresses, the m64nNk32 fragments, and the epilogue's pixel shuffle from
column (2·di + dj)·Cout + o to output pixel (2i + di, 2j + dj)) against the
plain version. The kernel itself is held against the plain version on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models import quantized_forward as jq
from plumekit_torch.models import quantized_forward as tq
from plumekit_torch.models.kernels import int8_upsample
from plumekit_torch.models.kernels.int8_conv import KC, Shape, round_up
from torch_int8_emulation import Block, run_grid

# int8 outputs against XLA, which may contract acc·sw + bias into one FMA:
# an ulp of the fp32 value can move a quotient across a rounding boundary,
# so one step, on a tiny share of the values
INT8_MAX_STEP, INT8_MAX_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, shape, cout):
    """(x, kq, sw, bias, scale) with outputs spread over the int8 range."""
    cin = shape[-1]
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    kq = rng.integers(-127, 128, (2, 2, cin, cout), dtype=np.int8)
    sw = (rng.uniform(0.5, 1.5, cout) * 4.0 / (64 * 73 * cin ** 0.5)) \
        .astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, kq, sw, bias, np.float32(12.0 / 127)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------ the plain version vs JAX

@pytest.mark.parametrize("shape,cout", [((2, 9, 9, 512), 256),
                                        ((2, 18, 18, 256), 128),
                                        ((1, 11, 7, 64), 32),
                                        ((3, 5, 6, 20), 12)])
def test_accumulators_equal_jax_einsum(shape, cout):
    rng = np.random.default_rng(sum(shape) + cout)
    x, kq = _inputs(rng, shape, cout)[:2]
    want = np.asarray(jnp.einsum("bhwc,ijco->bhwijo", jnp.asarray(x),
                                 jnp.asarray(kq),
                                 preferred_element_type=jnp.int32))
    xt, kt = _torch(x, kq)
    got = int8_upsample.int8_conv.int_mm(
        xt.reshape(-1, shape[-1]), int8_upsample.upsample_columns(kt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("shape,cout", [((2, 9, 9, 512), 256),
                                        ((2, 18, 18, 64), 32),
                                        ((3, 5, 6, 20), 12)])
def test_plain_version_matches_jax_upsample_and_requant(shape, cout):
    rng = np.random.default_rng(3 * cout)
    x, kq, sw, bias, s = _inputs(rng, shape, cout)
    y = jq._upsample_q(*(jnp.asarray(v) for v in (x, kq, sw, bias)))
    want = np.asarray(jq._quant_act(y, s))
    got = int8_upsample.int8_upsample2x2_ref(*_torch(x, kq, sw, bias),
                                             torch.tensor(s))
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= INT8_MAX_STEP and (d > 0).mean() <= INT8_MAX_SHARE
    # the dequantized plane before the requant: XLA's FMA moves an ulp
    np.testing.assert_allclose(
        int8_upsample.upsample_dequant_ref(*_torch(x, kq, sw, bias)).numpy(),
        np.asarray(y), rtol=1e-6, atol=1e-6)


def test_the_forward_keeps_the_plain_upsample_under_its_old_name():
    assert tq._upsample_q is int8_upsample.upsample_dequant_ref


# --------------------------------------------------------- packing, shapes

@pytest.mark.parametrize("cin,cout", [(512, 256), (64, 32), (20, 12),
                                      (40, 100)])
def test_weight_packing_round_trips(cin, cout):
    rng = np.random.default_rng(cin + cout)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, cin, cout),
                                       dtype=np.int8))
    for shape in int8_upsample.upsample_candidates(cout):
        packed = int8_upsample.pack_upsample_weights(kq, shape)
        np_ = round_up(4 * cout, shape.nb)
        assert packed.shape == (np_ // shape.nb, round_up(cin, KC) // KC, 1,
                                2, shape.nb, 16)
        flat = packed.permute(0, 4, 2, 1, 3, 5).reshape(np_, -1)
        assert torch.equal(flat[:4 * cout, :cin].t(),
                           int8_upsample.upsample_columns(kq))
        assert packed.abs().sum() == kq.abs().sum()
        # column (2 di + dj)·cout + o of chunk k // 32 is kq[di, dj, k, o]
        di, dj, k, o = 1, 0, cin - 1, cout - 1
        n = (2 * di + dj) * cout + o
        assert packed[n // shape.nb, k // KC, 0, (k % KC) // 16,
                      n % shape.nb, k % 16] == kq[di, dj, k, o]


def test_packed_weights_are_cached_and_refreshed():
    rng = np.random.default_rng(1)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, 64, 32),
                                       dtype=np.int8))
    sw, bias = torch.ones(32), torch.arange(32.0)
    first = int8_upsample.pack_upsample(kq, sw, bias)
    assert int8_upsample.pack_upsample(kq, sw, bias) is first
    assert first.a.shape == first.b.shape == (first.np_,)
    assert torch.equal(first.b[:128], bias.repeat(4))
    kq[0, 0, 0, 0] = 5 if kq[0, 0, 0, 0] != 5 else 6     # in place
    second = int8_upsample.pack_upsample(kq, sw, bias)
    assert second is not first and \
        second.wt[0, 0, 0, 0, 0, 0] == kq[0, 0, 0, 0]
    assert int8_upsample.pack_upsample(kq, sw.clone(), bias) is not second
    with pytest.raises(ValueError, match="do not fit"):
        int8_upsample.pack_upsample(kq, torch.ones(31), bias)
    with pytest.raises(ValueError, match="folded"):
        int8_upsample.pack_upsample(kq, sw, bias, Shape(32, 4, True))


@pytest.mark.parametrize("cout", [256, 128, 64, 32, 12, 5])
def test_upsample_shape_rule(cout):
    shape = int8_upsample.upsample_shape(cout)
    assert shape in int8_upsample.upsample_candidates(cout)
    assert not shape.fold and shape.nb <= round_up(4 * cout, KC)


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(2)
    x, kq, sw, bias, s = _torch(*_inputs(rng, (1, 4, 4, 32), 16))
    before = int8_upsample.LAUNCHES
    got = int8_upsample.int8_upsample2x2(x, kq, sw, bias, s)
    assert torch.equal(got, int8_upsample.int8_upsample2x2_ref(x, kq, sw,
                                                               bias, s))
    assert got.shape == (1, 8, 8, 16)
    assert int8_upsample.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        int8_upsample.int8_upsample2x2(x.to("meta"), kq, sw, bias, s)
    with pytest.raises(ValueError, match="no kernel"):
        int8_upsample.int8_upsample2x2_packed(
            x, int8_upsample.pack_upsample(kq, sw, bias), s)


# ------------------------------------- the kernel's index scheme, emulated

def emulate_q2(x, packed, scale):
    bsz, h, w, cin = x.shape
    blk = Block(x0=x, x1=None, wt=packed.wt.numpy(), a=packed.a.numpy(),
                b=packed.b.numpy(), scale=scale, B=bsz, H=h, W=w, c0=cin,
                c0p=packed.kp, c1=0, n_k=packed.kp // KC, cout=packed.cout,
                n_pass=packed.np_ // packed.shape.nb, nb=packed.shape.nb,
                mt=packed.shape.mt, th=1, tw=1, g=1,
                pitch=128 * packed.shape.mt + 2)
    return run_grid(blk, "point", (bsz, 2 * h, 2 * w, packed.cout), np.int8)


@pytest.mark.parametrize("shape,cout,kernel_shape", [
    ((1, 9, 9, 64), 32, Shape(128, 2)),     # two chunks, one pass
    ((2, 5, 7, 64), 64, Shape(64, 2)),      # four passes, ragged run
    ((1, 6, 6, 128), 64, Shape(256, 1)),    # one wide pass
    ((1, 8, 9, 40), 24, Shape(32, 4)),      # Cin, Cout off the 32s
    ((3, 3, 5, 20), 12, Shape(64, 2))])     # quadrants off the 16s
def test_kernel_index_scheme_matches_plain_version(shape, cout, kernel_shape):
    rng = np.random.default_rng(sum(shape) + cout)
    x, kq, sw, bias, s = _inputs(rng, shape, cout)
    packed = int8_upsample.pack_upsample(*_torch(kq, sw, bias),
                                         shape=kernel_shape)
    got, written = emulate_q2(x, packed, s)
    want = int8_upsample.int8_upsample2x2_ref(*_torch(x, kq, sw, bias),
                                              torch.tensor(s))
    assert (written == 1).all()                  # every output once
    np.testing.assert_array_equal(got, want.numpy())
