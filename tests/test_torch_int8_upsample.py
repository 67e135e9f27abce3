"""plumekit_torch's int8 transposed conv Q2
(``models/kernels/int8_upsample.py``): its plain version against the JAX
package's ``_quant_act(_upsample_q(...))`` on the same numpy inputs, the
weight packing (swizzled rows, packed columns) and its cache, the layout a
packed weight carries, the shape rule and the item blocks, the op's schema,
the wrapper's devices, and a plain emulation of the CUDA kernel's index
scheme (tests/torch_int8_emulation.py ``run_q2``: k × n blocks of the plane
as items, slices of columns, TMA boxes into swizzled stages, the swizzled
s8 wgmma descriptors, each consumer warpgroup's m64nNk32 fragments, the
epilogue's swizzled output tile and the clipped TMA store boxes that put
column di·Cp + dj·Cout + o at output pixel (2i + di, 2j + dj)) against the
plain version. The kernel itself is held against the plain version on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models import quantized_forward as jq
from plumekit_torch.models import quantized_forward as tq
from plumekit_torch.models.kernels import int8_conv, int8_upsample
from plumekit_torch.models.kernels.int8_conv import round_up
from plumekit_torch.models.kernels.int8_upsample import UpsampleShape
from torch_int8_emulation import run_q2, swz

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

def _unpack(packed):
    """(Np, Kp) int8: the packed weights with each row's swizzle undone,
    column n of the slices in order."""
    wt = packed.wt
    slices, n_k, passes, nb, kb = wt.shape
    rows = passes * nb
    pos = swz(np.arange(rows * kb), kb)
    tiles = wt.reshape(slices, n_k, rows * kb).numpy()[:, :, pos]
    return torch.from_numpy(tiles.reshape(slices, n_k, rows, kb)
                            .transpose(0, 2, 1, 3)
                            .reshape(slices * rows, n_k * kb))


@pytest.mark.parametrize("cin,cout", [(512, 256), (64, 32), (20, 12),
                                      (40, 100)])
def test_weight_packing_round_trips(cin, cout):
    rng = np.random.default_rng(cin + cout)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, cin, cout),
                                       dtype=np.int8))
    cb, n_cc, np_ = int8_upsample.packed_columns(cout)
    kb = int8_upsample.chunk_width(cin)
    cols = int8_upsample.packed_column_index(cout)
    for shape in int8_upsample.upsample_candidates(cin, cout):
        packed = int8_upsample.pack_upsample_weights(kq, shape)
        per = np_ // shape.slices
        assert packed.shape == (shape.slices, round_up(cin, kb) // kb,
                                per // shape.nb, shape.nb, kb)
        # the layout: columns a pass and slices (the rows an item are the
        # launch's)
        layout = int8_upsample.packed_shape(packed)
        assert (layout.nb, layout.slices) == (shape.nb, shape.slices)
        flat = _unpack(int8_upsample.PackedUpsample(packed, None, None, cin,
                                                    cout))
        assert torch.equal(flat[cols, :cin].t(),
                           int8_upsample.upsample_columns(kq))
        assert packed.abs().sum() == kq.abs().sum()
        # product column (2 di + dj)·cout + o is packed at di·n_cc·cb +
        # dj·cout + o: kq[di, dj, c, o]
        di, dj, c, o = 1, 0, cin - 1, cout - 1
        n = di * n_cc * cb + dj * cout + o
        assert flat[n, c] == kq[di, dj, c, o]


def test_packed_weights_are_cached_and_refreshed():
    rng = np.random.default_rng(1)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, 64, 32),
                                       dtype=np.int8))
    sw, bias = torch.ones(32), torch.arange(32.0)
    first = int8_upsample.pack_upsample(kq, sw, bias)
    assert int8_upsample.pack_upsample(kq, sw, bias) is first
    assert first.a.shape == first.b.shape == (first.np_,)
    assert torch.equal(first.b[int8_upsample.packed_column_index(32)],
                       bias.repeat(4))
    kq[0, 0, 0, 0] = 5 if kq[0, 0, 0, 0] != 5 else 6     # in place
    second = int8_upsample.pack_upsample(kq, sw, bias)
    assert second is not first and _unpack(second)[0, 0] == kq[0, 0, 0, 0]
    assert int8_upsample.pack_upsample(kq, sw.clone(), bias) is not second
    with pytest.raises(ValueError, match="do not fit"):
        int8_upsample.pack_upsample(kq, torch.ones(31), bias)
    with pytest.raises(ValueError, match="no shape"):
        int8_upsample.pack_upsample(kq, sw, bias, UpsampleShape(256, 1))


@pytest.mark.parametrize("cin,cout", [(512, 256), (256, 128), (128, 64),
                                      (64, 32), (32, 16), (20, 12),
                                      (40, 100), (48, 5)])
def test_upsample_shape_rule(cin, cout):
    shape = int8_upsample.upsample_shape(cin, cout)
    assert shape in int8_upsample.upsample_candidates(cin, cout)
    cb, _, np_ = int8_upsample.packed_columns(cout)
    kp = round_up(cin, int8_upsample.chunk_width(cin))
    assert shape.nb == (64 if np_ <= 128 else 128) and shape.nb % cb == 0
    # the launch on the rule's packing takes the rule's item
    packed = int8_upsample.PackedUpsample(
        torch.zeros((shape.slices, 1, 1, shape.nb, 32), dtype=torch.int8),
        None, None, cin, cout)
    assert packed.shape == shape
    assert np_ // shape.slices * kp <= int8_upsample.MAX_SLICE_BYTES
    assert shape.mt * shape.nb <= 256 and shape.mt in \
        int8_upsample.MT_OF[shape.nb]


def test_upsample_shapes_of_the_network():
    """Passes of 128 columns over one m64 tile (three consumers), of 64
    over two at Cout 32 and 128 over two at Cin 512 (two consumers);
    slices of at most 64 KB of weights: Cin 512 eight, Cin 256 two."""
    got = {(cin, cout): int8_upsample.upsample_shape(cin, cout)
           for cin, cout in [(512, 256), (256, 128), (128, 64), (64, 32)]}
    assert got == {(512, 256): UpsampleShape(128, 8, 2),
                   (256, 128): UpsampleShape(128, 2, 1),
                   (128, 64): UpsampleShape(128, 1, 1),
                   (64, 32): UpsampleShape(64, 1, 2)}
    assert [s.consumers for s in got.values()] == [2, 3, 3, 3]


@pytest.mark.parametrize("w,rows,rm", [(18, 2304, 64), (36, 4608, 64),
                                       (72, 9216, 64), (144, 18432, 128),
                                       (16, 2048, 64), (192, 2, 128),
                                       (256, 2, 128), (5, 3, 64)])
def test_item_blocks_fill_the_rows(w, rows, rm):
    n, k = int8_upsample.item_block(w, rows, rm)
    assert n in int8_upsample.ITEM_WIDTHS and n <= w and 16 % n == 0
    assert k == min(rm // n, rows) and n * k <= rm
    least = min(-(-w // m) * -(-rows // min(rm // m, rows))
                for m in int8_upsample.ITEM_WIDTHS if m <= w)
    assert -(-w // n) * -(-rows // k) <= int8_upsample.ITEM_SLACK * least


def test_item_blocks_of_the_network_waste_no_rows():
    """At the widths of the four upsamples (18, 36, 72 and 144 at 288²),
    an item is a whole number of rows of n pixels, n dividing the width."""
    for w, rm in [(18, 64), (36, 64), (72, 64), (144, 128)]:
        n, k = int8_upsample.item_block(w, 128 * w, rm)
        assert w % n == 0 and n * k == rm


def test_a_weight_packed_for_q1_is_refused():
    rng = np.random.default_rng(4)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 32),
                                       dtype=np.int8))
    q1 = int8_conv.pack_conv(wq, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="no weight packed for Q2"):
        int8_upsample.packed_shape(q1.wt)
    with pytest.raises(ValueError, match="no weight packed for Q2"):
        int8_upsample._int8_upsample2x2_cuda(
            torch.zeros((1, 2, 2, 64), dtype=torch.int8), q1.wt, q1.a, q1.b,
            torch.tensor(1.0), 32)


def test_the_op_keeps_its_schema():
    """Exported programs name the op by this schema."""
    assert str(int8_upsample.int8_upsample2x2_op._opoverload._schema) == (
        "plumekit::int8_upsample2x2(Tensor xq, Tensor w, Tensor a, "
        "Tensor b, Tensor out_scale, SymInt cout) -> Tensor")


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

def emulate_q2(x, packed, scale, blocks=2):
    bsz, h, w, _ = x.shape
    shape = packed.shape
    n, k = int8_upsample.item_block(w, bsz * h, shape.rows)
    return run_q2(x, packed.wt.numpy(), packed.a.numpy(), packed.b.numpy(),
                  scale, packed.cout, shape.nb, shape.mt, shape.slices, n, k,
                  blocks)


@pytest.mark.parametrize("shape,cout,kernel_shape", [
    ((1, 9, 9, 64), 32, UpsampleShape(64, 2)),     # two slices, ragged items
    ((2, 5, 7, 64), 64, UpsampleShape(128, 1, 2)),  # two passes, 128 rows
    ((2, 5, 7, 64), 32, UpsampleShape(128, 1, 1)),  # three consumers
    ((1, 6, 6, 128), 64, UpsampleShape(256, 1)),   # one wide pass
    ((1, 8, 9, 40), 24, UpsampleShape(64, 2)),     # Cin, Cout off the chunks
    ((3, 3, 5, 20), 12, UpsampleShape(64, 1)),     # quadrants off the 16s
    ((1, 3, 128, 32), 16, None),                   # the tuner's row widths
    ((1, 2, 192, 32), 16, None),
    ((1, 2, 256, 64), 32, None)])
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
