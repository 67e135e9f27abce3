"""plumekit_torch's int8 conv Q1 (``models/kernels/int8_conv.py``): its
plain version against the JAX package's int8 conv (``_qconv``, an XLA s8
convolution) and int8 block (``_qblock``) on the same numpy inputs, the
weight packing, the tile rule, and a plain emulation of the CUDA kernel's
index scheme (the staged chunks, the ldmatrix row providers, the
m16n8k32 s8 fragment order and the epilogue's pixel and channel map)
against the plain version. The kernel itself is held against the plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models import quantized_forward as jq
from plumekit_torch.models import quantized_forward as tq
from plumekit_torch.models.kernels import int8_conv
from plumekit_torch.models.kernels.int8_conv import KC, round_up

# fp32 epilogue outputs: the same two roundings on both sides, but XLA's
# CPU may contract acc·a + b into one FMA, which moves a result by an ulp
F32_RTOL = 1e-6
# int8 outputs: an ulp of the fp32 value can move a quotient across a
# rounding boundary, so one step, on a tiny share of the values
INT8_MAX_STEP, INT8_MAX_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8(rng, shape, low=-127):
    return rng.integers(low, 128, shape, dtype=np.int8)


def _epilogue_args(rng, k, cout):
    a = (rng.uniform(0.5, 1.5, cout) * 4.0 / (64 * 73 * (9 * k) ** 0.5)) \
        .astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    return a, b


# ------------------------------------------------ the plain version vs JAX

@pytest.mark.parametrize("cin,cout", [(2, 32), (32, 32), (64, 128),
                                      (256, 64)])
def test_accumulators_equal_jax_qconv(cin, cout):
    rng = np.random.default_rng(cin)
    x = _int8(rng, (2, 11, 9, cin))
    w = _int8(rng, (3, 3, cin, cout))
    want = np.asarray(jq._qconv(jnp.asarray(x), jnp.asarray(w)))
    got = int8_conv.int8_conv3x3_acc_ref(torch.from_numpy(x),
                                         torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c_skip,cin,cout", [(32, 32, 32), (16, 8, 24)])
def test_two_source_accumulators_equal_jax_qconv_of_the_concat(c_skip, cin,
                                                                cout):
    rng = np.random.default_rng(c_skip + cin)
    skip = _int8(rng, (2, 10, 12, c_skip), 0)
    x = _int8(rng, (2, 10, 12, cin), 0)
    w = _int8(rng, (3, 3, c_skip + cin, cout))
    want = np.asarray(jq._qconv(jnp.concatenate([skip, x], -1),
                                jnp.asarray(w)))
    got = int8_conv.int8_conv3x3_acc_ref(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         skip=torch.from_numpy(skip))
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_int8_close(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= INT8_MAX_STEP and (d > 0).mean() <= INT8_MAX_SHARE, \
        (d.max(), (d > 0).mean())


@pytest.mark.parametrize("cin,cout", [(2, 32), (64, 64), (256, 32)])
def test_epilogue_matches_jax_in_both_output_modes(cin, cout):
    rng = np.random.default_rng(7 + cin)
    x = _int8(rng, (2, 12, 12, cin), -127 if cin == 2 else 0)
    w = _int8(rng, (3, 3, cin, cout))
    a, b = _epilogue_args(rng, cin, cout)
    acc = jq._qconv(jnp.asarray(x), jnp.asarray(w)).astype(jnp.float32)
    y = jnp.maximum(acc * a + b, 0.0)
    s = np.float32(16.0 / 127)
    args = [torch.from_numpy(v) for v in (x, w, a, b)]
    got32 = int8_conv.int8_conv3x3_ref(*args)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(y), rtol=F32_RTOL,
                               atol=0)
    got8 = int8_conv.int8_conv3x3_ref(*args, out_scale=torch.tensor(s))
    assert got8.dtype == torch.int8
    _assert_int8_close(got8.numpy(), np.asarray(jq._quant_act(y, s)))


def _block(rng, cin, cmid, cout, last):
    a1, b1 = _epilogue_args(rng, cin, cmid)
    a2, b2 = _epilogue_args(rng, cmid, cout)
    return {"wq1": _int8(rng, (3, 3, cin, cmid)), "a1": a1, "b1": b1,
            "s_mid": np.float32(16.0 / 127),
            "wq2": _int8(rng, (3, 3, cmid, cout)), "a2": a2, "b2": b2,
            "s_out": None if last else np.float32(12.0 / 127)}


@pytest.mark.parametrize("cin,cmid,last", [(2, 32, False), (64, 32, True)])
def test_block_matches_jax_qblock(cin, cmid, last):
    """The port's block (two Q1 calls, the block output requantized in the
    second conv's epilogue) against the JAX block and its requant."""
    rng = np.random.default_rng(cin + cmid)
    blk = _block(rng, cin, cmid, cmid, last)
    x = _int8(rng, (2, 16, 16, cin), -127 if cin == 2 else 0)
    y = jq._qblock(jnp.asarray(x), {k: None if v is None else jnp.asarray(v)
                                    for k, v in blk.items()})
    got = tq._qblock(torch.from_numpy(x),
                     {k: None if v is None else torch.as_tensor(v)
                      for k, v in blk.items()})
    if last:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(y).max()))
    else:
        _assert_int8_close(got.numpy(),
                           np.asarray(jq._quant_act(y, blk["s_out"])))


def test_block_with_skip_reads_the_concat():
    rng = np.random.default_rng(11)
    blk = {k: None if v is None else torch.as_tensor(v)
           for k, v in _block(rng, 64, 32, 32, False).items()}
    skip, x = (torch.from_numpy(_int8(rng, (1, 8, 8, 32), 0))
               for _ in range(2))
    assert torch.equal(tq._qblock(x, blk, skip=skip),
                       tq._qblock(torch.cat([skip, x], -1), blk))


def test_quant_act_rounds_half_to_even_and_clamps_to_127():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0, 126.5])
    got = int8_conv.quant_act(x, torch.tensor(1.0))
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127, 126]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq._quant_act(jnp.asarray(x.numpy()), 1.0)))


@pytest.mark.parametrize("m,k,n", [(3, 2, 5), (17, 8, 8), (40, 13, 30)])
def test_int_mm_pads_and_cuts_exactly(m, k, n):
    rng = np.random.default_rng(m)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    got = int8_conv.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# --------------------------------------------------------- packing, tiles

def _unpack(packed, c0, c1, cout):
    """The HWIO weights back from Q1's (Np, 9, Kp) layout."""
    c0p = round_up(c0, KC)
    taps = torch.cat([packed[:cout, :, :c0], packed[:cout, :, c0p:c0p + c1]],
                     dim=-1)                                  # (cout, 9, cin)
    return taps.permute(1, 2, 0).reshape(3, 3, c0 + c1, cout)


@pytest.mark.parametrize("c0,c1,cout", [(2, 0, 32), (32, 0, 64),
                                        (64, 64, 64), (24, 40, 33),
                                        (512, 512, 256)])
def test_weight_packing_round_trips(c0, c1, cout):
    rng = np.random.default_rng(c0 + c1 + cout)
    w = torch.from_numpy(_int8(rng, (3, 3, c0 + c1, cout)))
    packed = int8_conv.pack_int8_weights(w, c0)
    kp = round_up(c0, KC) + round_up(c1, KC)
    assert packed.shape == (round_up(cout, KC), 9, kp)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert torch.equal(_unpack(packed, c0, c1, cout), w)
    # every padding is zero: the packed sum of |w| is the weights' own
    assert packed.abs().sum() == w.abs().sum()
    # (n, tap, k) of the packed tensor is w[tap // 3, tap % 3, k, n]
    n, tap, k = cout - 1, 5, c0 - 1
    assert packed[n, tap, k] == w[tap // 3, tap % 3, k, n]


def test_packed_weights_are_cached_and_refreshed():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(_int8(rng, (3, 3, 32, 32)))
    a = torch.ones(32)
    b = torch.zeros(32)
    first = int8_conv.pack_conv(w, a, b)
    assert int8_conv.pack_conv(w, a, b) is first
    w[0, 0, 0, 0] = 5 if w[0, 0, 0, 0] != 5 else 6      # in place
    second = int8_conv.pack_conv(w, a, b)
    assert second is not first and second.wt[0, 0, 0] == w[0, 0, 0, 0]
    third = int8_conv.pack_conv(w, a.clone(), b)           # another tensor
    assert third is not second
    with pytest.raises(ValueError, match="do not fit"):
        int8_conv.pack_conv(w, torch.ones(31), b)


@pytest.mark.parametrize("side,tile", [(288, 16), (144, 16), (72, 16),
                                       (36, 16), (18, 8), (96, 16), (12, 16),
                                       (9, 16)])
def test_tile_rule(side, tile):
    assert int8_conv.conv_tile(side, side) == tile


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_int8(rng, (1, 6, 6, 32)))
    w = torch.from_numpy(_int8(rng, (3, 3, 32, 32)))
    a, b = (torch.from_numpy(v) for v in _epilogue_args(rng, 32, 32))
    before = int8_conv.LAUNCHES
    assert torch.equal(int8_conv.int8_conv3x3(x, w, a, b),
                       int8_conv.int8_conv3x3_ref(x, w, a, b))
    assert int8_conv.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        int8_conv.int8_conv3x3(x.to("meta"), w, a, b)


# ------------------------------------- the kernel's index scheme, emulated

KS = KC + 16        # bytes per staged row (csrc/int8_conv.cu: kKS)
N_CHUNK = 32        # output channels per block (kNC)
LANES = np.arange(32)


def _stage_x(x0, x1, c0, b, y0, x0_, k0, xw):
    """load_x: padded channels [k0, k0 + 32) of the xw × xw patch at (y0,
    x0_) into a flat byte buffer of xw² rows of KS bytes."""
    c0p = round_up(c0, KC)
    plane, kb = (x0, k0) if k0 < c0p else (x1, k0 - c0p)
    h, w, c = plane.shape[1:]
    buf = np.zeros((xw * xw, KS), np.uint8)
    for pix in range(xw * xw):
        gy, gx = y0 + pix // xw, x0_ + pix % xw
        if 0 <= gy < h and 0 <= gx < w:
            vals = plane[b, gy, gx, kb:min(kb + KC, c)].view(np.uint8)
            buf[pix, :len(vals)] = vals
    return buf.reshape(-1)


def _stage_w(wt, n0, k0):
    """load_w: rows n·9 + tap of output channels [n0, n0 + 32), bytes
    [k0, k0 + 32)."""
    buf = np.zeros((N_CHUNK * 9, KS), np.uint8)
    buf[:, :KC] = wt[n0:n0 + N_CHUNK, :, k0:k0 + KC].reshape(
        N_CHUNK * 9, KC).view(np.uint8)
    return buf.reshape(-1)


def _ldmatrix_x4(buf, addr):
    """ldmatrix.x4.b16: matrix j's rows come from lanes 8j..8j+7; lane L
    receives bytes 4·(L & 3) .. +3 of row L >> 2 of each matrix. Returns
    (4 registers, 32 lanes, 4 bytes)."""
    regs = np.empty((4, 32, 4), np.int8)
    for j in range(4):
        rows = addr[8 * j + (LANES >> 2)]
        idx = rows[:, None] + 4 * (LANES & 3)[:, None] + np.arange(4)
        regs[j] = buf[idx].view(np.int8)
    return regs


def _mma_m16n8k32(acc, a, b0, b1):
    """mma.sync m16n8k32 s8: A row (L >> 2) + 8·(j & 1), columns 4·(L & 3)
    + 16·(j >> 1); B column L >> 2, rows 4·(L & 3) (+16 for b1); C rows
    L >> 2 (e0, e1) and + 8 (e2, e3), columns 2·(L & 3) + (e & 1)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for j in range(4):
        rows = (LANES >> 2) + 8 * (j & 1)
        cols = 4 * (LANES & 3) + 16 * (j >> 1)
        for e in range(4):
            A[rows, cols + e] = a[j, :, e]
    for reg, off in ((b0, 0), (b1, 16)):
        for e in range(4):
            B[4 * (LANES & 3) + off + e, LANES >> 2] = reg[:, e]
    C = A @ B
    for e in range(4):
        acc[:, e] += C[(LANES >> 2) + 8 * (e >> 1), 2 * (LANES & 3) + (e & 1)]


def emulate_q1(x0, x1, packed, tile):
    """The accumulators Q1 computes, by its own index scheme: one block
    per (image, tile, 32-channel chunk), 8 warps (4 along the pixels, 2
    along the channels), the k loop over staged chunks, nine taps each."""
    c0, cout = packed.c0, packed.cout
    wt = packed.wt.numpy()
    n_p, _, kp = wt.shape
    bsz, h, w, _ = x0.shape
    xw, mt = tile + 2, tile * tile // 16
    mi = mt // 4
    out = np.zeros((bsz, h, w, cout), np.int64)
    for b in range(bsz):
        for ty0 in range(0, h, tile):
            for tx0 in range(0, w, tile):
                for n0 in range(0, n_p, N_CHUNK):
                    acc = np.zeros((8, mi, 2, 32, 4), np.int64)
                    for k0 in range(0, kp, KC):
                        xs = _stage_x(x0, x1, c0, b, ty0 - 1, tx0 - 1, k0, xw)
                        ws = _stage_w(wt, n0, k0)
                        for warp in range(8):
                            wm, wn = warp % 4, warp // 4
                            a_row = (LANES & 7) + (((LANES >> 3) & 1) << 3)
                            a_k = (LANES >> 4) << 4
                            b_n = wn * 16 + (LANES & 7) + ((LANES >> 4) << 3)
                            b_k = ((LANES >> 3) & 1) << 4
                            b_off = b_n * 9 * KS + b_k
                            for tap in range(9):
                                a_tap = ((tap // 3) * xw + tap % 3) * KS
                                bf = _ldmatrix_x4(ws, b_off + tap * KS)
                                for i in range(mi):
                                    q = (wm + 4 * i) * 16 + a_row
                                    r = q // tile
                                    a_off = (r * xw + q - r * tile) * KS + a_k
                                    af = _ldmatrix_x4(xs, a_off + a_tap)
                                    _mma_m16n8k32(acc[warp, i, 0], af,
                                                  bf[0], bf[1])
                                    _mma_m16n8k32(acc[warp, i, 1], af,
                                                  bf[2], bf[3])
                    # the epilogue's map of the C fragments
                    g, q4 = LANES >> 2, LANES & 3
                    for warp in range(8):
                        wm, wn = warp % 4, warp // 4
                        for i in range(mi):
                            for hh in range(2):
                                q = (wm + 4 * i) * 16 + g + 8 * hh
                                gy, gx = ty0 + q // tile, tx0 + q % tile
                                for j in range(2):
                                    n = n0 + (wn * 2 + j) * 8 + 2 * q4
                                    for e in range(2):
                                        keep = (gy < h) & (gx < w) & \
                                            (n + e < cout)
                                        out[b, gy[keep], gx[keep],
                                            (n + e)[keep]] = \
                                            acc[warp, i, j, keep, 2 * hh + e]
    return out


@pytest.mark.parametrize("shape,c_skip,cout,tile", [
    ((1, 16, 16, 64), 0, 32, 16),     # one tile, two k chunks
    ((1, 10, 13, 2), 0, 40, 8),       # the input conv, ragged, 2 n chunks
    ((2, 8, 8, 16), 24, 16, 8)])      # two sources, padded in each
def test_kernel_index_scheme_matches_plain_version(shape, c_skip, cout, tile):
    rng = np.random.default_rng(sum(shape) + cout)
    x = _int8(rng, shape)
    skip = _int8(rng, shape[:3] + (c_skip,)) if c_skip else None
    w = torch.from_numpy(_int8(rng, (3, 3, shape[3] + c_skip, cout)))
    a, b = (torch.from_numpy(v) for v in _epilogue_args(rng, 9, cout))
    packed = int8_conv.pack_conv(w, a, b, c_skip or None)
    x0, x1 = (x, None) if skip is None else (skip, x)
    got = emulate_q1(x0, x1, packed, tile)
    want = int8_conv.int8_conv3x3_acc_ref(
        torch.from_numpy(x), w,
        None if skip is None else torch.from_numpy(skip))
    np.testing.assert_array_equal(got, want.numpy())
