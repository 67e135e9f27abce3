"""plumekit_torch's int8 conv Q1 (``models/kernels/int8_conv.py``): its
plain version against the JAX package's int8 conv (``_qconv``, an XLA s8
convolution) and int8 block (``_qblock``) on the same numpy inputs, the
weight packing, the shape and tile rule, and a plain emulation of the CUDA
kernel's index scheme (tests/torch_int8_emulation.py: the padded-raster
rows of the staged patch, the folded taps of the input conv, the s8 wgmma
descriptor addresses, the m64nNk32 accumulator fragments, the stash and
the 16-byte stores) against the plain version. The kernel itself is held against the plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models import quantized_forward as jq
from plumekit_torch.models import quantized_forward as tq
from plumekit_torch.models.kernels import int8_conv
from plumekit_torch.models.kernels.int8_conv import KC, Shape, round_up
from torch_int8_emulation import Block, run_grid

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


# ---------------------------------------- the kernel's quotient, emulated

def _round32(x):
    """The float32 nearest the exact rational ``x``, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = int(np.array(c, np.float32).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return np.float32(best[1])


def _fma32(a, b, c):
    return _round32(Fraction(float(a)) * Fraction(float(b))
                    + Fraction(float(c)))


def _kernel_quotient(y, s):
    """csrc/int8_wgmma.cuh's Quantizer (Q1's and Q2's requant) before its
    rounding to an integer: y clamped to ±128·s, r = RN(1/s), q0 =
    RN(y·r), two corrections by the exact residual."""
    hi = np.float32(128) * s
    y = min(max(y, -hi), hi)
    r = _round32(1 / Fraction(float(s)))
    q0 = _round32(Fraction(float(y)) * Fraction(float(r)))
    q = _fma32(_fma32(-s, q0, y), r, q0)
    return _fma32(_fma32(-s, q, y), r, q)


def test_kernel_quotient_is_the_ieee_quotient():
    """The kernel divides by the output scale through its reciprocal and
    two FMA corrections (Markstein); the plain version divides. Held here
    in exact arithmetic against float32 division, on the epilogue's values
    and on values one ulp around every rounding boundary k + 1/2 of the
    int8 range (within the ±128·s the kernel clamps y to first), at
    scales of the forward's sizes."""
    rng = np.random.default_rng(12)
    for s in np.float32([16.0 / 127, 12.0 / 127, 0.0371, 3.1e-3, 1.7,
                         rng.uniform(1e-4, 1.0)]):
        ys = list(rng.normal(0, 8 * s, 150).astype(np.float32))
        for k in rng.integers(-128, 128, 60):
            mid = np.float32((k + 0.5) * s)
            ys += [np.nextafter(mid, np.float32(-np.inf)), mid,
                   np.nextafter(mid, np.float32(np.inf))]
        for y in ys:
            assert _kernel_quotient(np.float32(y), s) == np.float32(y) / s, \
                (y, s)


def test_kernel_rounding_is_clamp_of_rint():
    """The kernel clamps the quotient to ±127 and rounds it by adding
    1.5·2^23 (a float's ulp is 1 there, ties to even); the plain version
    rounds half to even, then clamps."""
    rng = np.random.default_rng(13)
    k = np.arange(-140, 141, dtype=np.float32)
    q = np.concatenate([k + 0.5, k - 0.5, k,
                        np.nextafter(k + 0.5, np.float32(np.inf)),
                        np.nextafter(k + 0.5, np.float32(-np.inf)),
                        rng.normal(0, 90, 5000).astype(np.float32),
                        np.float32([3e38, -3e38, np.inf, -np.inf, 1e-30])])
    c = (np.clip(q, -127, 127).astype(np.float32)
         + np.float32(12582912.0)).astype(np.float32)
    got = c.view(np.int32) - 0x4B400000
    np.testing.assert_array_equal(got, np.clip(np.rint(q), -127, 127))


# --------------------------------------------------------- packing, tiles

def _unpack(packed, c0, c1, cout, shape):
    """The HWIO weights back from Q1's layout at ``shape``."""
    n_pass, n_k, taps = packed.shape[:3]
    flat = packed.permute(0, 4, 2, 1, 3, 5).reshape(n_pass * shape.nb, taps,
                                                     n_k * KC)
    if shape.fold:
        return flat[:cout, 0, :9 * c0].reshape(cout, 9, c0) \
            .permute(1, 2, 0).reshape(3, 3, c0, cout)
    c0p = round_up(c0, KC)
    taps = torch.cat([flat[:cout, :, :c0], flat[:cout, :, c0p:c0p + c1]],
                     dim=-1)                                  # (cout, 9, cin)
    return taps.permute(1, 2, 0).reshape(3, 3, c0 + c1, cout)


@pytest.mark.parametrize("c0,c1,cout", [(2, 0, 32), (32, 0, 64),
                                        (64, 64, 64), (24, 40, 33),
                                        (512, 512, 256)])
def test_weight_packing_round_trips(c0, c1, cout):
    rng = np.random.default_rng(c0 + c1 + cout)
    w = torch.from_numpy(_int8(rng, (3, 3, c0 + c1, cout)))
    for shape in int8_conv.shape_candidates(c0, c1, cout):
        packed = int8_conv.pack_int8_weights(w, c0, shape)
        kp = KC if shape.fold else round_up(c0, KC) + round_up(c1, KC)
        assert packed.shape == (round_up(cout, shape.nb) // shape.nb,
                                kp // KC, shape.taps, 2, shape.nb, 16)
        assert packed.dtype == torch.int8 and packed.is_contiguous()
        assert torch.equal(_unpack(packed, c0, c1, cout, shape), w)
        # every padding is zero: the packed sum of |w| is the weights' own
        assert packed.abs().sum() == w.abs().sum()
    # (pass, chunk, tap, group, n, byte) of the unfolded layout is
    # w[tap // 3, tap % 3, 32·chunk + 16·group + byte, nb·pass + n]
    shape = Shape(32, 4)
    packed = int8_conv.pack_int8_weights(w, c0 + c1, shape)
    n, tap, k = cout - 1, 5, c0 + c1 - 1
    assert packed[n // 32, k // 32, tap, (k % 32) // 16, n % 32, k % 16] \
        == w[tap // 3, tap % 3, k, n]


def test_the_input_conv_folds_its_taps_into_one_k_row():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(_int8(rng, (3, 3, 2, 32)))
    packed = int8_conv.pack_int8_weights(w, 2, Shape(32, 4, True))
    assert packed.shape == (1, 1, 1, 2, 32, 16)
    row = packed[0, 0, 0].permute(1, 0, 2).reshape(32, 32)  # (n, byte k)
    for tap in range(9):
        for c in range(2):
            assert torch.equal(row[:, 2 * tap + c], w[tap // 3, tap % 3, c])
    assert not row[:, 18:].any()
    assert int8_conv.can_fold(3, 0) and not int8_conv.can_fold(4, 0)
    assert not int8_conv.can_fold(2, 2)
    with pytest.raises(ValueError, match="does not fold"):
        int8_conv.pack_int8_weights(torch.zeros((3, 3, 4, 8),
                                                dtype=torch.int8), 4,
                                    Shape(32, 4, True))


def test_packed_weights_are_cached_and_refreshed():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(_int8(rng, (3, 3, 32, 32)))
    a = torch.ones(32)
    b = torch.zeros(32)
    first = int8_conv.pack_conv(w, a, b)
    assert int8_conv.pack_conv(w, a, b) is first
    other = int8_conv.pack_conv(w, a, b, shape=Shape(32, 4))
    assert int8_conv.pack_conv(w, a, b, shape=Shape(32, 4)) is other
    w[0, 0, 0, 0] = 5 if w[0, 0, 0, 0] != 5 else 6      # in place
    second = int8_conv.pack_conv(w, a, b)
    assert second is not first and \
        second.wt[0, 0, 0, 0, 0, 0] == w[0, 0, 0, 0]
    third = int8_conv.pack_conv(w, a.clone(), b)           # another tensor
    assert third is not second
    with pytest.raises(ValueError, match="do not fit"):
        int8_conv.pack_conv(w, torch.ones(31), b)


def _unet_convs():
    """The convs of UNetConfig() at 288², then those of the deep-supervised
    UNet++ of other shapes (its dense concats)."""
    from plumekit_torch.config import UNetConfig
    from plumekit_torch.experiments.int8_conv_times import conv_cases

    cases = conv_cases(UNetConfig(), 288)
    for c in conv_cases(UNetConfig(arch="unetpp", deep_supervision=True),
                        288):
        if all(c[:4] != d[:4] for d in cases):
            cases.append(c)
    return cases


#: the UNet++'s dense concats that the U-Net has not: (c0, c1, cout), the
#: first source the concat of a node's j same-scale planes
UNETPP_TRIPLES = [(64, 32, 32), (96, 32, 32), (128, 32, 32), (128, 64, 64),
                  (192, 64, 64), (256, 128, 128)]


def test_unetpp_brings_six_new_conv_triples():
    from plumekit_torch.config import UNetConfig
    from plumekit_torch.experiments.int8_conv_times import conv_cases

    unet = {c[:3] for c in conv_cases(UNetConfig(), 288)}
    pp = {c[:3] for c in conv_cases(UNetConfig(arch="unetpp"), 288)}
    assert sorted(pp - unet) == UNETPP_TRIPLES


@pytest.mark.parametrize("case", _unet_convs(),
                         ids=lambda c: f"{c[0]}+{c[1]}-{c[2]}-{c[3]}")
def test_rule_shape_and_tile_fit_every_unet_conv(case):
    """Every conv of UNetConfig() and of the UNet++ at 288² tiles, 128 of
    them: the rule's shape is a candidate, and at every candidate the
    tile's rows fit the block, its shared memory the card, and the tiles
    cover the plane."""
    c_skip, cin, cout, side, int8_out = case
    c0, c1 = (c_skip, cin) if c_skip else (cin, 0)
    cands = int8_conv.shape_candidates(c0, c1, cout)
    assert int8_conv.conv_shape(c0, c1, cout) in cands
    for shape in cands:
        t = int8_conv.conv_tile(side, side, 128, shape)
        rows = (t.images * t.th * t.tw if shape.fold
                else int8_conv.raster_rows(t.th, t.tw, t.images))
        assert t.shape == shape and rows <= shape.rows
        assert int8_conv.smem_bytes(t, c0) <= int8_conv.SMEM_LIMIT
        assert t.th <= side and t.tw <= side and t.images <= 128


@pytest.mark.parametrize("side,shape,tile", [
    (288, Shape(32, 4), (10, 48, 1)), (288, Shape(32, 4, True), (16, 32, 1)),
    (144, Shape(64, 2), (5, 48, 1)), (72, Shape(128, 2), (12, 18, 1)),
    (36, Shape(128, 2), (12, 18, 1)), (18, Shape(128, 2), (9, 18, 1)),
    (18, Shape(256, 1), (6, 18, 1)), (9, Shape(32, 4), (9, 9, 4))])
def test_tile_rule(side, shape, tile):
    assert int8_conv.conv_tile(side, side, 128, shape) == \
        int8_conv.Q1Tile(shape, *tile)


def test_tile_rule_takes_the_fewest_blocks():
    """Against every tile that fits, at a ragged plane and a small one."""
    for h, w, shape in ((37, 29, Shape(64, 2)), (12, 10, Shape(32, 4)),
                        (30, 31, Shape(32, 4, True))):
        t = int8_conv.conv_tile(h, w, 3, shape)
        blocks = -(-3 // t.images) * -(-h // t.th) * -(-w // t.tw)
        for th in range(1, h + 1):
            for tw in range(1, w + 1):
                rows = th * tw if shape.fold else \
                    int8_conv.raster_rows(th, tw, 1)
                if rows <= shape.rows:
                    assert blocks <= 3 * -(-h // th) * -(-w // tw)


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
    with pytest.raises(ValueError, match="no kernel"):
        int8_conv.int8_conv3x3_packed(x, int8_conv.pack_conv(w, a, b))


# ------------------------------------- the kernel's index scheme, emulated

def emulate_q1(x0, x1, packed, tile, out_scale):
    """Q1's output by the kernel's own index scheme
    (tests/torch_int8_emulation.py), with the C entry's arguments."""
    bsz, h, w, _ = x0.shape
    blk = Block(x0=x0, x1=x1, wt=packed.wt.numpy(), a=packed.a.numpy(),
                b=packed.b.numpy(), scale=out_scale, B=bsz, H=h, W=w,
                c0=packed.c0, c0p=packed.c0p, c1=packed.c1,
                n_k=packed.kp // KC, cout=packed.cout,
                n_pass=packed.np_ // tile.shape.nb, nb=tile.shape.nb,
                mt=tile.shape.mt, th=tile.th, tw=tile.tw, g=tile.images,
                pitch=int8_conv.a_pitch(tile))
    mode = "fold" if tile.shape.fold else "raster"
    return run_grid(blk, mode, (bsz, h, w, packed.cout),
                    np.int8 if out_scale is not None else np.float32)


@pytest.mark.parametrize("shape,c_skip,cout,kernel_shape,tile", [
    ((1, 16, 16, 64), 0, 32, Shape(32, 4), None),     # two k chunks
    ((1, 10, 13, 2), 0, 40, Shape(32, 4, True), None),  # the fold, 2 passes
    ((1, 10, 13, 2), 0, 40, Shape(64, 2), None),      # Cin 2 unfolded
    ((2, 8, 8, 16), 24, 16, Shape(32, 4), None),      # two sources, padded
    ((3, 6, 5, 48), 0, 72, Shape(64, 2), None),       # images per block
    ((1, 12, 11, 32), 32, 128, Shape(128, 2), (5, 6, 1)),  # ragged tiles
    ((1, 7, 9, 40), 0, 24, Shape(256, 1), None),      # one pass, wide
    ((2, 9, 7, 3), 0, 8, Shape(32, 4, True), (4, 5, 1))])  # Cin 3, fold
def test_kernel_index_scheme_matches_plain_version(shape, c_skip, cout,
                                                   kernel_shape, tile):
    _check_index_scheme(shape, c_skip, cout, kernel_shape, tile)


@pytest.mark.parametrize("c0,c1,cout", UNETPP_TRIPLES)
def test_kernel_index_scheme_at_the_unetpp_concats(c0, c1, cout):
    """The six (c0, c1, cout) of the UNet++'s dense concats at the rule's
    shape, on a small plane: several k chunks of the first source, the
    second's after its padding, resident or streamed weights alike."""
    _check_index_scheme((1, 9, 8, c1), c0, cout,
                        int8_conv.conv_shape(c0, c1, cout), None)


def _check_index_scheme(shape, c_skip, cout, kernel_shape, tile):
    rng = np.random.default_rng(sum(shape) + cout)
    x = _int8(rng, shape)
    skip = _int8(rng, shape[:3] + (c_skip,)) if c_skip else None
    w = torch.from_numpy(_int8(rng, (3, 3, shape[3] + c_skip, cout)))
    a, b = (torch.from_numpy(v) for v in
            _epilogue_args(rng, shape[3] + c_skip, cout))
    packed = int8_conv.pack_conv(w, a, b, c_skip or None, kernel_shape)
    t = (int8_conv.conv_tile(shape[1], shape[2], shape[0], kernel_shape)
         if tile is None else int8_conv.Q1Tile(kernel_shape, *tile))
    x0, x1 = (x, None) if skip is None else (skip, x)
    args = (torch.from_numpy(x), w, a, b)
    sk = None if skip is None else torch.from_numpy(skip)
    for scale in (np.float32(16.0 / 127), None):
        got, written = emulate_q1(x0, x1, packed, t, scale)
        want = int8_conv.int8_conv3x3_ref(
            *args, None if scale is None else torch.tensor(scale), sk)
        assert (written == 1).all()             # every output once
        np.testing.assert_array_equal(got, want.numpy())
