"""The host side of plumekit_torch's conv tile code (K5, K6 and K7 share it):
the tile rule, the weight packing, and a plain PyTorch emulation of the
wgmma path's index scheme (rows over the padded raster of the staged patch
of several images, wrapped rows dropped, the ring outside the image zeroed)
against the plain versions and against the JAX package's Pallas kernels run
in interpret mode. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_kernels_cuda.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.models.pallas.fused_conv import (
    fused_conv3x3_bn_relu as jax_single_conv,
    fused_double_conv3x3_bn_relu as jax_double_conv,
)
from plumekit_torch.config import UNetConfig
from plumekit_torch.models import build_model
from plumekit_torch.models import fused_forward
from plumekit_torch.models.kernels import conv_tiles, fused_conv, unet_mega
from plumekit_torch.models.kernels.conv_tiles import WgGeom, round_up

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import double_conv_case  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = BF16_RTOL = 2.0 ** -6


def block_shapes(cfg, tile):
    """(Cin, Cmid, Cout, H, pools) of the 2·depth + 1 double-conv blocks."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    enc = [((cfg.in_channels if i == 0 else f[i - 1]), f[i], f[i], tile >> i,
            True) for i in range(cfg.depth)]
    mid = [(f[cfg.depth - 1], f[cfg.depth], f[cfg.depth], tile >> cfg.depth,
            False)]
    dec = [(f[i + 1], f[i], f[i], tile >> i, False)
           for i in reversed(range(cfg.depth))]
    return enc + mid + dec


# ------------------------------------------------------------ the tile rule

def check_double_tile(h, w, cin, cmid, cout, even=False, head=False):
    t = conv_tiles.double_conv_tile(h, w, cin, cmid, cout, even, head)
    side = conv_tiles.fixed_tile_side(cmid)
    assert t.path == ("wgmma" if cmid > 64 else "mma")
    assert 0 < t.smem <= 232_448
    assert t.th >= 1 and t.tw >= 1 and t.images >= 1
    # covers the plane: ceil(h / th) x ceil(w / tw) tiles, by construction of
    # the launch; several images only where one tile is the whole plane
    assert t.images == 1 or (t.th, t.tw) == (h, w)
    assert t.fill == pytest.approx(
        h * w / (round_up(h, t.th) * round_up(w, t.tw)))
    # no worse than the fixed 16 x 16 / 8 x 8 tiles this rule replaced
    assert t.fill >= conv_tiles.plane_fill(h, w, side, side) - 1e-12
    if t.path == "wgmma":
        gm = WgGeom(t.th, t.tw, t.images, 1, round_up(cmid, 128))
        assert gm.fits(head) and gm.smem_bytes(head) == t.smem
        assert max(gm.m1, gm.m2) <= 256
        assert not even or (t.th % 2 == 0 and t.tw % 2 == 0)
    else:
        assert (t.th, t.tw, t.images) == (16, 16, 1)
    return t


@pytest.mark.parametrize("tile", [96, 128, 288])
@pytest.mark.parametrize("block", range(9))
def test_double_conv_tile_of_every_unet_block(tile, block):
    cin, cmid, cout, h, pools = block_shapes(UNetConfig(), tile)[block]
    t = check_double_tile(h, h, cin, cmid, cout)
    # the same block as a stage of the whole-forward kernel
    check_double_tile(h, h, cin, cmid, cout, even=pools, head=block == 8)
    if cmid > 64:
        # a tile that fits the plane exactly where one exists
        assert t.fill == 1.0


@pytest.mark.parametrize("tile", [96, 128, 288])
@pytest.mark.parametrize("conv", range(18))
def test_single_conv_tile_of_every_unet_conv(tile, conv):
    cin, cmid, cout, h, _ = block_shapes(UNetConfig(), tile)[conv // 2]
    ci, co = ((cin, cmid), (cmid, cout))[conv % 2]
    t = conv_tiles.single_conv_tile(h, h, ci, co)
    assert t.path == ("wgmma" if co > 64 else "mma")
    assert 0 < t.smem <= 232_448
    assert t.images == 1 or (t.th, t.tw) == (h, h)
    assert t.fill >= conv_tiles.plane_fill(h, h, 16, 16) - 1e-12
    if t.path == "wgmma":
        gm = WgGeom(t.th, t.tw, t.images, 0)
        assert gm.fits() and gm.smem_bytes() == t.smem and gm.m1 <= 256


@pytest.mark.parametrize("cin,cmid,cout", [(2, 32, 32), (5, 128, 37),
                                           (64, 256, 256), (512, 512, 130),
                                           (256, 1024, 64)])
@pytest.mark.parametrize("w", [1, 5, 18, 21, 29, 100])
def test_tile_rule_over_ragged_planes(cin, cmid, cout, w):
    for h in (1, 3, 6, 17, 18, 29, 37, 64, 143):
        for even in (False, True):
            if even and (h % 2 or w % 2):
                continue
            check_double_tile(h, w, cin, cmid, cout, even)
        t = conv_tiles.single_conv_tile(h, w, cin, cmid)
        assert t.smem <= 232_448
        assert t.fill >= conv_tiles.plane_fill(h, w, 16, 16) - 1e-12
        if t.path == "wgmma":
            assert WgGeom(t.th, t.tw, t.images, 0).fits()


def test_small_planes_share_a_block_between_images():
    assert conv_tiles.double_conv_tile(6, 6, 256, 512, 512).images == 2
    assert conv_tiles.single_conv_tile(6, 6, 512, 512).images == 4
    assert conv_tiles.double_conv_tile(18, 18, 256, 512, 512).images == 1


# ---------------------------------------------------------------- packing

def unpack_stream(stream, taps, cin, cout):
    """numpy inverse of the documented layout: stream[p, c, t, g, n, e] =
    w[t, 32 c + 8 g + e, 128 p + n]; returns (taps, Cin_p, Cout_p)."""
    s = stream.view(torch.int16).numpy()
    n_pass, chunks, t, groups, n, e = s.shape
    assert (t, groups, n, e) == (taps, 4, 128, 8)
    w = np.zeros((taps, chunks * 32, n_pass * 128), np.int16)
    for p in range(n_pass):
        for c in range(chunks):
            for g in range(4):
                # (taps, n, e) -> (taps, e, n)
                w[:, 32 * c + 8 * g:32 * c + 8 * g + 8,
                  128 * p:128 * p + 128] = s[p, c, :, g].transpose(0, 2, 1)
    return w


@pytest.mark.parametrize("cin,cout", [(2, 65), (5, 128), (32, 130),
                                      (70, 256), (64, 512)])
def test_weight_stream_round_trip(cin, cout):
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    cin_p, cout_p = conv_tiles.padded_channels("wgmma", cin, cout)
    assert (cin_p % 32, cout_p % 128) == (0, 0)
    stream = conv_tiles.pack_weight_stream(w, cin_p, cout_p)
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    assert stream.shape == (cout_p // 128, cin_p // 32, 9, 4, 128, 8)
    # a stage is 8 KB: what one bulk copy brings
    assert stream[0, 0, 0].numel() * 2 == conv_tiles.STAGE_BYTES
    got = unpack_stream(stream, 9, cin, cout)
    want = w.to(torch.bfloat16).reshape(9, cin, cout).view(torch.int16).numpy()
    assert np.array_equal(got[:, :cin, :cout], want)
    assert not got[:, cin:].any() and not got[:, :, cout:].any()


@pytest.mark.parametrize("cin,cout", [(2, 32), (5, 37), (64, 64)])
def test_mma_weight_round_trip(cin, cout):
    rng = np.random.default_rng(cin * cout)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    cin_p, cout_p = conv_tiles.padded_channels("mma", cin, cout)
    packed = conv_tiles.pack_weight_mma(w, cin_p, cout_p)
    assert packed.shape == (cout_p, 9, cin_p)
    want = w.to(torch.bfloat16).reshape(9, cin, cout).permute(2, 0, 1)
    assert torch.equal(packed[:cout, :, :cin], want)
    assert not packed[cout:].any() and not packed[:, :, cin:].any()


def test_packed_double_conv_chains_padded_channels():
    arrays = [torch.from_numpy(a) for a in
              double_conv_case(0, (1, 4, 4, 5), 70, 33)]
    packed = fused_conv.pack_double_conv(*arrays[1:])
    assert packed.first.path == packed.second.path == "wgmma"
    assert packed.first.padded == (32, 128)
    assert packed.second.padded == (128, 128)      # depth = conv1's width
    assert packed.first.tensors[1].shape == (128,)
    assert not packed.first.tensors[1][70:].any()
    narrow = fused_conv.pack_double_conv(
        *[torch.from_numpy(a) for a in double_conv_case(0, (1, 4, 4, 5), 40,
                                                        200)][1:])
    assert narrow.first.path == narrow.second.path == "mma"
    assert narrow.second.padded == (64, 224)


# --------------------------------------- the index scheme, emulated in torch

def _stage_matrix(stream, p, c, t):
    """The (32, 128) B operand of stage (pass, chunk, tap)."""
    return stream[p, c, t].permute(0, 2, 1).reshape(32, 128).float()


def emulate_conv(a, rows, a_w, stream, taps=9):
    """acc[q] = sum over stages of A[q + dy·a_w + dx] @ B, for q < rows
    rounded up to 64; ``a``: (pixels, K_p), read as shared memory is: rows
    past its end are uninitialised (NaN here, which must never reach a kept
    row)."""
    m_pad = round_up(rows, 64)
    reach = m_pad + 2 * a_w + 2
    junk = torch.full((max(0, reach - a.shape[0]), a.shape[1]), float("nan"))
    a = torch.cat([a.float(), junk])
    n_pass, chunks = stream.shape[:2]
    acc = torch.zeros((m_pad, n_pass * 128))
    for p in range(n_pass):
        for c in range(chunks):
            for t in range(taps):
                shift = (t // 3) * a_w + t % 3 if taps == 9 else 0
                acc[:, 128 * p:128 * p + 128] += (
                    a[shift:shift + m_pad, 32 * c:32 * c + 32]
                    @ _stage_matrix(stream, p, c, t))
    return acc


def _patch(x, b0, g, y0, x0, ph, pw, k_p):
    """(g · ph · pw, K_p): the staged patch, zero outside the image, past
    the batch and past the channels."""
    b, h, w, c = x.shape
    out = torch.zeros((g, ph, pw, k_p), dtype=x.dtype)
    for img in range(g):
        if b0 + img >= b:
            continue
        ys = [y for y in range(ph) if 0 <= y0 + y < h]
        xs = [v for v in range(pw) if 0 <= x0 + v < w]
        if ys and xs:
            out[img, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1, :c] = \
                x[b0 + img, y0 + ys[0]:y0 + ys[-1] + 1,
                  x0 + xs[0]:x0 + xs[-1] + 1]
    return out.reshape(g * ph * pw, k_p)


def _bn_relu(acc, scale, shift):
    return torch.relu(acc * scale.float() + shift.float())


def emulate_single_conv(x, packed, tile):
    """K5's wgmma path in plain PyTorch, item by item."""
    w_s, sc, sh = packed.tensors
    b, h, w, _ = x.shape
    th, tw, g = tile
    gm = WgGeom(th, tw, g, 0)
    assert gm.fits()
    out = torch.full((b, h, w, packed.cout), float("nan"), dtype=x.dtype)
    for b0 in range(0, b, g):
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                a = _patch(x, b0, g, ty0 - 1, tx0 - 1, gm.ph, gm.pw,
                           packed.padded[0])
                y = _bn_relu(emulate_conv(a, gm.m1, gm.pw, w_s), sc, sh)
                for q in range(gm.m1):
                    img, rem = divmod(q, gm.ph * gm.pw)
                    r, c = divmod(rem, gm.pw)
                    gy, gx = ty0 + r, tx0 + c
                    if (r < th and c < tw and b0 + img < b and gy < h
                            and gx < w):
                        out[b0 + img, gy, gx] = y[q, :packed.cout].to(x.dtype)
    return out


def emulate_double_conv(x, packed, tile):
    """K6's wgmma path in plain PyTorch: conv1 over the raster of the staged
    patch into the ring tile (zero outside the image, rounded to x.dtype),
    conv2 over the ring tile's own raster."""
    first, second = packed.first, packed.second
    b, h, w, _ = x.shape
    th, tw, g = tile
    cmid_p = first.padded[1]
    gm = WgGeom(th, tw, g, 1, cmid_p)
    assert gm.fits()
    out = torch.full((b, h, w, second.cout), float("nan"), dtype=x.dtype)
    for b0 in range(0, b, g):
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                a = _patch(x, b0, g, ty0 - 2, tx0 - 2, gm.ph, gm.pw,
                           first.padded[0])
                y1 = _bn_relu(emulate_conv(a, gm.m1, gm.pw, first.tensors[0]),
                              *first.tensors[1:])
                ring = torch.full((gm.ring_pixels, cmid_p), float("nan"),
                                  dtype=x.dtype)
                for q in range(gm.m1):
                    img, rem = divmod(q, gm.ph * gm.pw)
                    r, c = divmod(rem, gm.pw)
                    if r >= gm.rh or c >= gm.rw:
                        continue                     # a wrapped row: dropped
                    gy, gx = ty0 - 1 + r, tx0 - 1 + c
                    inside = (b0 + img < b and 0 <= gy < h and 0 <= gx < w)
                    ring[(img * gm.rh + r) * gm.rw + c] = \
                        y1[q].to(x.dtype) if inside else 0
                assert not torch.isnan(ring.float()).any()
                y2 = _bn_relu(emulate_conv(ring, gm.m2, gm.rw,
                                           second.tensors[0]),
                              *second.tensors[1:])
                for q in range(gm.m2):
                    img, rem = divmod(q, gm.rh * gm.rw)
                    r, c = divmod(rem, gm.rw)
                    gy, gx = ty0 + r, tx0 + c
                    if (r < th and c < tw and b0 + img < b and gy < h
                            and gx < w):
                        out[b0 + img, gy, gx] = y2[q, :second.cout].to(x.dtype)
    return out


def _bf16_exact(arrays):
    """fp32 inputs that bf16 holds exactly: packing casts the weights to
    bf16, which must not change the fp32 cases' values."""
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]


# (shape, Cmid, Cout, tile or None for the rule's): whole planes of several
# images, a batch that is no multiple of the group, ragged tiles, one pixel
DOUBLE_CASES = [
    ((3, 6, 6, 4), 70, 66, None),
    ((3, 6, 6, 4), 70, 66, (6, 6, 2)),
    ((1, 16, 24, 4), 72, 68, None),
    ((2, 13, 9, 2), 130, 5, (4, 6, 1)),
    ((1, 3, 5, 3), 65, 65, (3, 5, 4)),
    ((2, 10, 7, 5), 96, 70, (9, 18, 1)),
]


@pytest.mark.parametrize("shape,cm,co,tile", DOUBLE_CASES)
def test_double_conv_index_scheme_matches_plain_version(shape, cm, co, tile):
    arrays = _bf16_exact(double_conv_case(11, shape, cm, co))
    packed = fused_conv.pack_double_conv(*arrays[1:])
    assert packed.first.path == "wgmma"
    if tile is None:
        t = conv_tiles.double_conv_tile(shape[1], shape[2], shape[3], cm, co)
        tile = (t.th, t.tw, t.images)
    got = emulate_double_conv(arrays[0], packed, tile)
    want = fused_conv.double_conv3x3_bn_relu_ref(*arrays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


SINGLE_CASES = [
    ((5, 6, 6, 4), 70, None),
    ((5, 6, 6, 4), 70, (6, 6, 4)),
    ((1, 16, 24, 8), 129, None),
    ((2, 13, 9, 2), 65, (5, 4, 1)),
    ((3, 3, 5, 3), 200, (3, 5, 7)),
]


@pytest.mark.parametrize("shape,co,tile", SINGLE_CASES)
def test_single_conv_index_scheme_matches_plain_version(shape, co, tile):
    arrays = _bf16_exact(double_conv_case(12, shape, co, 8)[:4])
    packed = fused_conv.pack_single_conv(*arrays[1:])
    assert packed.path == "wgmma"
    if tile is None:
        t = conv_tiles.single_conv_tile(shape[1], shape[2], shape[3], co)
        tile = (t.th, t.tw, t.images)
    got = emulate_single_conv(arrays[0], packed, tile)
    want = fused_conv.conv3x3_bn_relu_ref(*arrays)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("shape,cm,co,tm", [((1, 16, 24, 4), 72, 68, 8),
                                            ((2, 16, 16, 2), 80, 66, 8)])
def test_double_conv_index_scheme_matches_jax_fp32(shape, cm, co, tm):
    arrays = _bf16_exact(double_conv_case(13, shape, cm, co))
    want = jax_double_conv(*[jnp.asarray(a.numpy()) for a in arrays],
                           tile_rows=tm, interpret=True)
    packed = fused_conv.pack_double_conv(*arrays[1:])
    t = conv_tiles.double_conv_tile(shape[1], shape[2], shape[3], cm, co)
    got = emulate_double_conv(arrays[0], packed, (t.th, t.tw, t.images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,cm,co,tm", [((1, 16, 24, 4), 72, 68, 8),
                                            ((2, 16, 16, 2), 80, 66, 8)])
def test_double_conv_index_scheme_matches_jax_bf16(shape, cm, co, tm):
    """bf16 in, the ring tile and the result rounded to bf16 from fp32 sums
    taken in another order: two bf16 steps."""
    arrays = [torch.from_numpy(a).to(torch.bfloat16)
              for a in double_conv_case(14, shape, cm, co)]
    want = jax_double_conv(
        *[jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in arrays],
        tile_rows=tm, interpret=True)
    packed = fused_conv.pack_double_conv(*arrays[1:])
    t = conv_tiles.double_conv_tile(shape[1], shape[2], shape[3], cm, co)
    got = emulate_double_conv(arrays[0], packed, (t.th, t.tw, t.images))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    assert (err <= BF16_ATOL + BF16_RTOL * np.abs(want)).all(), err.max()


@pytest.mark.parametrize("shape,co,tm", [((2, 16, 24, 8), 72, 8),
                                         ((1, 12, 13, 4), 66, 4)])
def test_single_conv_index_scheme_matches_jax_fp32(shape, co, tm):
    arrays = _bf16_exact(double_conv_case(15, shape, co, 8)[:4])
    want = jax_single_conv(*[jnp.asarray(a.numpy()) for a in arrays],
                           tile_rows=tm, interpret=True)
    packed = fused_conv.pack_single_conv(*arrays[1:])
    t = conv_tiles.single_conv_tile(shape[1], shape[2], shape[3], co)
    got = emulate_single_conv(arrays[0], packed, (t.th, t.tw, t.images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------- the packed caches

def test_fused_forward_repacks_after_a_parameter_changed_in_place():
    cfg = UNetConfig(base_features=40, depth=1)
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    cpu = torch.device("cpu")
    first = fused_forward.blocks_of(model, torch.bfloat16, cpu, packed=True)
    assert fused_forward.blocks_of(model, torch.bfloat16, cpu,
                                   packed=True) is first
    assert [blk.first.path for blk in first] == ["mma", "wgmma", "mma"]
    with torch.no_grad():
        model.blocks[1].conv[0].weight.mul_(0.5)
    again = fused_forward.blocks_of(model, torch.bfloat16, cpu, packed=True)
    assert again is not first
    assert not torch.equal(again[1].first.tensors[0], first[1].first.tensors[0])
    assert torch.equal(again[0].first.tensors[0], first[0].first.tensors[0])
    with torch.no_grad():
        model.blocks[0].norm[1].running_var.add_(1.0)
    third = fused_forward.blocks_of(model, torch.bfloat16, cpu, packed=True)
    assert third is not again
    assert not torch.equal(third[0].second.tensors[1],
                           again[0].second.tensors[1])


def test_fused_forward_folds_once_on_the_cpu():
    cfg = UNetConfig(base_features=8, depth=1)
    model = build_model(cfg, torch.Generator().manual_seed(1)).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 8, 2)).astype(np.float32))
    apply = fused_forward.make_fused_apply(cfg)
    before = apply(model, x)
    cpu = torch.device("cpu")
    folded = fused_forward.blocks_of(model, torch.bfloat16, cpu)
    assert isinstance(folded[0], tuple) and len(folded[0]) == 6
    assert torch.equal(apply(model, x), before)
    assert fused_forward.blocks_of(model, torch.bfloat16, cpu) is folded
    with torch.no_grad():
        model.head.bias.add_(1.0)
    assert fused_forward.blocks_of(model, torch.bfloat16, cpu) is not folded
    np.testing.assert_allclose(apply(model, x).numpy(), before.numpy() + 1.0,
                               rtol=1e-6, atol=1e-6)


def test_whole_forward_plan_takes_the_rule_per_stage():
    """K7's stage table carries the double conv's path and tile."""
    cfg = UNetConfig(base_features=40, depth=2)
    model = build_model(cfg, torch.Generator().manual_seed(2)).eval()
    folded = unet_mega.fold_weights(model, torch.bfloat16)
    _blob, stages = unet_mega._pack(folded, torch.device("cpu"))
    plan, _ = unet_mega._plan(stages, 5, 24, 24)
    assert [st["path"] for st in stages] == ["mma", "wgmma", "wgmma", "wgmma",
                                             "mma"]
    for row, st in zip(plan, stages):
        h, w = int(row[1]), int(row[2])
        t = conv_tiles.double_conv_tile(
            h, w, st["cin"], st["cmid"], st["cout"], even=st["kind"] == 0,
            head=st["kind"] == 2)
        assert [int(v) for v in row[27:31]] == [t.path_id, t.th, t.tw,
                                                t.images]
        if st["kind"] == 0:
            assert t.th % 2 == 0 and t.tw % 2 == 0
        assert int(row[9]) % (128 if st["path"] == "wgmma" else 32) == 0
