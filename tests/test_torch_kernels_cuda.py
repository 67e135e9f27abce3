"""The CUDA kernels K1/K4 and K2 (multi-threshold CCL), K3 (label counts),
K5 and K6 (fused single and double conv), K7 (the whole U-Net forward) and
P1 (the gather probe) against their plain PyTorch versions on the
card: labels, counts and lookups are integers, so equal bit for bit; K5 and
K6 round to bf16 from fp32 sums in another order, so two bf16 steps (2^-6
absolute plus 2^-6 relative); K7 rounds at 18 convs and 4 transposed convs in
a row, where one flipped rounding spreads, so 2% of the largest logit and a
correlation above 0.999, and a projection that tells the fp32 head from a
rounded one. Every test here needs a card and skips
without one; the file imports no JAX, so it runs on a machine with only
the port installed:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels_cuda.py`` (tests/conftest.py imports JAX).
chip_smoke.py holds the same kernels against the same plain versions at
the main path's sizes, up to 8192²."""

import os
import sys

import pytest
import torch

import numpy as np

from plumekit_torch.config import UNetConfig
from plumekit_torch.experiments import scalar_gather_probe
from plumekit_torch.experiments.conv_kernel_times import block_shapes
from plumekit_torch.models import build_model
from plumekit_torch.models.fused_forward import blocks_of, make_fused_apply
from plumekit_torch.models.kernels import conv_tiles, fused_conv, unet_mega
from plumekit_torch.ops.kernels import ccl_sweep, label_counts

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import (CASES, MASK_CASES, double_conv_case,  # noqa: E402
                             degenerate_label_count_case, label_count_case)

BF16_ATOL = BF16_RTOL = 2.0 ** -6
LOGIT_RTOL, LOGIT_MIN_CORR = 2e-2, 0.999
# K7's distance to its plain version projected on what rounding the last
# block to bf16 before the head does to the plain version's logits: 0 for a
# head that reads fp32, 1 for one that reads the rounded block
HEAD_ROUNDING_SHARE = 0.25
# K7's fp32 body against its plain version in fp32: FFMA sums in another
# order than cuDNN's fp32 convs (TF32 off)
F32_RTOL, F32_MIN_CORR = 1e-3, 0.99999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # the plain versions' fp32 convs in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_ccl_kernels_on_a_second_card_after_the_first(card):
    """K1 and K2 on cuda:1 after they ran on cuda:0: their tile passes
    need more than 48 KB of shared memory, which each device grants only
    after its own attribute call. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    field, ths = CASES[sorted(CASES)[0]]()
    for device in ("cuda:0", "cuda:1"):
        aod = torch.from_numpy(field).to(device)
        th = torch.from_numpy(ths).to(device)
        got = ccl_sweep.multi_threshold_ccl_fused(aod, th, 2)
        masks = aod[None] >= th[:, None, None]
        got_masks = ccl_sweep.multi_threshold_ccl(masks, 2)
        torch.cuda.synchronize(device)
        assert got.device == aod.device
        assert torch.equal(got, ccl_sweep.multi_threshold_ccl_ref(aod, th, 2))
        assert torch.equal(got_masks, ccl_sweep.multi_threshold_ccl_masks_ref(
            masks, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ccl_kernel_matches_plain_version(card, case, connectivity):
    field, ths = CASES[case]()
    aod = torch.from_numpy(field).to(card)
    th = torch.from_numpy(ths).to(card)
    before = ccl_sweep.LAUNCHES
    got = ccl_sweep.multi_threshold_ccl_fused(aod, th, connectivity)
    torch.cuda.synchronize()
    assert ccl_sweep.LAUNCHES == before + 1
    ref = ccl_sweep.multi_threshold_ccl_ref(aod, th, connectivity)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    banded = ccl_sweep.multi_threshold_ccl_banded(aod, th, connectivity)
    assert torch.equal(banded, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_ccl_mask_kernel_matches_plain_version(card, case, connectivity):
    stack, nested = MASK_CASES[case]()
    masks = torch.from_numpy(stack).to(card)
    before = ccl_sweep.MASK_LAUNCHES
    got = ccl_sweep.multi_threshold_ccl(masks, connectivity, nested=nested)
    torch.cuda.synchronize()
    assert ccl_sweep.MASK_LAUNCHES == before + 1
    ref = ccl_sweep.multi_threshold_ccl_masks_ref(masks, connectivity)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [0.2, 0.05])
@pytest.mark.parametrize("lines,samples", [(96, 128), (384, 1600)])
def test_ccl_mask_kernel_on_a_resampled_viirs_grid(card, lines, samples,
                                                   limit):
    """K2 on the basic detector's opened mask of a VIIRS swath resampled to
    its UTM grid, the shape ``identify_viirs`` gives it: not square, no
    multiple of 64, fill corners off the swath (at 0.05 the background
    joins up)."""
    from plumekit_torch.io import viirs_aod
    from plumekit_torch.ops.morphology import binary_opening_cross

    _, aod, lat, lon, _, _ = viirs_aod.make_synthetic_ivaot_scene(
        lines=lines, samples=samples, seed=0, n_plumes=2)
    _, aod_r, _, _ = viirs_aod.resample_viirs_aod(aod, lat, lon)
    plane = torch.from_numpy(np.nan_to_num(aod_r, nan=-999.0)).to(card)
    masks = binary_opening_cross(plane >= limit)[None].contiguous()
    assert masks.any() and not masks.all()
    before = ccl_sweep.MASK_LAUNCHES
    got = ccl_sweep.multi_threshold_ccl(masks, 2, nested=False)
    torch.cuda.synchronize()
    assert ccl_sweep.MASK_LAUNCHES == before + 1
    ref = ccl_sweep.multi_threshold_ccl_masks_ref(masks, 2)
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card(card):
    """K6 at a ragged shape with an unaligned input width (``chip_smoke.py``
    covers every U-Net shape)."""
    arrays = [torch.from_numpy(a).to(card).to(torch.bfloat16)
              for a in double_conv_case(4, (2, 37, 29, 5), 32, 40)]
    before = fused_conv.LAUNCHES
    got = fused_conv.fused_double_conv3x3_bn_relu(*arrays)
    torch.cuda.synchronize()
    assert fused_conv.LAUNCHES == before + 1
    ref = fused_conv.double_conv3x3_bn_relu_ref(*arrays).float()
    err = (got.float() - ref).abs()
    assert bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((2, 37, 29, 5), 40), ((1, 16, 24, 8), 16), ((2, 20, 20, 64), 128),
    ((3, 16, 16, 2), 32)])
def test_single_conv_kernel_matches_plain_version(card, shape, cout):
    """K5 at ragged shapes, an unaligned input width and one that needs no
    padding (``chip_smoke.py`` covers every U-Net shape)."""
    arrays = [torch.from_numpy(a).to(card).to(torch.bfloat16)
              for a in double_conv_case(5, shape, cout, 8)[:4]]
    before = fused_conv.SINGLE_LAUNCHES
    got = fused_conv.fused_conv3x3_bn_relu(*arrays)
    torch.cuda.synchronize()
    assert fused_conv.SINGLE_LAUNCHES == before + 1
    ref = fused_conv.conv3x3_bn_relu_ref(*arrays).float()
    err = (got.float() - ref).abs()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all())


# every geometry and grouping the tile rule can return: planes smaller than
# a tile (several images per block), planes of ragged tiles, batches of one
# image, of no multiple of the group and of the serving batch; unaligned and
# wide input channels; odd output channels; both paths
PLANES = [(3, 5), (6, 6), (18, 18), (29, 21), (37, 29)]
BATCHES = [1, 3, 128]


def _he_scaled(arrays):
    """The case's weights (drawn at 0.1) rescaled to (2 / fan_in)^0.5, so
    that activations stay of order one at 512 channels and two bf16 steps
    of the result bound what a flipped rounding of the first conv does."""
    for i in range(1, len(arrays), 3):
        fan_in = 9 * arrays[i].shape[2]
        arrays[i] = arrays[i] * (10.0 * (2.0 / fan_in) ** 0.5)
    return arrays


def _within_two_bf16_steps(got, ref):
    err = (got.float() - ref.float()).abs()
    return bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(2, 32), (5, 37), (64, 129),
                                      (512, 512)])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("plane", PLANES)
def test_single_conv_kernel_every_geometry(card, plane, batch, cin, cout):
    arrays = [torch.from_numpy(a).to(card).to(torch.bfloat16) for a in
              _he_scaled(double_conv_case(6, (batch, *plane, cin), cout, 8)[:4])]
    tile = conv_tiles.single_conv_tile(*plane, cin, cout)
    assert tile.path == ("wgmma" if cout > 64 else "mma")
    packed = fused_conv.pack_single_conv(*arrays[1:])
    before = fused_conv.SINGLE_LAUNCHES
    got = fused_conv.fused_conv3x3_bn_relu_packed(arrays[0], packed)
    torch.cuda.synchronize()
    assert fused_conv.SINGLE_LAUNCHES == before + 1
    assert got.shape == (batch, *plane, cout)
    assert _within_two_bf16_steps(got, fused_conv.conv3x3_bn_relu_ref(*arrays))
    # the raw-weight entry packs the same weights; two runs are equal
    assert torch.equal(fused_conv.fused_conv3x3_bn_relu(*arrays), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cmid,cout", [(2, 32, 32), (5, 128, 37),
                                           (64, 256, 256), (512, 512, 130)])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("plane", PLANES)
def test_double_conv_kernel_every_geometry(card, plane, batch, cin, cmid,
                                           cout):
    arrays = [torch.from_numpy(a).to(card).to(torch.bfloat16) for a in
              _he_scaled(double_conv_case(7, (batch, *plane, cin), cmid, cout))]
    tile = conv_tiles.double_conv_tile(*plane, cin, cmid, cout)
    assert tile.path == ("wgmma" if cmid > 64 else "mma")
    packed = fused_conv.pack_double_conv(*arrays[1:])
    before = fused_conv.LAUNCHES
    got = fused_conv.fused_double_conv3x3_bn_relu_packed(arrays[0], packed)
    torch.cuda.synchronize()
    assert fused_conv.LAUNCHES == before + 1
    assert got.shape == (batch, *plane, cout)
    assert _within_two_bf16_steps(
        got, fused_conv.double_conv3x3_bn_relu_ref(*arrays))
    assert torch.equal(fused_conv.fused_double_conv3x3_bn_relu(*arrays), got)


@pytest.mark.cuda
def test_fused_forward_packs_once_per_model(card):
    cfg = UNetConfig(base_features=40, depth=2)
    model, x = mega_case(cfg, (2, 32, 32, 2), 5, card)
    apply = make_fused_apply(cfg)
    first = blocks_of(model, torch.bfloat16, x.device)
    got = apply(model, x)
    assert blocks_of(model, torch.bfloat16, x.device) is first
    assert [b.first.path for b in first] == ["mma", "wgmma", "wgmma", "wgmma",
                                             "mma"]
    with torch.inference_mode():
        want = model(x)
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    with torch.no_grad():
        model.blocks[1].conv[0].weight.mul_(0.5)
    assert blocks_of(model, torch.bfloat16, x.device) is not first
    assert not torch.equal(apply(model, x), got)


def mega_case(cfg, shape, seed, device):
    """A seeded U-Net with nontrivial BatchNorm parameters and running
    statistics on ``device``, and an input."""
    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(2.0 ** 0.5)
            if isinstance(m, torch.nn.ConvTranspose2d):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
        model.head.bias.copy_(0.1 * torch.randn(model.head.bias.shape,
                                                generator=g))
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))
    return model.to(device).eval(), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32, 2), dict(base_features=8, depth=2)),
    ((2, 64, 48, 2), dict(base_features=8, depth=3)),
    ((1, 64, 64, 3), dict(in_channels=3, base_features=8, depth=4,
                          out_channels=3)),
    ((3, 16, 24, 2), dict(base_features=12, depth=1)),
    ((2, 96, 96, 2), dict()),             # UNetConfig(): base 32, depth 4
    ((1, 32, 32, 2), dict(base_features=160, depth=1))])  # wgmma path, head too
def test_mega_kernel_matches_plain_version(card, shape, kw, seed):
    cfg = UNetConfig(**kw)
    model, x = mega_case(cfg, shape, seed, card)
    assert unet_mega.mega_eligible(cfg, shape[1], shape[2])
    apply = unet_mega.make_mega_apply(cfg)
    before = unet_mega.LAUNCHES
    got = apply(model, x)
    torch.cuda.synchronize()
    assert unet_mega.LAUNCHES == before + 1
    weights = unet_mega.weights_of(model, torch.bfloat16, x.device)
    ref = unet_mega.mega_forward_ref(weights.folded, x)
    assert got.shape == ref.shape == shape[:3] + (cfg.out_channels,)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    g, r = got.cpu().numpy().ravel(), ref.cpu().numpy().ravel()
    assert np.abs(g - r).max() <= LOGIT_RTOL * np.abs(r).max()
    assert np.corrcoef(g, r)[0, 1] > LOGIT_MIN_CORR
    # the head reads the last block in fp32: none of that block's rounding
    # to bf16 shows in the kernel's logits
    rounding = unet_mega.mega_forward_ref(weights.folded, x,
                                          head_in_f32=False) - ref
    share = float(((got - ref) * rounding).sum() / (rounding * rounding).sum())
    assert abs(share) <= HEAD_ROUNDING_SHARE
    # the weights were packed once: a second forward reuses them
    assert unet_mega.weights_of(model, torch.bfloat16, x.device) is weights
    again = apply(model, x)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_use_mega_routes_the_module_through_the_kernel(card):
    cfg = UNetConfig(base_features=8, depth=2, use_mega=True)
    model, x = mega_case(cfg, (2, 32, 32, 2), 3, card)
    before = unet_mega.LAUNCHES, fused_conv.LAUNCHES
    with torch.inference_mode():
        got = model(x)
        ragged = model(x[:, :, :28])       # 28 % 4 == 0 but 32 x 28: eligible
        odd = model(x[:, :4, :4])          # 1-px bottleneck: falls through
    assert (unet_mega.LAUNCHES, fused_conv.LAUNCHES) == (before[0] + 2,
                                                         before[1])
    assert ragged.shape == (2, 32, 28, 1) and odd.shape == (2, 4, 4, 1)
    plain = build_model(UNetConfig(base_features=8, depth=2)).to(card).eval()
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = plain(x)
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    # fp32 compute: the module runs the kernel's fp32 body, one launch, and
    # no other forward under the flag
    f32 = build_model(UNetConfig(base_features=8, depth=2, use_mega=True,
                                 compute_dtype="float32")).to(card).eval()
    f32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got32 = f32(x)
    weights32 = unet_mega.weights_of(f32, torch.float32, x.device)
    _assert_fp32_close(got32, unet_mega.mega_forward_ref(weights32.folded, x))
    assert fused_conv.LAUNCHES == before[1]
    assert unet_mega.LAUNCHES == before[0] + 3


def _assert_fp32_close(got, ref):
    """The fp32 body against the plain version in fp32 (TF32 off): the same
    arithmetic, sums in another order."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    g, r = got.cpu().numpy().ravel(), ref.cpu().numpy().ravel()
    assert np.isfinite(g).all()
    assert np.abs(g - r).max() <= F32_RTOL * np.abs(r).max()
    assert np.corrcoef(g, r)[0, 1] > F32_MIN_CORR


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32, 2), dict(base_features=8, depth=2)),
    ((2, 64, 48, 2), dict(base_features=12, depth=3)),
    ((1, 64, 64, 3), dict(in_channels=3, base_features=8, depth=4,
                          out_channels=3)),
    ((2, 96, 96, 2), dict())])             # UNetConfig(): base 32, depth 4
def test_mega_fp32_kernel_matches_plain_version(card, shape, kw):
    cfg = UNetConfig(compute_dtype="float32", **kw)
    model, x = mega_case(cfg, shape, 11, card)
    apply = unet_mega.make_mega_apply(cfg)
    before = unet_mega.LAUNCHES
    got = apply(model, x)
    torch.cuda.synchronize()
    assert unet_mega.LAUNCHES == before + 1
    weights = unet_mega.weights_of(model, torch.float32, x.device)
    _assert_fp32_close(got, unet_mega.mega_forward_ref(weights.folded, x))
    assert torch.equal(apply(model, x), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32, 2), dict(base_features=8, depth=2)),
    ((3, 16, 24, 2), dict(base_features=12, depth=1)),
    ((1, 32, 32, 2), dict(base_features=160, depth=1)),
    ((4, 96, 96, 2), dict()),              # the bottleneck split over pairs
    ((1, 288, 288, 2), dict())])
def test_mega_kernel_stages_match_plain_version(card, shape, kw):
    """Each stage of the kernel against the plain version of that stage fed
    the kernel's own input planes (no plane reused in the debug form), under
    K6's gate; the debug form's logits equal the forward's."""
    cfg = UNetConfig(**kw)
    model, x = mega_case(cfg, shape, 13, card)
    weights = unet_mega.weights_of(model, torch.bfloat16, x.device)
    xb = x.to(torch.bfloat16).contiguous()
    logits, scratch, plan = unet_mega.mega_forward_debug(weights, xb)
    torch.cuda.synchronize()
    assert torch.equal(logits, unet_mega.mega_forward(weights, xb))
    rows = unet_mega.stage_errors(weights, xb, logits, scratch, plan)
    assert len(rows) == 2 * cfg.depth + 1
    for row in rows:
        for key in ("out", "aux", "logits"):
            if key in row:
                assert row[key]["ratio"] <= 1.0, row


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n", [(1024, 1024, 1024), (100, 100, 64),
                                   (64, 257, 32), (40, 2000, 2048)])
def test_gather_probe_kernels_match_plain_version(card, h, w, n):
    x_np = np.random.default_rng(h + n).integers(0, h * w, (h, w)) \
        .astype(np.int32)
    x = torch.from_numpy(x_np).to(card)
    want = scalar_gather_probe.numpy_loop(x_np, n)
    ref = scalar_gather_probe.gather_probe_ref(x, n)
    assert np.array_equal(ref.cpu().numpy(), want)
    before = (scalar_gather_probe.CHAINED_LAUNCHES,
              scalar_gather_probe.PARALLEL_LAUNCHES)
    for chained in (True, False):
        got = scalar_gather_probe.gather_probe(x, n, chained)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert (scalar_gather_probe.CHAINED_LAUNCHES,
            scalar_gather_probe.PARALLEL_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f", [
    ((3, 64, 64), 1), ((5, 100, 190), 16), ((2, 257, 129), 128),
    ((1, 8, 128), 128), ((3, 61, 203), 5), ((20, 1201, 997), 64)])
def test_label_counts_kernel_matches_plain_version(card, shape, f):
    labels, labs = (torch.from_numpy(a).to(card)
                    for a in label_count_case(shape, f, sum(shape) + f))
    before = label_counts.LAUNCHES
    got = label_counts.fire_label_counts(labels, labs)
    torch.cuda.synchronize()
    assert label_counts.LAUNCHES == before + 1
    assert torch.equal(got, label_counts.fire_label_counts_ref(labels, labs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_lab", "all_same", "all_zero"])
def test_label_counts_kernel_degenerate_labs(card, kind):
    labels, labs = (torch.from_numpy(a).to(card)
                    for a in degenerate_label_count_case(kind))
    got = label_counts.fire_label_counts(labels, labs)
    assert torch.equal(got, label_counts.fire_label_counts_ref(labels, labs))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    aod = torch.zeros((8, 8), device=card)
    th = torch.tensor([0.5, 0.25], device=card)
    with pytest.raises(ValueError, match="float32"):
        ccl_sweep.multi_threshold_ccl_fused(aod.double(), th)
    with pytest.raises(ValueError, match="thresholds"):
        ccl_sweep.multi_threshold_ccl_fused(aod, th.cpu())
    with pytest.raises(ValueError, match="connectivity"):
        ccl_sweep.multi_threshold_ccl_fused(aod, th, 3)
    masks = torch.zeros((2, 8, 8), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="bool"):
        ccl_sweep.multi_threshold_ccl(masks.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        ccl_sweep.multi_threshold_ccl(masks.transpose(1, 2))
    with pytest.raises(ValueError, match="connectivity"):
        ccl_sweep.multi_threshold_ccl(masks, 3)
    x = torch.zeros((1, 8, 8, 4), device=card)
    w = torch.zeros((3, 3, 4, 8), device=card)
    with pytest.raises(ValueError, match="bf16"):
        fused_conv.fused_conv3x3_bn_relu(x, w, w[0, 0, 0], w[0, 0, 0])
    with pytest.raises(ValueError, match="do not fit"):
        fused_conv.fused_conv3x3_bn_relu(x.bfloat16(), w[:, :, :3],
                                         w[0, 0, 0], w[0, 0, 0])
    with pytest.raises(ValueError, match="int32"):
        scalar_gather_probe.gather_probe(x[0, :, :, 0], 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        scalar_gather_probe.gather_probe(
            torch.zeros((64, 64), dtype=torch.int32, device=card), 40)
    labels = torch.zeros((2, 8, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="capacity"):
        label_counts.fire_label_counts(
            labels, torch.zeros((2, 129), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="labs"):
        label_counts.fire_label_counts(
            labels, torch.zeros((3, 4), dtype=torch.int32, device=card))


TRAIN_KW = dict(base_features=16, depth=3)


def _train_setup():
    from plumekit_torch.config import TrainConfig

    tcfg = TrainConfig(batch_size=4, tile_size=64, warmup_steps=1,
                       total_steps=4, augment=False)
    rng = np.random.default_rng(0)
    batches = [(rng.random((4, 64, 64, 2), dtype=np.float32),
                (rng.random((4, 64, 64, 1)) < 0.2).astype(np.float32))
               for _ in range(3)]
    weights = build_model(UNetConfig(**TRAIN_KW),
                          torch.Generator().manual_seed(0)).state_dict()
    return tcfg, batches, weights


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(card):
    """Three fp32 train steps on the card (TF32 off) against three on the
    CPU in fp32 and in float64 from the same weights and batches: the same
    loss at every step; at steps 1 and 2, whose forwards see the same
    weights (step 1's lr is 0), gradients and running statistics at most 4
    times as far from the float64 step's as the CPU fp32 step's, plus fp32
    rounding (1e-5 of a tensor's largest gradient, 1e-6). Then one AdamW
    update on the card and on the CPU from the same state and gradients:
    parameters within 1e-3 of the lr."""
    import copy

    from plumekit_torch.models.losses import dice_bce_loss
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_train_step

    kw = TRAIN_KW
    tcfg, batches, weights = _train_setup()
    runs = {}
    for name, dtype, dev in (("cpu64", "float64", "cpu"),
                             ("cpu32", "float32", "cpu"),
                             ("card32", "float32", card)):
        state = create_state(UNetConfig(compute_dtype=dtype, **kw), tcfg, dev)
        state.model.load_state_dict(weights)
        step = make_train_step(augment=False)
        runs[name] = []
        for xs, ys in batches:
            state, m = step(state, torch.from_numpy(xs).to(dev),
                            torch.from_numpy(ys).to(dev), None)
            # copies: on the CPU .cpu() returns the live tensor
            runs[name].append((float(m["loss"]), {
                n: p.grad.cpu().clone()
                for n, p in state.model.named_parameters()},
                {n: t.cpu().clone()
                 for n, t in state.model.state_dict().items()
                 if n.endswith(("running_mean", "running_var"))}))

    def distance(run, ref):
        return (max(float((run[1][n] - g).abs().max() / g.abs().max())
                    for n, g in ref[1].items()),
                max(float((run[2][n] - t).abs().max())
                    for n, t in ref[2].items()))

    for i, (ref, cpu, got) in enumerate(zip(runs["cpu64"], runs["cpu32"],
                                            runs["card32"])):
        assert got[0] == pytest.approx(cpu[0], rel=1e-4)
        if i < 2:
            for d_card, d_cpu, floor in zip(distance(got, ref),
                                            distance(cpu, ref), (1e-5, 1e-6)):
                assert d_card <= 4 * d_cpu + floor

    cpu = create_state(UNetConfig(compute_dtype="float32", **kw), tcfg, "cpu")
    cpu.model.load_state_dict(weights)
    step = make_train_step(augment=False)
    for xs, ys in batches[:2]:
        step(cpu, torch.from_numpy(xs), torch.from_numpy(ys), None)
    on_card = create_state(UNetConfig(compute_dtype="float32", **kw), tcfg,
                           card)
    on_card.load_state_dict(copy.deepcopy(cpu.state_dict()))
    xs, ys = (torch.from_numpy(a) for a in batches[2])
    cpu.optimizer.zero_grad()
    dice_bce_loss(cpu.model(xs), ys).backward()
    for pc, pg in zip(cpu.model.parameters(), on_card.model.parameters()):
        pg.grad = pc.grad.to(card)
    cpu.optimizer.step()
    on_card.optimizer.step()
    for pc, pg in zip(cpu.model.parameters(), on_card.model.parameters()):
        assert (pc.detach() - pg.detach().cpu()).abs().max() <= \
            1e-3 * tcfg.learning_rate


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["use_pallas", "use_mega"])
def test_fused_eval_after_train_steps_reads_the_new_weights(card, flag):
    """An eval through K6 or K7 after optimizer steps equals the plain eval
    of the updated weights: the routes' packed weights follow the in-place
    updates."""
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_train_step

    tcfg, batches, weights = _train_setup()
    bf16 = UNetConfig(**TRAIN_KW)
    state = create_state(UNetConfig(**{**bf16.__dict__, flag: True}), tcfg,
                         card)
    state.model.load_state_dict(weights)
    plain = build_model(bf16).to(card).eval()
    xs = torch.from_numpy(batches[0][0]).to(card)
    ys = torch.from_numpy(batches[0][1]).to(card)
    step = make_train_step(augment=False)
    for _ in range(2):
        with torch.no_grad():
            state.model.eval()(xs)
        state, _ = step(state, xs, ys, None)
        plain.load_state_dict(state.model.state_dict())
        with torch.no_grad():
            got = state.model.eval()(xs).float().cpu().numpy().ravel()
            want = plain(xs).float().cpu().numpy().ravel()
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
        assert np.corrcoef(got, want)[0, 1] > LOGIT_MIN_CORR


# ------------------------------------------------------------ Q1, int8 conv

def _int8_conv_cases():
    """The 18 convs of UNetConfig() at 288², then the UNet++'s convs of
    other shapes: its dense concats' (c0, c1, cout) triples."""
    from plumekit_torch.experiments.int8_conv_times import conv_cases

    cases = conv_cases(UNetConfig(), 288)
    seen = {c[:3] for c in cases}
    for c in conv_cases(UNetConfig(arch="unetpp", deep_supervision=True),
                        288):
        if c[:3] not in seen:
            seen.add(c[:3])
            cases.append(c)
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("case", _int8_conv_cases(),
                         ids=lambda c: f"{c[0]}+{c[1]}-{c[2]}-{c[3]}"
                                       f"{'-i8' if c[4] else '-f32'}")
def test_int8_conv_kernel_matches_plain_version(card, case):
    """Q1 at the 18 convs of UNetConfig() and at the six other (c0, c1,
    cout) of the UNet++'s dense concats, at 288² tiles, batch 2, in the
    output mode the forward gives each (int8, fp32 for the last), with the
    two-plane concat: equal bit for bit (the epilogue rounds step by step,
    as the plain version does), and once more in the other mode."""
    from plumekit_torch.experiments.int8_conv_times import case_inputs
    from plumekit_torch.models.kernels import int8_conv

    rng = np.random.default_rng(sum(case[:4]))
    x, w, a, b, scale, skip = case_inputs(rng, case, 2, card)
    for out_scale in (scale, None if scale is not None else
                      torch.tensor(0.05, device=card)):
        before = int8_conv.LAUNCHES
        got = int8_conv.int8_conv3x3(x, w, a, b, out_scale, skip)
        torch.cuda.synchronize()
        assert int8_conv.LAUNCHES == before + 1
        ref = int8_conv.int8_conv3x3_ref(x, w, a, b, out_scale, skip)
        assert got.dtype == ref.dtype
        assert got.dtype == (torch.float32 if out_scale is None
                             else torch.int8)
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c_skip,cout", [
    ((1, 5, 7, 2), 0, 8),          # tiny plane, Cin 2, Cout under a chunk
    ((3, 37, 29, 48), 0, 40),      # ragged, 16-aligned, two output chunks
    ((2, 20, 21, 24), 40, 33),     # two sources, odd Cout
    ((1, 18, 18, 64), 64, 64)])    # the bottleneck's 18² plane
def test_int8_conv_kernel_ragged_shapes(card, shape, c_skip, cout):
    from plumekit_torch.models.kernels import int8_conv

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)
                         ).to(card)
    skip = (torch.from_numpy(rng.integers(0, 128, shape[:3] + (c_skip,),
                                          dtype=np.int8)).to(card)
            if c_skip else None)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, shape[3] + c_skip,
                                                  cout), dtype=np.int8)
                         ).to(card)
    a = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
                         ).to(card)
    b = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32)).to(card)
    for scale in (torch.tensor(0.03, device=card), None):
        got = int8_conv.int8_conv3x3(x, w, a, b, scale, skip)
        assert torch.equal(got, int8_conv.int8_conv3x3_ref(x, w, a, b, scale,
                                                           skip))


def _int8_shapes():
    from plumekit_torch.models.kernels.int8_conv import SHAPES

    return SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tile", _int8_shapes(),
    ids=lambda s: f"{s.nb}x{s.mt}{'-fold' if s.fold else ''}")
def test_int8_conv_kernel_at_either_tile(card, tile):
    """Q1 at each shape of the kernel (output channels and rows per block,
    the fold), whatever the rule would pick, at the rule's tile and at a
    ragged one: a ragged two-source plane (the fold: a 3-channel one), both
    output modes."""
    from plumekit_torch.models.kernels import int8_conv

    rng = np.random.default_rng(7)
    c0, c1 = (3, 0) if tile.fold else (40, 24)
    x = torch.from_numpy(rng.integers(0, 128, (2, 20, 21, c1 or c0),
                                      dtype=np.int8)).to(card)
    skip = (torch.from_numpy(rng.integers(0, 128, (2, 20, 21, c0),
                                          dtype=np.int8)).to(card)
            if c1 else None)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, c0 + c1, 33),
                                      dtype=np.int8)).to(card)
    a = torch.from_numpy(rng.uniform(1e-4, 1e-3, 33).astype(np.float32)
                         ).to(card)
    b = torch.from_numpy(rng.normal(0, 1, 33).astype(np.float32)).to(card)
    packed = int8_conv.pack_conv(w, a, b, c0 if c1 else None, tile)
    for t in (int8_conv.conv_tile(20, 21, 2, tile),
              int8_conv.Q1Tile(tile, 3, 5, 1)):
        for scale in (torch.tensor(0.03, device=card), None):
            got = int8_conv.int8_conv3x3_packed(x, packed, scale, skip,
                                                tile=t)
            assert torch.equal(got, int8_conv.int8_conv3x3_ref(
                x, w, a, b, scale, skip))


# ------------------------------------------------ Q2, int8 transposed conv

def _upsample_cases():
    from plumekit_torch.experiments.int8_conv_times import upsample_cases

    return upsample_cases(UNetConfig(), 288)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _upsample_cases(),
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_int8_upsample_kernel_matches_plain_version(card, case):
    """Q2 at the four upsamples of UNetConfig() at 128 tiles of 288²: equal
    bit for bit to its plain version (torch._int_mm and the eager dequant,
    shuffle and requant), one launch each."""
    from plumekit_torch.experiments.int8_conv_times import upsample_inputs
    from plumekit_torch.models.kernels import int8_upsample

    rng = np.random.default_rng(sum(case))
    x, kq, sw, bias, scale = upsample_inputs(rng, case, 128, card)
    before = int8_upsample.LAUNCHES
    got = int8_upsample.int8_upsample2x2(x, kq, sw, bias, scale)
    torch.cuda.synchronize()
    assert int8_upsample.LAUNCHES == before + 1
    ref = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 2), 8),          # tiny plane, Cin 2, quadrants of 8
    ((3, 37, 29, 48), 40),      # ragged plane, Cin 16-aligned, odd runs
    ((2, 9, 11, 24), 33),       # Cin and Cout off the 16s
    ((1, 13, 17, 100), 64)])    # Cin past a chunk, not 16-aligned
def test_int8_upsample_kernel_ragged_shapes(card, shape, cout):
    from plumekit_torch.models.kernels import int8_upsample

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)
                         ).to(card)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 2, shape[3], cout),
                                       dtype=np.int8)).to(card)
    sw = torch.from_numpy(rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
                          ).to(card)
    bias = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32)
                            ).to(card)
    scale = torch.tensor(0.02, device=card)
    want = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
    for s in int8_upsample.upsample_candidates(shape[3], cout):
        # the launch at the shape itself (the op takes the default item)
        got = int8_upsample._launch(
            x, int8_upsample.pack_upsample(kq, sw, bias, s), scale)
        assert torch.equal(got, want), s


@pytest.mark.cuda
@pytest.mark.parametrize("case", _upsample_cases(),
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_int8_upsample_kernel_at_every_shape(card, case):
    """Q2 at each shape an upsample of UNetConfig() may take (columns a
    pass, slices, rows an item), 8 tiles of 288²: bit for bit, one launch
    a call."""
    from plumekit_torch.experiments.int8_conv_times import upsample_inputs
    from plumekit_torch.models.kernels import int8_upsample

    rng = np.random.default_rng(sum(case) + 1)
    x, kq, sw, bias, scale = upsample_inputs(rng, case, 8, card)
    want = int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale)
    for s in int8_upsample.upsample_candidates(case[0], case[1]):
        packed = int8_upsample.pack_upsample(kq, sw, bias, s)
        before = int8_upsample.LAUNCHES
        got = int8_upsample._launch(x, packed, scale)
        torch.cuda.synchronize()
        assert int8_upsample.LAUNCHES == before + 1
        assert torch.equal(got, want), s


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [288, 256, 384, 512])
def test_int8_upsample_kernel_at_the_unetpp_and_tuner_shapes(card, tile):
    """Q2 at the 10 upsamples of the UNet++ int8 forward at 288² and at
    the tuner's tiles, 16 tiles a batch: bit for bit, one launch each."""
    from plumekit_torch.experiments.int8_conv_times import (upsample_cases,
                                                            upsample_inputs)
    from plumekit_torch.models.kernels import int8_upsample

    cfg = UNetConfig(arch="unetpp", deep_supervision=True)
    cases = upsample_cases(cfg, tile)
    assert len(cases) == 10
    rng = np.random.default_rng(tile + 3)
    for case in dict.fromkeys(cases):
        x, kq, sw, bias, scale = upsample_inputs(rng, case, 16, card)
        before = int8_upsample.LAUNCHES
        got = int8_upsample.int8_upsample2x2(x, kq, sw, bias, scale)
        torch.cuda.synchronize()
        assert int8_upsample.LAUNCHES == before + 1
        assert torch.equal(got, int8_upsample.int8_upsample2x2_ref(
            x, kq, sw, bias, scale)), case


@pytest.mark.cuda
def test_int8_upsample_op_refuses_a_weight_packed_for_q1(card):
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    wq = torch.ones((3, 3, 64, 32), dtype=torch.int8, device=card)
    q1 = int8_conv.pack_conv(wq, torch.ones(32, device=card),
                             torch.zeros(32, device=card))
    x = torch.zeros((1, 4, 4, 64), dtype=torch.int8, device=card)
    before = int8_upsample.LAUNCHES
    with pytest.raises(ValueError, match="no weight packed for Q2"):
        int8_upsample.int8_upsample2x2_op(x, q1.wt, q1.a, q1.b,
                                          torch.tensor(1.0, device=card), 32)
    assert int8_upsample.LAUNCHES == before


@pytest.mark.cuda
def test_int8_upsample_wrapper_refuses_what_the_kernel_does_not_take(card):
    from plumekit_torch.models.kernels import int8_upsample

    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8, device=card)
    kq = torch.zeros((2, 2, 32, 16), dtype=torch.int8, device=card)
    v = torch.zeros(16, device=card)
    s = torch.tensor(1.0, device=card)
    with pytest.raises(ValueError, match="int8"):
        int8_upsample.int8_upsample2x2(x.float(), kq, v, v, s)
    with pytest.raises(ValueError, match="contiguous"):
        int8_upsample.int8_upsample2x2(x.transpose(1, 2), kq, v, v, s)
    with pytest.raises(ValueError, match="does not fit"):
        int8_upsample.int8_upsample2x2(x[..., :16].contiguous(), kq, v, v, s)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(4 * 4 * 32 + 1, dtype=torch.int8, device=card)
        int8_upsample.int8_upsample2x2(flat[1:].view(1, 4, 4, 32), kq, v, v,
                                       s)


@pytest.mark.cuda
def test_int8_forward_on_the_card_matches_the_cpu(card):
    """The int8 forward of a seeded base-16 depth-3 U-Net, its qvars
    calibrated on the card, Q1 per conv and Q2 per upsample: every int8
    plane equal to the CPU's plain forward on the same qvars, the logits
    within 1e-5 of the largest."""
    from plumekit_torch.models.kernels import int8_conv, int8_upsample
    from plumekit_torch.models.quantized_forward import (
        make_quantized_apply, quantize_unet, qvars_to)

    cfg = UNetConfig(base_features=16, depth=3)
    model = build_model(cfg, torch.Generator().manual_seed(3)).to(card).eval()
    rng = np.random.default_rng(6)
    x = rng.random((2, 64, 64, 2), dtype=np.float32)
    qvars = quantize_unet(model, cfg, x)
    cpu_qvars = qvars_to(qvars, "cpu")
    apply = make_quantized_apply(cfg)
    planes_card, planes_cpu = [], []
    before = int8_conv.LAUNCHES
    before_q2 = int8_upsample.LAUNCHES
    got = apply(qvars, torch.from_numpy(x).to(card), planes=planes_card)
    assert int8_conv.LAUNCHES == before + 2 * (2 * cfg.depth + 1)
    assert int8_upsample.LAUNCHES == before_q2 + cfg.depth
    want = apply(cpu_qvars, torch.from_numpy(x), planes=planes_cpu)
    assert len(planes_card) == len(planes_cpu) > 0
    for p, q in zip(planes_card, planes_cpu):
        assert p.dtype == torch.int8 and torch.equal(p.cpu(), q)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("prune_level", [None, 2])
def test_unetpp_int8_forward_on_the_card_matches_the_cpu(card, prune_level):
    """The int8 forward of a seeded base-16 depth-3 deep-supervised UNet++,
    whole and pruned at 2: Q1 twice per node, Q2 once per upsample, every
    int8 plane (the dense concats' sources, the side heads' requants) equal
    to the CPU's, the logits within 1e-5 of the largest."""
    from plumekit_torch.models.kernels import int8_conv, int8_upsample
    from plumekit_torch.models.quantized_forward import (
        make_quantized_apply, quantize_unet, qvars_to)

    cfg = UNetConfig(base_features=16, depth=3, arch="unetpp",
                     deep_supervision=True, prune_level=prune_level)
    model = build_model(cfg, torch.Generator().manual_seed(4)).to(card).eval()
    x = np.random.default_rng(7).random((2, 64, 64, 2), dtype=np.float32)
    qvars = quantize_unet(model, cfg, x)
    apply = make_quantized_apply(cfg)
    planes_card, planes_cpu = [], []
    before = (int8_conv.LAUNCHES, int8_upsample.LAUNCHES)
    got = apply(qvars, torch.from_numpy(x).to(card), planes=planes_card)
    level = prune_level or cfg.depth
    assert (int8_conv.LAUNCHES - before[0], int8_upsample.LAUNCHES
            - before[1]) == ((level + 1) * (level + 2), level * (level + 1)
                             // 2)
    want = apply(qvars_to(qvars, "cpu"), torch.from_numpy(x),
                 planes=planes_cpu)
    assert len(planes_card) == len(planes_cpu) > 0
    for p, q in zip(planes_card, planes_cpu):
        assert p.dtype == torch.int8 and torch.equal(p.cpu(), q)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_int8_conv_wrapper_refuses_what_the_kernel_does_not_take(card):
    from plumekit_torch.models.kernels import int8_conv

    x = torch.zeros((1, 8, 8, 32), dtype=torch.int8, device=card)
    w = torch.zeros((3, 3, 32, 32), dtype=torch.int8, device=card)
    a = torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="int8"):
        int8_conv.int8_conv3x3(x.float(), w, a, a)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv3x3(x.transpose(1, 2), w, a, a)
    with pytest.raises(ValueError, match="do not fit"):
        int8_conv.int8_conv3x3(x, w[:, :, :16], a, a)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(8 * 8 * 32 + 1, dtype=torch.int8, device=card)
        int8_conv.int8_conv3x3(flat[1:].view(1, 8, 8, 32), w, a, a)
    with pytest.raises(ValueError, match="does not fit a block"):
        packed = int8_conv.pack_conv(w, a, a)
        int8_conv.int8_conv3x3_packed(
            x, packed, tile=int8_conv.Q1Tile(packed.shape, 16, 64, 1))


# ------------------------------------------ streams: prefetch, uint16, TTA

@pytest.mark.cuda
def test_device_prefetch_on_the_side_stream_equals_the_source(card):
    """Items staged on the side stream (pinned copies, the consumer's stream
    waiting on their event) equal their sources when the consumer reads
    them, while the consumer's stream keeps allocating and freeing."""
    from plumekit_torch.io.prefetch import device_prefetch, make_device_put
    from plumekit_torch.ops.quant import quantize_uint16, uint16_bits

    rng = np.random.default_rng(0)
    items = []
    for i in range(6):
        x = rng.random((1024 + 64 * i, 1024, 2), dtype=np.float32)
        q, lo, scale = quantize_uint16(x)
        items.append((f"g{i}", (x, uint16_bits(q), lo, scale), (i, i)))
    got = []
    for name, (x, q, lo, scale), hw in device_prefetch(
            iter(items), buffer_size=2, device_put=make_device_put(card)):
        scratch = torch.empty(x.numel(), device=card).normal_()
        assert x.device.type == q.device.type == "cuda"
        got.append((name, x.cpu().numpy(), q.cpu().numpy(), lo.cpu().numpy(),
                    scale.cpu().numpy(), hw))
        del scratch
    assert [g[0] for g in got] == [f"g{i}" for i in range(6)]
    for (name, x, q, lo, scale, hw), (_, src, _hw) in zip(got, items):
        for a, b in zip((x, q, lo, scale), src):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert hw == _hw


@pytest.mark.cuda
def test_uint16_upload_and_dequant_on_the_card(card):
    """The uint16 code crosses as int16 bits and widens on the card to the
    CPU's dequantized values, bit for bit (one multiply and one add, each
    its own kernel on both)."""
    from plumekit_torch.io.prefetch import device_prefetch, make_device_put
    from plumekit_torch.ops.quant import (dequantize, quantize_uint16,
                                          uint16_bits)

    x = np.random.default_rng(1).random((300, 257, 2), np.float32) * 2.3
    q, lo, scale = quantize_uint16(x)
    assert q.max() == 65535
    (qd, lod, scaled), = device_prefetch(
        iter([(uint16_bits(q), lo, scale)]),
        device_put=make_device_put(card))
    assert qd.dtype == torch.int16 and qd.numel() * 2 == q.nbytes
    got = dequantize(qd, lod, scaled).cpu().numpy()
    want = dequantize(torch.from_numpy(q), torch.from_numpy(lo),
                      torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got - x) <= scale / 2 + 1e-6)


@pytest.mark.cuda
def test_tta_over_k6_launches_it_once_per_forward(card):
    """``--tta`` over the fused forward: one forward of 8× the tiles, K6
    once per block; against the mean of the 8 views' own K6 forwards and
    against TTA over the plain (cuDNN) forward within the serving gate."""
    from plumekit_torch.infer.tta import _D4, make_tta_apply

    model = build_model(UNetConfig(), torch.Generator().manual_seed(0)) \
        .to(card).eval()
    fused = make_fused_apply(model.cfg)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (4, 96, 96, 2), dtype=np.float32)).to(card)
    with torch.inference_mode():
        before = fused_conv.LAUNCHES
        got = torch.sigmoid(make_tta_apply(fused)(model, x))
        assert fused_conv.LAUNCHES - before == 2 * model.cfg.depth + 1
        views = []
        for k, f in _D4:
            v = torch.flip(x, dims=(2,)) if f else x
            y = fused(model, torch.rot90(v, k, dims=(1, 2)).contiguous())
            y = torch.rot90(y, -k, dims=(1, 2))
            views.append(torch.sigmoid(
                (torch.flip(y, dims=(2,)) if f else y).float()))
        want = torch.stack(views).mean(0)
        plain = torch.sigmoid(make_tta_apply(lambda m, t: m(t))(model, x))
    assert got.shape == (4, 96, 96, 1) and torch.isfinite(got).all()
    # the views' own forwards group the tiles otherwise: two bf16 steps
    assert float((got - want).abs().max()) <= BF16_ATOL
    assert float((got - plain).abs().max()) <= 5e-2


# --------------------------- K6, K7, Q1, Q2 at the serving tuner's new tiles

TUNER_TILES = [256, 384, 512]     # the default grid's tiles besides 288


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TUNER_TILES)
def test_double_conv_kernel_at_the_tuners_tiles(card, tile):
    """K6 at the nine block shapes of UNetConfig() at the tuner's 256²,
    384² and 512² tiles, two tiles a batch, within two bf16 steps."""
    for cin, cmid, cout, h in block_shapes(UNetConfig(), tile):
        arrays = [torch.from_numpy(a).to(card).to(torch.bfloat16) for a in
                  _he_scaled(double_conv_case(h, (2, h, h, cin), cmid, cout))]
        before = fused_conv.LAUNCHES
        got = fused_conv.fused_double_conv3x3_bn_relu(*arrays)
        torch.cuda.synchronize()
        assert fused_conv.LAUNCHES == before + 1
        assert got.shape == (2, h, h, cout)
        assert _within_two_bf16_steps(
            got, fused_conv.double_conv3x3_bn_relu_ref(*arrays)), (cin, h)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TUNER_TILES)
def test_mega_kernel_at_the_tuners_tiles(card, tile):
    """K7's forward of UNetConfig() over two tiles of the tuner's sizes
    against its plain version: one launch, 2% of the largest logit,
    correlation above 0.999, the head reading fp32."""
    cfg = UNetConfig()
    model, x = mega_case(cfg, (2, tile, tile, 2), tile, card)
    apply = unet_mega.make_mega_apply(cfg)
    before = unet_mega.LAUNCHES
    got = apply(model, x)
    torch.cuda.synchronize()
    assert unet_mega.LAUNCHES == before + 1
    weights = unet_mega.weights_of(model, torch.bfloat16, x.device)
    ref = unet_mega.mega_forward_ref(weights.folded, x)
    assert got.shape == ref.shape == (2, tile, tile, 1)
    g, r = got.cpu().numpy().ravel(), ref.cpu().numpy().ravel()
    assert np.isfinite(g).all()
    assert np.abs(g - r).max() <= LOGIT_RTOL * np.abs(r).max()
    assert np.corrcoef(g, r)[0, 1] > LOGIT_MIN_CORR
    rounding = unet_mega.mega_forward_ref(weights.folded, x,
                                          head_in_f32=False) - ref
    share = float(((got - ref) * rounding).sum() / (rounding * rounding).sum())
    assert abs(share) <= HEAD_ROUNDING_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TUNER_TILES)
def test_int8_kernels_at_the_tuners_tiles(card, tile):
    """Q1 at the 18 convs and Q2 at the 4 upsamples of the int8 forward of
    UNetConfig() at the tuner's tiles, two tiles a batch: equal bit for bit
    to their plain versions, one launch each."""
    from plumekit_torch.experiments.int8_conv_times import (
        case_inputs, conv_cases, upsample_cases, upsample_inputs)
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    rng = np.random.default_rng(tile)
    for case in conv_cases(UNetConfig(), tile):
        x, w, a, b, scale, skip = case_inputs(rng, case, 2, card)
        before = int8_conv.LAUNCHES
        got = int8_conv.int8_conv3x3(x, w, a, b, scale, skip)
        torch.cuda.synchronize()
        assert int8_conv.LAUNCHES == before + 1
        assert torch.equal(got, int8_conv.int8_conv3x3_ref(x, w, a, b, scale,
                                                           skip)), case
    for case in upsample_cases(UNetConfig(), tile):
        x, kq, sw, bias, scale = upsample_inputs(rng, case, 2, card)
        before = int8_upsample.LAUNCHES
        got = int8_upsample.int8_upsample2x2(x, kq, sw, bias, scale)
        torch.cuda.synchronize()
        assert int8_upsample.LAUNCHES == before + 1
        assert torch.equal(got, int8_upsample.int8_upsample2x2_ref(
            x, kq, sw, bias, scale)), case


def _op_case(name, card):
    """(op, its arguments on the card, the plain version's result on the
    same tensors, whether the op must equal it bit for bit) at a shape of
    the main path's forward (UNetConfig(), tile 288; K7 at its tile 96),
    two tiles a batch."""
    from plumekit_torch.experiments.int8_conv_times import (case_inputs,
                                                            upsample_inputs)
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    shapes = block_shapes(UNetConfig(), 288)
    if name in ("fused_conv3x3", "fused_double_conv3x3"):
        cin, cmid, cout, h = shapes[1 if name == "fused_conv3x3" else 2]
        x, w1, s1, b1, w2, s2, b2 = [
            torch.from_numpy(a).to(card).to(torch.bfloat16) for a in
            _he_scaled(double_conv_case(h, (2, h, h, cin), cmid, cout))]
        if name == "fused_conv3x3":
            packed = fused_conv.pack_single_conv(w1, s1, b1)
            return (fused_conv.fused_conv3x3_op,
                    (x, *packed.tensors, cmid),
                    fused_conv.conv3x3_bn_relu_ref(x, w1, s1, b1), False)
        packed = fused_conv.pack_double_conv(w1, s1, b1, w2, s2, b2)
        return (fused_conv.fused_double_conv3x3_op,
                (x, *packed.first.tensors, *packed.second.tensors, cmid,
                 cout),
                fused_conv.double_conv3x3_bn_relu_ref(x, w1, s1, b1, w2, s2,
                                                      b2), False)
    if name == "unet_mega":
        model, x = mega_case(UNetConfig(), (2, 96, 96, 2), 11, card)
        x = x.to(torch.bfloat16)
        weights = unet_mega.weights_of(model, torch.bfloat16, card)
        return (unet_mega.unet_mega_op,
                (x, [weights.blob], list(weights.ints), 1),
                unet_mega.mega_forward_ref(weights.folded, x), False)
    rng = np.random.default_rng(12)
    if name == "int8_conv3x3":
        case = next(c for c in _int8_conv_cases() if c[0])  # with its skip
        x, w, a, b, scale, skip = case_inputs(rng, case, 2, card)
        packed = int8_conv.pack_conv(w, a, b, skip.shape[-1])
        return (int8_conv.int8_conv3x3_op,
                (x, packed.wt, packed.a, packed.b, scale, skip, packed.cout),
                int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip), True)
    x, kq, sw, bias, scale = upsample_inputs(rng, _upsample_cases()[1], 2,
                                             card)
    packed = int8_upsample.pack_upsample(kq, sw, bias)
    return (int8_upsample.int8_upsample2x2_op,
            (x, packed.wt, packed.a, packed.b, scale, packed.cout),
            int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale), True)


OP_COUNTERS = {"fused_conv3x3": (fused_conv, "SINGLE_LAUNCHES"),
               "fused_double_conv3x3": (fused_conv, "LAUNCHES"),
               "unet_mega": (unet_mega, "LAUNCHES")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_conv3x3", "fused_double_conv3x3",
                                  "unet_mega", "int8_conv3x3",
                                  "int8_upsample2x2"])
def test_op_on_the_card_eager_and_exported(card, name):
    """Each kernel's op on CUDA tensors, called eagerly and from a program
    of ``torch.export``: one launch each, the two equal bit for bit, and
    both against the plain version (the op's CPU implementation) on the
    same tensors: Q1 and Q2 bit for bit, K5 and K6 within two bf16 steps,
    K7 within 2% of the largest logit."""
    from plumekit_torch.models.kernels import int8_conv, int8_upsample

    op, args, ref, exact = _op_case(name, card)
    module, counter = OP_COUNTERS.get(name, (
        int8_conv if name == "int8_conv3x3" else int8_upsample, "LAUNCHES"))

    def is_input(v):
        return isinstance(v, torch.Tensor) or (
            isinstance(v, list) and bool(v) and isinstance(v[0],
                                                           torch.Tensor))

    class Call(torch.nn.Module):
        def forward(self, *inputs):
            it = iter(inputs)
            return op(*[next(it) if is_input(v) else v for v in args])

    inputs = tuple(v for v in args if is_input(v))
    program = torch.export.export(Call(), inputs, strict=False)
    assert sum(str(n.target).startswith(f"plumekit.{name}")
               for n in program.graph.nodes) == 1
    before = getattr(module, counter)
    eager = op(*args)
    exported = program.module()(*inputs)
    torch.cuda.synchronize()
    assert getattr(module, counter) == before + 2
    assert torch.equal(eager, exported)
    assert eager.shape == ref.shape and eager.dtype == ref.dtype
    if exact:
        assert torch.equal(eager, ref)
    elif name == "unet_mega":
        err = (eager - ref).abs().max()
        assert err <= LOGIT_RTOL * ref.abs().max()
    else:
        assert _within_two_bf16_steps(eager, ref)


@pytest.mark.cuda
def test_use_mega_artifact_exported_on_the_card_launches_k7(card, tmp_path):
    """A tiny ``use_mega`` net exported for the card (``platforms=gpu``),
    saved, loaded and served: one K7 launch per forward and nothing else,
    its probabilities equal to the live program's bit for bit."""
    from plumekit_torch.config import InferConfig
    from plumekit_torch.infer import export
    from plumekit_torch.infer.sliding import make_multi_granule_infer

    cfg = UNetConfig(base_features=8, depth=2, use_mega=True)
    model = build_model(cfg, torch.Generator().manual_seed(4)).to(card)
    model.eval()
    icfg = InferConfig(tile_size=64, overlap=8, batch_tiles=2)
    programs, meta = export.export_sliding_infer(
        model, cfg, icfg, (96, 96), granules=2, platforms=["gpu"])
    assert meta["route"] == "mega"
    art = str(tmp_path / "artifact")
    export.save_exported(programs, meta, art)
    fn, _meta = export.load_exported(art, card)
    tree = export.serving_tree("mega", cfg, model, card)[0]
    images = torch.rand((2, 96, 96, 2), generator=torch.Generator()
                        .manual_seed(5)).to(card)
    live = make_multi_granule_infer(lambda m, x: m(x), icfg)
    with torch.inference_mode():
        before = (unet_mega.LAUNCHES, fused_conv.LAUNCHES)
        got = fn(tree, images)
        torch.cuda.synchronize()
        # 4 tiles a granule, 2 a batch: two forwards
        assert (unet_mega.LAUNCHES, fused_conv.LAUNCHES) == (before[0] + 2,
                                                             before[1])
        want = live(model, images)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_rg_identify_on_the_full_size_maiac_granule(card):
    """The committed 1200² MAIAC ``.hdf`` fixture through ``load_granule``
    (the port's HDF4 reader), then one ``rg.identify`` on the card (K1,
    K3) against the CPU: plume masks and integer columns bit for bit, the
    AOD mean and sd, summed on the device in another order, to rtol 1e-5
    (chip_smoke.py's FEATURE_RTOL)."""
    from plumekit_torch.identify import rg
    from plumekit_torch.io.granule import load_granule

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from tools.make_maiac_fixtures import FULL_NAME, OUT_DIR, full_scene

    g = load_granule(os.path.join(OUT_DIR, FULL_NAME + ".hdf"))
    fires = full_scene().fires
    args = (g.first_layer(), g.lat, g.lon, fires["date_time"][0], fires)
    ccl_sweep.LAUNCHES = label_counts.LAUNCHES = 0
    got = rg.identify(*args, device=card)
    torch.cuda.synchronize()
    assert ccl_sweep.LAUNCHES > 0 and label_counts.LAUNCHES > 0
    want = rg.identify(*args, device="cpu")
    assert len(got[0]) > 0, "no plume accepted"
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        assert a.columns == b.columns and len(a.rows) == len(b.rows)
        for j, col in enumerate(b.columns):
            x = np.asarray([r[j] for r in a.rows], dtype=object)
            y = np.asarray([r[j] for r in b.rows], dtype=object)
            if col in ("plume_aod_mean", "plume_aod_sd"):
                np.testing.assert_allclose(x.astype(float), y.astype(float),
                                           rtol=1e-5, atol=0)
            else:
                assert [str(v) for v in x] == [str(v) for v in y], col
    assert sorted(got[2]["plume_masks"]) == sorted(want[2]["plume_masks"])
    for pid, m in want[2]["plume_masks"].items():
        np.testing.assert_array_equal(got[2]["plume_masks"][pid], m)
