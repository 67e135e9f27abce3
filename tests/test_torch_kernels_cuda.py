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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    # the plain versions' fp32 convs in full fp32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    # fp32 compute: the card's kernel is bf16 only and the module raises, as
    # the fused double conv does; no other forward runs under the flag
    f32 = build_model(UNetConfig(base_features=8, depth=2, use_mega=True,
                                 compute_dtype="float32")).to(card).eval()
    f32.load_state_dict(model.state_dict())
    with torch.inference_mode(), pytest.raises(ValueError, match="bf16 only"):
        f32(x)
    with pytest.raises(ValueError, match="bf16 only"):
        unet_mega.make_mega_apply(f32.cfg)(f32, x)
    assert unet_mega.LAUNCHES == before[0] + 2


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
