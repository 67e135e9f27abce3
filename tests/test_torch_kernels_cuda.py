"""The CUDA kernels K1/K4 and K2 (multi-threshold CCL), K3 (label counts)
and K6 (fused double conv) against their plain PyTorch versions on the
card: labels and counts are integers, so equal bit for bit; K6 rounds to
bf16 from fp32 sums in another order, so two bf16 steps (2^-6 absolute
plus 2^-6 relative). Every test here needs a card and skips
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

from plumekit_torch.models.kernels import fused_conv
from plumekit_torch.ops.kernels import ccl_sweep, label_counts

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import (CASES, MASK_CASES, double_conv_case,  # noqa: E402
                             label_count_case)

BF16_ATOL = BF16_RTOL = 2.0 ** -6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
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
    labels = torch.zeros((2, 8, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="capacity"):
        label_counts.fire_label_counts(
            labels, torch.zeros((2, 129), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="labs"):
        label_counts.fire_label_counts(
            labels, torch.zeros((3, 4), dtype=torch.int32, device=card))
