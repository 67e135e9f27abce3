"""The K2 entry of plumekit_torch (``multi_threshold_ccl``, plain version
on the CPU) against the JAX Pallas kernel ``multi_threshold_ccl`` in
interpret mode and against ``plumekit.ops.ccl.connected_components``, on
the mask stacks of tests/test_ops_pallas_ccl.py, and against the port's K1
entry on the opened threshold masks. Labels are integers: compared bit for
bit. The CUDA kernel itself runs in tests/test_torch_kernels_cuda.py
(kernel against plain version) and in chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.ops.ccl import connected_components as jax_cc
from plumekit.ops.pallas.ccl_sweep import multi_threshold_ccl as jax_masks
from plumekit_torch.ops.kernels import ccl_sweep
from plumekit_torch.ops.morphology import binary_opening_cross

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import CASES, MASK_CASES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_entry_bit_equal_to_pallas_interpret(case, connectivity):
    stack, nested = MASK_CASES[case]()
    got = ccl_sweep.multi_threshold_ccl(torch.from_numpy(stack),
                                        connectivity, nested=nested)
    ref = np.asarray(jax_masks(jnp.asarray(stack), block=16,
                               connectivity=connectivity, nested=nested,
                               interpret=True))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_entry_bit_equal_to_jax_connected_components(case):
    stack, nested = MASK_CASES[case]()
    got = ccl_sweep.multi_threshold_ccl(torch.from_numpy(stack),
                                        nested=nested).numpy()
    for t in range(stack.shape[0]):
        np.testing.assert_array_equal(
            got[t], np.asarray(jax_cc(jnp.asarray(stack[t]),
                                      connectivity=2)))


@pytest.mark.parametrize("case", ["nested_noise", "percolation",
                                  "width_128", "serpentine",
                                  "ragged_97x131"])
def test_entry_on_opened_masks_equals_the_fused_entry(case):
    """K2 on ``binary_opening_cross(aod > th)`` is K1 on the raw AOD."""
    field, ths = CASES[case]()
    aod, th = torch.from_numpy(field), torch.from_numpy(ths)
    opened = binary_opening_cross(aod[None] > th[:, None, None])
    assert torch.equal(ccl_sweep.multi_threshold_ccl(opened),
                       ccl_sweep.multi_threshold_ccl_fused(aod, th))


def test_nested_flag_changes_nothing():
    stack, _ = MASK_CASES["independent"]()
    masks = torch.from_numpy(stack)
    assert torch.equal(ccl_sweep.multi_threshold_ccl(masks, nested=True),
                       ccl_sweep.multi_threshold_ccl(masks, nested=False))


def test_entry_refuses_what_it_does_not_label():
    masks = torch.zeros((2, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="bool"):
        ccl_sweep.multi_threshold_ccl(masks.to(torch.uint8))
    with pytest.raises(ValueError, match="bool"):
        ccl_sweep.multi_threshold_ccl(masks[0])
    with pytest.raises(ValueError, match="connectivity"):
        ccl_sweep.multi_threshold_ccl(masks, connectivity=3)


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """A CPU stack takes the plain version and is not counted as a launch;
    a stack on any other non-CUDA device is refused."""
    import plumekit_torch.cuda_build as cuda_build

    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(ccl_sweep, "_library", refuse)
    stack, _ = MASK_CASES["edge_masks"]()
    masks = torch.from_numpy(stack)
    before = ccl_sweep.MASK_LAUNCHES, ccl_sweep.LAUNCHES
    out = ccl_sweep.multi_threshold_ccl(masks)
    assert torch.equal(out, ccl_sweep.multi_threshold_ccl_masks_ref(masks))
    assert (ccl_sweep.MASK_LAUNCHES, ccl_sweep.LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ccl_sweep.multi_threshold_ccl(masks.to("meta"))


def test_loaded_library_is_returned_without_hashing_its_source(monkeypatch):
    """Every launch asks the loader for its library: once loaded, that
    must cost a dictionary lookup, not a read and a hash of the source."""
    import plumekit_torch.cuda_build as cuda_build

    def refuse(*a, **k):
        raise AssertionError("the source was hashed again")

    lib = object()
    monkeypatch.setitem(cuda_build._LOADED, "ccl_sweep.cu", lib)
    monkeypatch.setattr(cuda_build, "_lib_path", refuse)
    assert cuda_build.load_library("ccl_sweep.cu") is lib
    assert cuda_build.load_libraries(["ccl_sweep.cu"]) == {
        "ccl_sweep.cu": lib}
