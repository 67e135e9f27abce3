"""The K1/K4 entries of plumekit_torch (plain version on the CPU) against
the JAX Pallas kernels ``multi_threshold_ccl_fused`` and
``multi_threshold_ccl_banded`` in interpret mode, on the cases of
tests/test_ops_pallas_ccl.py and tests/test_ops_pallas_ccl_banded.py.
Labels are integers: compared bit for bit. The CUDA kernel itself runs in
tests/test_torch_kernels_cuda.py (kernel against plain version) and in
chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.ops.pallas.ccl_banded import (
    multi_threshold_ccl_banded as jax_banded)
from plumekit.ops.pallas.ccl_sweep import (
    multi_threshold_ccl_fused as jax_fused)
from plumekit_torch.ops.kernels import ccl_sweep

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import CASES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENTRIES = {
    "fused": (ccl_sweep.multi_threshold_ccl_fused,
              lambda a, t, c: jax_fused(a, t, connectivity=c, block=16,
                                        interpret=True)),
    "banded": (ccl_sweep.multi_threshold_ccl_banded,
               lambda a, t, c: jax_banded(a, t, connectivity=c, block=16,
                                          interpret=True)),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_bit_equal_to_pallas_interpret(case, entry):
    field, ths = CASES[case]()
    port, jax_fn = ENTRIES[entry]
    got = port(torch.from_numpy(field), torch.from_numpy(ths))
    ref = np.asarray(jax_fn(jnp.asarray(field), jnp.asarray(ths), 2))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_four_connectivity_bit_equal_to_pallas_interpret():
    field, ths = CASES["nested_noise"]()
    got = ccl_sweep.multi_threshold_ccl_fused(
        torch.from_numpy(field), torch.from_numpy(ths), connectivity=1)
    ref = jax_fused(jnp.asarray(field), jnp.asarray(ths), connectivity=1,
                    block=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_cross_lattice_four_connectivity_bit_equal_to_pallas_interpret(entry):
    """Crosses that touch only diagonally: one label per cross under
    4-connectivity."""
    field, ths = CASES["cross_lattice"]()
    port, jax_fn = ENTRIES[entry]
    got = port(torch.from_numpy(field), torch.from_numpy(ths), 1)
    ref = np.asarray(jax_fn(jnp.asarray(field), jnp.asarray(ths), 1))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(got.numpy())) > 1000


def test_nan_pixels_never_enter_a_mask():
    """NaN compares False with every threshold, as on the TPU where the
    kernel's -1e30 padding must never enter a mask either."""
    field, ths = CASES["percolation"]()
    field = field.copy()
    field[40:50, 60:70] = np.nan
    got = ccl_sweep.multi_threshold_ccl_fused(torch.from_numpy(field),
                                              torch.from_numpy(ths))
    assert not got.numpy()[:, 40:50, 60:70].any()
    ref = jax_fused(jnp.asarray(field), jnp.asarray(ths), block=16,
                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version and is not counted as a
    launch; a tensor on any other non-CUDA device is refused."""
    import plumekit_torch.cuda_build as cuda_build

    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(ccl_sweep, "_library", refuse)
    field, ths = CASES["degenerate_levels"]()
    aod, th = torch.from_numpy(field), torch.from_numpy(ths)
    before = ccl_sweep.LAUNCHES
    out = ccl_sweep.multi_threshold_ccl_fused(aod, th)
    assert torch.equal(out, ccl_sweep.multi_threshold_ccl_ref(aod, th))
    assert ccl_sweep.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device"):
        ccl_sweep.multi_threshold_ccl_fused(aod.to("meta"), th.to("meta"))

