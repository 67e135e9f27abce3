"""The K3 entry of plumekit_torch (plain version on the CPU) against the
JAX Pallas kernel ``fire_label_counts`` in interpret mode. Counts are
integers: compared bit for bit. The CUDA kernel itself runs in
tests/test_torch_kernels_cuda.py and in chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.ops.pallas.label_counts import (
    fire_label_counts as jax_counts)
from plumekit_torch.ops.kernels import label_counts

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import (  # noqa: E402
    degenerate_label_count_case, label_count_case as _case)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,f", [
    ((3, 64, 64), 1), ((5, 100, 190), 16), ((2, 257, 129), 128),
    ((4, 37, 53), 16), ((1, 8, 128), 128), ((3, 61, 203), 5)])
def test_counts_bit_equal_to_pallas_interpret(shape, f):
    labels, labs = _case(shape, f, sum(shape) + f)
    got = label_counts.fire_label_counts(torch.from_numpy(labels),
                                         torch.from_numpy(labs))
    ref = jax_counts(jnp.asarray(labels), jnp.asarray(labs), interpret=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == labs.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["one_lab", "all_same", "all_zero"])
def test_degenerate_labs_bit_equal_to_pallas_interpret(kind):
    """F = 1; F = 128 copies of one lab; labs that are all 0."""
    labels, labs = degenerate_label_count_case(kind)
    got = label_counts.fire_label_counts(torch.from_numpy(labels),
                                         torch.from_numpy(labs))
    ref = jax_counts(jnp.asarray(labels), jnp.asarray(labs), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_counts_background_and_absent_labels():
    labels = np.zeros((1, 32, 200), np.int32)
    labels[0, :4, :10] = 7
    labs = np.array([[7, 0, 99, 7]], np.int32)
    got = label_counts.fire_label_counts(torch.from_numpy(labels),
                                         torch.from_numpy(labs))
    np.testing.assert_array_equal(got.numpy(),
                                  [[40, 32 * 200 - 40, 0, 40]])


def test_cpu_tensor_never_reaches_the_kernel(monkeypatch):
    import plumekit_torch.cuda_build as cuda_build

    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(label_counts, "_library", refuse)
    labels, labs = map(torch.from_numpy, _case((2, 16, 24), 4, 0))
    before = label_counts.LAUNCHES
    out = label_counts.fire_label_counts(labels, labs)
    assert torch.equal(out, label_counts.fire_label_counts_ref(labels, labs))
    assert label_counts.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device"):
        label_counts.fire_label_counts(labels.to("meta"), labs.to("meta"))

