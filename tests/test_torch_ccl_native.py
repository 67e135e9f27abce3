"""The port's plain ``ops/ccl.connected_components`` against the JAX
package's host library, ``plumekit.native.ccl_label`` (a two-pass
union-find in ``plumekit/native/ccl.cpp``): random masks at three densities
and both connectivities, 64² to 256². The two number components
differently (smallest pixel id + 1 against 1..n in scan order), so both
sides are relabelled to the smallest pixel id of each component and the
partitions compared. ``ccl_label`` falls back to scipy when the library
cannot be built, so the test checks ``native.available()`` first and skips
without it."""

import numpy as np
import pytest
import torch

from plumekit import native
from plumekit_torch.ops.ccl import connected_components


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def library():
    if not native.available():
        pytest.skip("the native host library could not be built or loaded")


def smallest_id_form(labels):
    """Each nonzero label replaced by its component's smallest flat pixel
    id + 1: the contract's form, whatever numbering came in."""
    flat = labels.ravel()
    out = np.zeros(flat.shape, np.int64)
    fg = np.flatnonzero(flat)
    if fg.size:
        # the first occurrence of a label in raster order is its smallest id
        _, first = np.unique(flat[fg], return_index=True)
        smallest = dict(zip(flat[fg][first], fg[first] + 1))
        out[fg] = [smallest[v] for v in flat[fg]]
    return out.reshape(labels.shape)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("density", [0.3, 0.55, 0.75])
@pytest.mark.parametrize("shape", [(64, 64), (131, 97), (256, 256)])
def test_partition_equals_native_ccl(library, shape, density, connectivity):
    rng = np.random.default_rng(shape[0] * 7 + int(density * 100)
                                + connectivity)
    mask = rng.random(shape) < density
    ours = connected_components(torch.from_numpy(mask),
                                connectivity).numpy()
    theirs, n = native.ccl_label(mask, connectivity)
    assert len(np.unique(ours[ours > 0])) == n
    np.testing.assert_array_equal(ours, smallest_id_form(theirs))
    # the port's labels are already in that form
    np.testing.assert_array_equal(ours, smallest_id_form(ours))
