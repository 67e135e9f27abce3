"""plumekit_torch.ops.morphology and .ccl against the JAX package's ops on
the same numpy masks (the cases of tests/test_ops_morphology_ccl.py).
Morphology and labels are compared bit for bit: both are integer
results."""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from plumekit.ops import ccl as jax_ccl
from plumekit.ops import morphology as jax_morph
from plumekit_torch.ops import morphology
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


CROSS = ndimage.generate_binary_structure(2, 1)


def _masks(seed, n=4, shape=(64, 64), p=0.35):
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(shape) < p for _ in range(n)])


@pytest.mark.parametrize("op", ["binary_erosion", "binary_dilation",
                                "binary_opening_cross"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 53)])
def test_morphology_matches_jax_batched(op, shape):
    """Cross-footprint ops over a (4, H, W) batch, skimage border values
    (erosion pads True, dilation pads False)."""
    ms = _masks(1, shape=shape)
    got = getattr(morphology, op)(torch.from_numpy(ms)).numpy()
    ref = np.asarray(getattr(jax_morph, op)(jnp.asarray(ms)))
    np.testing.assert_array_equal(got, ref)


def test_erosion_and_opening_match_scipy_borders():
    m = _masks(2, n=1)[0]
    ero = morphology.binary_erosion(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(
        ero, ndimage.binary_erosion(m, structure=CROSS, border_value=1))
    opened = morphology.binary_opening_cross(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(opened, ndimage.binary_dilation(
        ndimage.binary_erosion(m, structure=CROSS, border_value=1),
        structure=CROSS, border_value=0))


@pytest.mark.parametrize("size", [3, 5])
def test_dilation_square_matches_jax(size):
    ms = _masks(3, n=2, p=0.05)
    got = morphology.binary_dilation_square(torch.from_numpy(ms), size)
    ref = jax_morph.binary_dilation_square(jnp.asarray(ms), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="odd"):
        morphology.binary_dilation_square(torch.from_numpy(ms), 4)


def _snake():
    m = np.zeros((32, 32), dtype=bool)
    m[0, :] = True
    m[:, -1] = True
    m[-1, :] = True
    m[::2, 0] = False
    m[16, 1:-1] = True
    return m


def _spiral():
    m = np.zeros((64, 64), dtype=bool)
    m[32, 32] = True
    step, dr, dc = 1, 0, 1
    pos = np.array([32, 32])
    for leg in range(20):
        for _ in range(step):
            pos = pos + [dr, dc]
            if 0 <= pos[0] < 64 and 0 <= pos[1] < 64:
                m[pos[0], pos[1]] = True
        dr, dc = dc, -dr
        if leg % 2 == 1:
            step += 2
    return m


def _pathological(case):
    m = np.zeros((40, 40), dtype=bool)
    if case == "ring":
        m[5:35, 5:35] = True
        m[10:30, 10:30] = False
    elif case == "checker":
        m[::2, ::2] = True
        m[1::2, 1::2] = True
    elif case == "row":
        m[20, 1:39] = True
    elif case == "col":
        m[1:39, 20] = True
    elif case == "cross":
        m[20, :] = True
        m[:, 20] = True
    elif case == "empty":
        pass
    elif case == "full":
        m[:] = True
    return m


def _serpentine(h=48, w=96):
    s = np.zeros((h, w), bool)
    s[::2, :] = True
    for i in range(0, h - 2, 2):
        s[i + 1, 0 if (i // 2) % 2 == 0 else w - 1] = True
    return s


CASES = {
    **{f"random_p{p}": (lambda p=p: np.random.default_rng(int(p * 10))
                        .random((48, 61)) < p) for p in (0.2, 0.5, 0.7)},
    "snake": _snake, "spiral": _spiral, "serpentine": _serpentine,
    **{c: (lambda c=c: _pathological(c))
       for c in ("ring", "checker", "row", "col", "cross", "empty", "full")},
}


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ccl_bit_equal_to_jax(case, connectivity):
    """Labels equal the JAX op's: 0 background, smallest flat id + 1."""
    m = CASES[case]()
    got = connected_components(torch.from_numpy(m), connectivity)
    ref = jax_ccl.connected_components(jnp.asarray(m), connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ccl_partition_matches_scipy():
    m = np.random.default_rng(4).random((64, 80)) < 0.45
    got = connected_components(torch.from_numpy(m), 2).numpy()
    ref, n = ndimage.label(m, structure=np.ones((3, 3)))
    assert len(np.unique(got[got > 0])) == n
    pairs = set(zip(got[m].tolist(), ref[m].tolist()))
    assert len(pairs) == n


def test_ccl_rejects_bad_input():
    with pytest.raises(ValueError, match="bool"):
        connected_components(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="connectivity"):
        connected_components(torch.zeros((4, 4), dtype=torch.bool), 3)
