"""The gaussian detector's two device ops in plumekit_torch against the JAX
package on the same numpy inputs: ``nearest_fill`` (jump flooding; the
filled image is equal bit for bit, since passes, neighbour order and the
strict compare are the same) and ``raster_cluster_centroids`` (integer
centroids and validity flags, equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.ops.cluster import raster_cluster_centroids as jax_centroids
from plumekit.ops.inpaint import nearest_fill as jax_fill
from plumekit_torch.ops import cluster
from plumekit_torch.ops.cluster import raster_cluster_centroids
from plumekit_torch.ops.inpaint import nearest_fill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_nulls(rng, shape):
    return rng.random(shape) < 0.3


def _null_blobs(rng, shape):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    mask = np.zeros(shape, bool)
    for _ in range(4):
        r, c = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        mask |= (yy - r) ** 2 + (xx - c) ** 2 < rng.uniform(4, 15) ** 2
    return mask


def _edges_valid_only(rng, shape):
    """Only a few border pixels are valid: seeds travel the whole image
    and wrapped candidates abound."""
    mask = np.ones(shape, bool)
    mask[0, 0] = mask[-1, -1] = mask[shape[0] // 2, -1] = False
    return mask


NULL_CASES = {
    "random": ((64, 64), _random_nulls),
    "blobs": ((96, 96), _null_blobs),
    "non_square": ((50, 131), _null_blobs),
    "tall": ((130, 37), _random_nulls),
    "edges_valid_only": ((40, 72), _edges_valid_only),
    "all_null": ((32, 48), lambda rng, shape: np.ones(shape, bool)),
    "no_null": ((32, 48), lambda rng, shape: np.zeros(shape, bool)),
}


@pytest.mark.parametrize("case", sorted(NULL_CASES))
def test_nearest_fill_bit_equal_to_jax(case):
    shape, make = NULL_CASES[case]
    rng = np.random.default_rng(len(case))
    image = rng.random(shape).astype(np.float32)
    nulls = make(rng, shape)
    image[nulls] = -999.0
    got = nearest_fill(torch.from_numpy(image), torch.from_numpy(nulls))
    want = np.asarray(jax_fill(jnp.asarray(image), jnp.asarray(nulls)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "all_null":
        np.testing.assert_array_equal(got.numpy(), image)
    elif case != "no_null":
        assert (got.numpy() != -999.0).all()


def _pad(rows, cols, capacity):
    r = np.zeros(capacity, np.int32)
    c = np.zeros(capacity, np.int32)
    v = np.zeros(capacity, bool)
    r[:len(rows)], c[:len(cols)], v[:len(rows)] = rows, cols, True
    return r, c, v


FIRE_CASES = {
    # a real fire at (0, 0) among padding slots, which also sit at (0, 0)
    "fire_at_origin": ([0, 0, 1, 20, 21, 22], [0, 1, 1, 30, 31, 30], 16),
    # clusters of 1 and 2 px fall under min_size = 3
    "small_clusters": ([5, 10, 10, 30, 31, 32, 33], [5, 20, 21, 40, 40, 41,
                                                     42], 8),
    # duplicate fires on one pixel count once in the raster
    "duplicates": ([12, 12, 12, 13, 14, 40], [12, 12, 12, 13, 14, 40], 8),
    "no_fire": ([], [], 8),
    "full_capacity": ([3, 4, 5, 6, 50, 51, 52, 60], [3, 3, 4, 5, 9, 9, 10,
                                                     60], 8),
}


@pytest.mark.parametrize("case", sorted(FIRE_CASES))
def test_raster_cluster_centroids_equal_jax(case):
    rows, cols, capacity = FIRE_CASES[case]
    r, c, v = _pad(rows, cols, capacity)
    shape = (64, 80)
    got = raster_cluster_centroids(shape, torch.from_numpy(r),
                                   torch.from_numpy(c), torch.from_numpy(v),
                                   3)
    want = jax_centroids(shape, jnp.asarray(r), jnp.asarray(c),
                         jnp.asarray(v), 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    if case == "fire_at_origin":
        # the three pixels about (0, 0) form a cluster that padding slots
        # must not erase: centroid int(1/3), int(2/3)
        assert got[2].numpy()[0] and got[0][0] == 0 and got[1][0] == 0
        assert int(got[2].sum()) == 2


def test_raster_cluster_centroids_do_not_depend_on_the_chunking(monkeypatch):
    rng = np.random.default_rng(5)
    rows = rng.integers(10, 20, 24).astype(np.int32)
    cols = rng.integers(10, 20, 24).astype(np.int32)
    args = [torch.from_numpy(a) for a in _pad(rows, cols, 32)]
    whole = raster_cluster_centroids((40, 40), *args, 3)
    monkeypatch.setattr(cluster, "CHUNK_ELEMENTS", 40 * 40 * 5)
    parts = raster_cluster_centroids((40, 40), *args, 3)
    assert int(whole[2].sum()) >= 1
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
