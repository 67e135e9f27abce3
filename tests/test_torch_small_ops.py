"""The small functions of ``plumekit/`` that the port took last, against
the JAX package on seeded inputs with their reference's test cases
(``tests/test_ops_morphology_ccl.py``, ``test_ops_signal_geom.py``):
``ops/ccl``'s warm start, host labelling, component sizes and small-
component removal, ``ops/segment.window_distance_matrix``,
``ops/geometry.points_in_convex_hull`` and ``geo/distance.grid_indexes``,
integer and boolean outputs bit for bit. Then ``ops/transect`` directly
against ``plumekit/ops/transect.py`` (until now held only end to end by
the rg and gaussian parity tests), with the tolerances ROADMAP §C
measured: 1e-5 for smoothing, equal peak counts, 6e-6 for samples."""

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.signal import find_peaks
from scipy.spatial import ConvexHull, Delaunay

import jax
import jax.numpy as jnp

from plumekit.geo import distance as jax_distance
from plumekit.ops import ccl as jax_ccl
from plumekit.ops import geometry as jax_geometry
from plumekit.ops import segment as jax_segment
from plumekit.ops import transect as jax_transect
from plumekit_torch.geo import distance
from plumekit_torch.ops import ccl, geometry, segment, transect

SMOOTH_TOL = 1e-5
SAMPLE_TOL = 6e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _field(seed, size=96):
    field = np.random.default_rng(seed).random((size, size)).astype(
        np.float32)
    return np.maximum(field, np.roll(field, 1, 0))   # correlated-ish


@pytest.mark.parametrize("connectivity", [1, 2])
def test_warm_start_equals_the_cold_labelling_and_the_jax_package(
        connectivity):
    """A tighter threshold's labels seed the looser mask: the cold labels
    (the unique fixpoint), bit for bit the JAX package's warm start; an
    all-zero start is the cold path."""
    field = _field(connectivity)
    tight, loose = field > 0.7, field > 0.35
    lbl_tight = ccl.connected_components(torch.from_numpy(tight),
                                         connectivity)
    cold = ccl.connected_components(torch.from_numpy(loose), connectivity)
    warm = ccl.connected_components(torch.from_numpy(loose), connectivity,
                                    init_labels=lbl_tight)
    jwarm = jax_ccl.connected_components(
        jnp.asarray(loose), connectivity,
        init_labels=jnp.asarray(lbl_tight.numpy()))
    _same(warm, cold)
    _same(warm, jwarm)
    _same(ccl.connected_components(
        torch.from_numpy(loose), connectivity,
        init_labels=torch.zeros(loose.shape, dtype=torch.int32)), cold)


def test_warm_start_from_labels_above_a_pixel_id_still_converges():
    """A start that names a pixel of the component with a larger id than
    the pixel's own (no tighter labelling gives one) keeps the pointers a
    forest: the cold labels."""
    m = np.zeros((6, 6), bool)
    m[1, 1:5] = m[2:5, 4] = True
    mask = torch.from_numpy(m)
    cold = ccl.connected_components(mask)
    init = torch.where(mask, 4 * 6 + 4 + 1, 0).to(torch.int32)
    _same(ccl.connected_components(mask, init_labels=init), cold)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_connected_components_host_equals_the_jax_package(connectivity):
    m = np.random.default_rng(4).random((32, 32)) < 0.4
    _same(ccl.connected_components_host(m, connectivity),
          jax_ccl.connected_components_host(m, connectivity))


def test_connected_components_host_takes_the_native_ccl(monkeypatch):
    """The host labelling is the native library's, on any nonzero mask
    (here soft float values, which scipy takes as foreground too)."""
    from plumekit_torch import native

    m = np.random.default_rng(6).random((24, 28)).astype(np.float32)
    m[m < 0.6] = 0.0
    calls = []
    real = native.ccl_label
    monkeypatch.setattr(native, "ccl_label",
                        lambda *a: calls.append(a[1]) or real(*a))
    _same(ccl.connected_components_host(m, 1),
          jax_ccl.connected_components_host(m, 1))
    assert calls == [1]


def test_component_sizes_and_remove_small_equal_the_jax_package():
    m = np.random.default_rng(5).random((40, 40)) < 0.3
    lbl = ccl.connected_components(torch.from_numpy(m))
    jlbl = jnp.asarray(lbl.numpy())
    sizes = ccl.component_sizes(lbl)
    _same(sizes, jax_ccl.component_sizes(jlbl))
    ref, n = ndimage.label(m, structure=np.ones((3, 3)))
    assert sorted(int(sizes[v]) for v in np.unique(lbl.numpy()) if v) == \
        sorted(np.bincount(ref.ravel())[1:].tolist())
    for min_size in (1, 5, 40):
        _same(ccl.remove_small_components(lbl, min_size),
              jax_ccl.remove_small_components(jlbl, min_size))


@pytest.mark.parametrize("win_half", [0, 7, 15])
def test_window_distance_matrix_equals_the_jax_package(win_half):
    _same(segment.window_distance_matrix(win_half),
          jax_segment.window_distance_matrix(win_half))


def test_points_in_convex_hull_equals_the_jax_package():
    """The JAX package's Delaunay case (30 points, hull padded to 16 with
    its last vertex) and both windings, in float32 as JAX computes."""
    rng = np.random.default_rng(6)
    pts = rng.random((30, 2)) * 20
    verts = pts[ConvexHull(pts).vertices].astype(np.float32)
    padded = np.zeros((16, 2), np.float32)
    padded[:len(verts)] = verts
    padded[len(verts):] = verts[-1]
    queries = (rng.random((200, 2)) * 24 - 2).astype(np.float32)
    for hull in (padded, np.concatenate([verts[::-1], padded[len(verts):]])):
        got = geometry.points_in_convex_hull(
            torch.from_numpy(queries), torch.from_numpy(hull), len(verts))
        _same(got, jax_geometry.points_in_convex_hull(
            jnp.asarray(queries), jnp.asarray(hull), len(verts)))
    ref = Delaunay(verts).find_simplex(queries) >= 0
    assert (got.numpy() != ref).mean() < 0.02


def test_points_in_a_degenerate_hull_are_outside():
    queries = torch.from_numpy(np.random.default_rng(7).random((50, 2)) * 10)
    for n_valid in (0, 1, 2):
        assert not geometry.points_in_convex_hull(
            queries, torch.zeros((8, 2), dtype=torch.float64), n_valid).any()


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (64, 33)])
def test_grid_indexes_equal_the_jax_package(shape):
    for got, want in zip(distance.grid_indexes(shape),
                         jax_distance.grid_indexes(shape)):
        _same(got, want)


# --------------------------------------------------------------- transects

def _runs(rng, n_rows, n, min_len=1):
    """Rows of random values, each with one contiguous valid run."""
    values = rng.normal(size=(n_rows, n)).astype(np.float32)
    valid = np.zeros((n_rows, n), bool)
    for i in range(n_rows):
        length = int(rng.integers(min_len, n + 1))
        start = int(rng.integers(0, n - length + 1))
        valid[i, start:start + length] = True
    return values, valid


@pytest.mark.parametrize("window,polyorder", [(11, 3), (5, 2), (21, 4)])
def test_savgol_smooth_equals_the_jax_package(window, polyorder):
    values, valid = _runs(np.random.default_rng(window), 100, 64)
    got, ok = transect.savgol_smooth(torch.from_numpy(values),
                                     torch.from_numpy(valid), window,
                                     polyorder)
    jfn = jax.vmap(lambda v, m: jax_transect.savgol_smooth(v, m, window,
                                                           polyorder))
    want, jok = jfn(jnp.asarray(values), jnp.asarray(valid))
    _same(ok, jok)
    ok = ok.numpy()
    assert ok.any() and not ok.all()
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[ok][valid[ok]], want[ok][valid[ok]],
                               rtol=0, atol=SMOOTH_TOL)


@pytest.mark.parametrize("flat_tol", [0.0, 1e-3])
def test_count_peaks_masked_equals_the_jax_package(flat_tol):
    rng = np.random.default_rng(8)
    values = np.round(rng.normal(size=(100, 50)), 2).astype(np.float32)
    valid = rng.random((100, 50)) < 0.7
    got = transect.count_peaks_masked(
        torch.from_numpy(values), torch.from_numpy(valid),
        torch.full((100,), flat_tol))
    want = jax.vmap(lambda v, m: jax_transect.count_peaks_masked(
        v, m, flat_tol))(jnp.asarray(values), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if flat_tol == 0.0:
        assert got.tolist() == [len(find_peaks(v[m])[0])
                                for v, m in zip(values, valid)]


def test_line_transect_in_mask_equals_the_jax_package():
    rng = np.random.default_rng(9)
    h, w, n, samples = 64, 80, 50, 200
    aod = rng.random((h, w)).astype(np.float32)
    masks = rng.random((n, h, w)) < 0.6
    min_r = rng.integers(0, h // 2, n).astype(np.float32)
    max_r = min_r + rng.integers(2, h // 2, n)
    min_c = rng.integers(0, w // 2, n).astype(np.float32)
    max_c = min_c + rng.integers(2, w // 2 + 1, n)   # may reach W
    slope = rng.normal(size=n).astype(np.float32)
    intercept = (rng.random(n) * h).astype(np.float32)
    args = [a.astype(np.float32) for a in (slope, intercept, min_r, min_c,
                                           max_r, max_c)]
    got, gvalid = transect.line_transect_in_mask(
        torch.from_numpy(aod), torch.from_numpy(masks),
        *map(torch.from_numpy, args), n_samples=samples)
    jfn = jax.vmap(lambda m, *a: jax_transect.line_transect_in_mask(
        jnp.asarray(aod), m, *a, n_samples=samples))
    want, wvalid = jfn(jnp.asarray(masks), *map(jnp.asarray, args))
    _same(gvalid, wvalid)
    assert gvalid.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SAMPLE_TOL)
