"""``plumekit_torch/geo/distance.py`` and ``geo/sinusoidal.py`` against
``plumekit/geo`` on seeded random inputs: the haversine, both directions
of the sinusoidal projection (with the round trip), the off-lens NaN and
the granule grid, each bit for bit (numpy float64 on both sides). The JAX
package's ``parse_struct_metadata`` has no port (it parses HDF4 metadata);
``grid_indexes`` is held in ``tests/test_torch_small_ops.py``."""

import numpy as np
import pytest

from plumekit.geo import distance as jax_distance
from plumekit.geo import sinusoidal as jax_sinu
from plumekit_torch.geo import distance, sinusoidal


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _points(seed, n=2000):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n),
            rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))


@pytest.mark.parametrize("case", ["random", "near", "same", "antipodal",
                                  "scalar"])
def test_haversine_equals_the_jax_package(case):
    lon1, lat1, lon2, lat2 = _points(7)
    if case == "near":
        lon2, lat2 = lon1 + 1e-4, lat1 - 1e-4
    elif case == "same":
        lon2, lat2 = lon1, lat1
    elif case == "antipodal":
        lon2, lat2 = lon1 - 180.0, -lat1
    elif case == "scalar":
        lon1, lat1, lon2, lat2 = -0.1278, 51.5074, 2.3522, 48.8566
    got = distance.haversine_km(lon1, lat1, lon2, lat2)
    _same(got, jax_distance.haversine_km(lon1, lat1, lon2, lat2))
    if case == "same":
        assert (got == 0).all()
    if case == "scalar":
        assert 340 < float(got) < 348          # London to Paris
    assert distance.HAVERSINE_RADIUS_KM == jax_distance.HAVERSINE_RADIUS_KM


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinusoidal_both_ways_and_round_trip(seed):
    lon, lat, _, _ = _points(seed)
    lat = np.clip(lat, -89.0, 89.0)
    x, y = sinusoidal.wgs84_to_sinusoidal(lon, lat)
    for got, want in zip((x, y), jax_sinu.wgs84_to_sinusoidal(lon, lat)):
        _same(got, want)
    back = sinusoidal.sinusoidal_to_wgs84(x, y)
    for got, want in zip(back, jax_sinu.sinusoidal_to_wgs84(x, y)):
        _same(got, want)
    np.testing.assert_allclose(back[0], lon, atol=1e-9)
    np.testing.assert_allclose(back[1], lat, atol=1e-9)
    assert sinusoidal.SINU_RADIUS_M == jax_sinu.SINU_RADIUS_M


@pytest.mark.parametrize("where", ["beyond_pole", "beyond_parallel",
                                   "random_plane"])
def test_off_lens_points_are_nan_as_in_the_jax_package(where):
    r = sinusoidal.SINU_RADIUS_M
    rng = np.random.default_rng(3)
    if where == "beyond_pole":
        x = rng.uniform(-1e6, 1e6, 50)
        y = r * (np.pi / 2 + rng.uniform(1e-3, 0.5, 50)) * rng.choice(
            [-1.0, 1.0], 50)
    elif where == "beyond_parallel":
        y = r * np.deg2rad(rng.uniform(80.0, 89.9999, 50))
        x = r * np.pi * np.cos(y / r) * rng.uniform(1.01, 3.0, 50)
    else:
        x = rng.uniform(-2.1e7, 2.1e7, 2000)
        y = rng.uniform(-1.1e7, 1.1e7, 2000)
    lon, lat = sinusoidal.sinusoidal_to_wgs84(x, y)
    jlon, jlat = jax_sinu.sinusoidal_to_wgs84(x, y)
    _same(lon, jlon)
    _same(lat, jlat)
    if where != "random_plane":
        assert np.isnan(lon).all()
    else:
        assert np.isnan(lon).any() and np.isfinite(lon).any()
        assert (np.abs(lon[np.isfinite(lon)]) <= 180.0 + 1e-9).all()


@pytest.mark.parametrize("corners,shape", [
    ((-60.0, -20.0, -50.0, -30.0), (120, 120)),
    ((-75.0, 5.0, -64.0, -5.0), (64, 96)),
    ((100.0, 79.0, 130.0, 70.0), (33, 17))])
def test_granule_grid_equals_the_jax_package(corners, shape):
    x0, y0 = sinusoidal.wgs84_to_sinusoidal(corners[0], corners[1])
    x1, y1 = sinusoidal.wgs84_to_sinusoidal(corners[2], corners[3])
    got = sinusoidal.grid_from_extent(x0, y0, x1, y1, *shape)
    want = jax_sinu.grid_from_extent(x0, y0, x1, y1, *shape)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].shape == shape
    assert np.all(np.diff(got[0][:, 0]) < 0)       # lat falls down the rows
