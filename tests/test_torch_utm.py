"""``plumekit_torch/geo/utm.py`` against ``plumekit/geo/utm.py``: the
projection, the modal zone and the resampler's gather plans on the same
inputs, bit for bit (both sides are numpy float64; the port queries the
kd-tree on every core, which must not change a single index).

The JAX package's own cases (``tests/test_geo.py``,
``tests/test_real_data_contracts.py``, ``tests/test_viirs_aod.py``) run
here against the port as well.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from plumekit.geo import utm as jax_utm
from plumekit.io.viirs import make_synthetic_swath as jax_swath
from plumekit_torch.geo.utm import UTMProjection, UTMResampler, utm_zone_of


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _regular(lat0, lon_west, lat_span, lon_span, n=40):
    lats = lat0 + np.linspace(0.0, lat_span, n)
    lons = lon_west + np.linspace(0.0, lon_span, n)
    lon_g, lat_g = np.meshgrid(lons, lats)
    return lat_g, (lon_g + 180.0) % 360.0 - 180.0


def _same(a, b):
    """Bit-for-bit equality of two numpy results (NaN equal to NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_plan(port, ref):
    assert (port.zone, port.south) == (ref.zone, ref.south)
    assert (port.x_size, port.y_size) == (ref.x_size, ref.y_size)
    assert tuple(map(float, port.extent)) == tuple(map(float, ref.extent))
    assert (port.cell_x, port.cell_y) == (ref.cell_x, ref.cell_y)
    assert port.pixel_size == ref.pixel_size
    _same(port.valid, ref.valid)
    _same(port.index_map, ref.index_map)
    for got, want in zip(port.lonlats(), ref.lonlats()):
        _same(got, want)


# ------------------------------------------------------------- projection

@pytest.mark.parametrize("zone,south", [(1, False), (21, True), (31, False),
                                        (33, False), (60, True)])
def test_forward_and_inverse_equal_the_jax_package(zone, south):
    rng = np.random.default_rng(zone)
    lon0 = -183.0 + 6.0 * zone
    lon = lon0 + rng.uniform(-4.0, 4.0, 500)
    lat = rng.uniform(-80.0, -1.0, 500) if south else rng.uniform(
        1.0, 80.0, 500)
    port, ref = UTMProjection(zone, south), jax_utm.UTMProjection(zone, south)
    east, north = port.forward(lon, lat)
    for got, want in zip((east, north), ref.forward(lon, lat)):
        _same(got, want)
    for got, want in zip(port.inverse(east, north),
                         ref.inverse(east, north)):
        _same(got, want)
    assert port.central_meridian_deg == ref.central_meridian_deg
    assert port.false_northing == ref.false_northing


def test_known_point_and_round_trip():
    proj = UTMProjection(zone=31, south=False)
    e, n = proj.forward(3.0, 0.0)
    assert abs(e - 500000.0) < 1e-3 and abs(n) < 1e-3
    lons, lats = np.meshgrid(np.linspace(0.5, 5.5, 7), np.linspace(-70, 70, 7))
    lon2, lat2 = proj.inverse(*proj.forward(lons, lats))
    np.testing.assert_allclose(lon2, lons, atol=1e-6)
    np.testing.assert_allclose(lat2, lats, atol=1e-6)


def test_antimeridian_round_trip_stays_wrapped():
    proj = UTMProjection(zone=60, south=True)
    lons = np.array([178.5, 179.9, -179.9, -178.5])
    lats = np.full(4, -41.0)
    lon2, lat2 = proj.inverse(*proj.forward(lons, lats))
    np.testing.assert_allclose(lon2, lons, atol=1e-6)
    np.testing.assert_allclose(lat2, lats, atol=1e-6)
    for got, want in zip(proj.forward(lons, lats),
                         jax_utm.UTMProjection(60, True).forward(lons, lats)):
        _same(got, want)


@pytest.mark.parametrize("lons,zone", [
    ([-60.0, -60.2, -59.8], 21), ([0.5], 31), ([181.0], 1), ([-181.0], 60),
    ([179.999], 60), ([11.9, 12.1, 12.2], 33), ([-180.0, 179.0, 179.5], 60)])
def test_modal_zone_and_its_wrap(lons, zone):
    assert utm_zone_of(np.array(lons)) == zone
    assert utm_zone_of(np.array(lons)) == jax_utm.utm_zone_of(np.array(lons))


# --------------------------------------------------------------- the plan

def _swath_case(name):
    """(lats, lons, pixel_size, kwargs) of one resampler case."""
    if name in ("swath0", "swath1", "swath2"):
        seed = int(name[-1])
        sw = jax_swath(lines=96, samples=128, seed=seed,
                       center_lat=(-10.0, 46.0, 60.0)[seed],
                       center_lon=(-60.0, 11.8, 100.0)[seed],
                       track_azimuth_deg=(15.0, -20.0, 190.0)[seed])
        return sw.lat, sw.lon, 750.0, {}
    if name == "swath_masked":
        sw = jax_swath(lines=96, samples=128, seed=5)
        rng = np.random.default_rng(5)
        valid = rng.random(sw.shape) > 0.3
        valid[:6] = False                       # a fill stripe
        lat, lon = sw.lat.copy(), sw.lon.copy()
        lat[:2], lon[:2] = -999.3, -999.3       # geolocation fills
        return lat, lon, 750.0, {"source_valid": valid}
    if name == "identity_grid":
        lat, lon = np.meshgrid(np.linspace(-10.2, -10.0, 24),
                               np.linspace(-60.2, -60.0, 24), indexing="ij")
        return lat, lon, 1000.0, {}
    if name == "antimeridian":
        lat, lon = _regular(-42.0, 179.0, 2.0, 2.0)
        return lat, lon, 2000.0, {}
    if name == "zone_boundary":
        lat, lon = _regular(46.0, 11.2, 1.5, 1.6)
        return lat, lon, 2000.0, {}
    if name == "radius_small":
        sw = jax_swath(lines=48, samples=64, seed=7)
        return sw.lat, sw.lon, 500.0, {"radius_of_influence": 600.0}
    lat, lon = np.mgrid[40:41:32j, -3:-2:32j]
    if name == "degenerate":
        return (np.full((6, 6), -999.3), np.full((6, 6), -999.3), 750.0,
                {"source_valid": np.zeros((6, 6), bool)})
    valid = np.zeros(lat.shape, bool)
    valid[16, 16] = True
    if name == "near_degenerate_one":
        return lat, lon, 750.0, {"source_valid": valid}
    valid[16, 17] = True
    return lat, lon, 75000.0, {"source_valid": valid}   # near_degenerate_two


CASES = ["swath0", "swath1", "swath2", "swath_masked", "identity_grid",
         "antimeridian", "zone_boundary", "radius_small", "degenerate",
         "near_degenerate_one", "near_degenerate_two"]


@pytest.mark.parametrize("name", CASES)
def test_resampler_plan_equals_the_jax_package(name):
    lat, lon, px, kw = _swath_case(name)
    port = UTMResampler(lat, lon, px, **kw)
    _same_plan(port, jax_utm.UTMResampler(lat, lon, px, **kw))
    assert port.index_map.dtype == np.int32 and port.valid.dtype == bool
    assert port.x_size >= 1 and port.y_size >= 1
    assert np.isfinite(port.cell_x) and np.isfinite(port.cell_y)


@pytest.mark.parametrize("name", ["swath0", "swath_masked", "antimeridian",
                                  "degenerate", "near_degenerate_one"])
@pytest.mark.parametrize("fill", [-999.0, np.nan])
def test_resample_image_numpy_and_torch(name, fill):
    lat, lon, px, kw = _swath_case(name)
    port = UTMResampler(lat, lon, px, **kw)
    ref = jax_utm.UTMResampler(lat, lon, px, **kw)
    img = np.random.default_rng(1).random(lat.shape).astype(np.float32)
    got = port.resample_image(img, fill_value=fill)
    _same(got, ref.resample_image(img, fill_value=fill))
    assert got.dtype == np.float32
    on_torch = port.resample_image(torch.from_numpy(img), fill_value=fill)
    assert isinstance(on_torch, torch.Tensor)
    assert on_torch.dtype == torch.float32
    _same(on_torch.numpy(), got)


def test_plan_is_brute_force_nearest_across_the_antimeridian():
    lat, lon, px, kw = _swath_case("antimeridian")
    rs = UTMResampler(lat, lon, px, **kw)
    assert rs.zone in (1, 60)
    ew_km = (rs.extent[2] - rs.extent[0]) / 1e3
    ns_km = (rs.extent[3] - rs.extent[1]) / 1e3
    assert 100 < ew_km < 400 and 150 < ns_km < 400
    x, y = rs.proj.forward(lon, lat)
    txv, tyv = rs._cell_centers()
    d2 = ((x.ravel()[None, :] - txv.ravel()[:, None]) ** 2
          + (y.ravel()[None, :] - tyv.ravel()[:, None]) ** 2)
    brute = np.argmin(d2, axis=1).reshape(rs.index_map.shape)
    np.testing.assert_array_equal(np.where(rs.valid, rs.index_map, -1),
                                  np.where(rs.valid, brute, -1))
    lon_grid, _ = rs.lonlats()
    assert np.all(lon_grid >= -180.0) and np.all(lon_grid < 180.0)
    assert (lon_grid > 170).any() and (lon_grid < -170).any()


def test_degenerate_plan_keeps_its_metadata_on_earth():
    lat, lon, px, kw = _swath_case("degenerate")
    rs = UTMResampler(lat, lon, px, **kw)
    assert rs.x_size == rs.y_size == 1 and not rs.valid.any()
    assert 1 <= rs.zone <= 60 and rs.zone != 44
    out = rs.resample_image(np.ones((6, 6), np.float32), fill_value=np.nan)
    assert np.isnan(out).all()


def test_threaded_query_resolves_ties_as_the_serial_one():
    """The plan's query runs on every core: on a lattice whose query points
    sit exactly between two or four sources, the threaded answer is the
    serial one, index for index."""
    src = np.stack(np.meshgrid(np.arange(64.0), np.arange(48.0)), -1)
    q = np.stack(np.meshgrid(np.arange(0.5, 64.0, 0.5),
                             np.arange(0.5, 48.0, 0.5)), -1).reshape(-1, 2)
    tree = cKDTree(src.reshape(-1, 2))
    d1, i1 = tree.query(q, distance_upper_bound=0.9)
    dn, i_n = tree.query(q, distance_upper_bound=0.9, workers=-1)
    np.testing.assert_array_equal(i1, i_n)
    np.testing.assert_array_equal(d1, dn)
