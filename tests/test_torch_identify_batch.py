"""plumekit_torch's data-parallel batch identify
(``identify/batch.batch_identify_sharded``) against the JAX package's on
its 8-device virtual CPU mesh (``tests/test_identify_batch.py``): 6 scenes
over 8 slots (2 empty scenes padded and dropped), the integer and boolean
outputs and the masks bit for bit, the in-plume AOD statistics at the rtol
of ``tests/test_torch_identify.py``; and every output bit for bit equal to
the port's single-scene sweep. The port's mesh is 8 slots of the CPU."""

import numpy as np
import pytest
import torch

from plumekit.config.identify import RGIdentifyConfig as JaxRGCfg
from plumekit.config.train import MeshConfig as JaxMeshConfig
from plumekit.identify.batch import batch_identify_sharded as jax_batch
from plumekit.identify.rg import _statics as jax_statics
from plumekit.parallel import make_mesh as jax_make_mesh
from plumekit_torch.config import MeshConfig
from plumekit_torch.config.identify import RGIdentifyConfig
from plumekit_torch.identify.batch import batch_identify_sharded
from plumekit_torch.identify.locate import locate_fires_in_image, pad_fires
from plumekit_torch.identify.pipeline import make_sweep_identifier
from plumekit_torch.identify.rg import _statics
from plumekit_torch.io.fires import subset_fires_to_image
from plumekit_torch.io.synthetic import SyntheticSceneConfig, make_scene
from plumekit_torch.ops.cluster import mean_cluster_positions
from plumekit_torch.parallel import make_mesh

CFG = RGIdentifyConfig(max_fires=8)
EXACT = ("extents", "t_index", "t_used", "label", "area", "bbox",
         "accepted", "mask")
FLOAT_RTOL = 1e-5        # in-plume AOD sums in another order than XLA's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    """6 scenes of ``tests/test_identify_batch.py`` and their fires."""
    aods, rows, cols, valid = [], [], [], []
    for i in range(6):
        scene = make_scene(SyntheticSceneConfig(
            size=96, n_plumes=2, seed=50 + i, fires_per_plume=(5, 7),
            plume_sigma_major=(8.0, 11.0), plume_sigma_minor=(1.6, 2.2)))
        g = scene.granule
        sub = subset_fires_to_image(g.lat, g.lon, scene.fires,
                                    scene.fires["date_time"][0],
                                    min_frp=CFG.min_frp)
        lat, lon = mean_cluster_positions(sub, CFG.cluster_dist_km)
        r, c = locate_fires_in_image(lat, lon, g.lat, g.lon, CFG.win_half)
        fr, fc, fv = pad_fires(r, c, CFG.max_fires)
        aods.append(g.first_layer())
        rows.append(fr)
        cols.append(fc)
        valid.append(fv)
    return tuple(np.stack(a) for a in (aods, rows, cols, valid))


@pytest.fixture(scope="module")
def port_out(stack):
    return batch_identify_sharded(
        stack[0], _statics(CFG), CFG.thresholds, *stack[1:],
        make_mesh(MeshConfig(data=8), ["cpu"] * 8))


def test_batch_identify_matches_jax(stack, port_out):
    want = jax_batch(stack[0], jax_statics(JaxRGCfg(max_fires=8)),
                     JaxRGCfg(max_fires=8).thresholds, *stack[1:],
                     jax_make_mesh(JaxMeshConfig(data=8)))
    assert set(port_out) == set(want)
    assert port_out["accepted"].shape[0] == 6
    assert port_out["accepted"].any()
    for k in want:
        assert port_out[k].shape == want[k].shape, k
        assert port_out[k].dtype == want[k].dtype, k
    for k in EXACT:
        np.testing.assert_array_equal(port_out[k], want[k], err_msg=k)
    for k in ("aod_mean", "aod_sd"):
        np.testing.assert_allclose(port_out[k], want[k], rtol=FLOAT_RTOL,
                                   atol=0, err_msg=k)


def test_batch_identify_equals_single_scene_sweeps(stack, port_out):
    fn = make_sweep_identifier(_statics(CFG))
    th = torch.from_numpy(np.asarray(CFG.thresholds, np.float32))
    aods, rows, cols, valid = stack
    for i in range(6):
        a = torch.from_numpy(aods[i])
        ref = fn(a, a, torch.zeros(a.shape, dtype=torch.bool), th,
                 torch.from_numpy(rows[i]), torch.from_numpy(cols[i]),
                 torch.from_numpy(valid[i]))
        for k, v in ref.items():
            np.testing.assert_array_equal(port_out[k][i], v.numpy(),
                                          err_msg=f"scene {i} {k}")


def test_batch_identify_with_null_masks_and_fewer_slots(stack):
    """Null masks ride with their scenes; 3 scenes over 4 slots pad to 4."""
    aods, rows, cols, valid = stack
    nulls = np.zeros(aods.shape, bool)
    nulls[:, :8, :8] = True
    mesh = make_mesh(MeshConfig(data=4), ["cpu"] * 4)
    got = batch_identify_sharded(aods[:3], _statics(CFG), CFG.thresholds,
                                 rows[:3], cols[:3], valid[:3], mesh,
                                 null_masks=nulls[:3])
    fn = make_sweep_identifier(_statics(CFG))
    th = torch.from_numpy(np.asarray(CFG.thresholds, np.float32))
    assert got["accepted"].shape[0] == 3
    for i in range(3):
        a = torch.from_numpy(aods[i])
        ref = fn(a, a, torch.from_numpy(nulls[i]), th,
                 torch.from_numpy(rows[i]), torch.from_numpy(cols[i]),
                 torch.from_numpy(valid[i]))
        for k in EXACT:
            np.testing.assert_array_equal(got[k][i], ref[k].numpy())


def test_batch_identify_refuses_non_descending_thresholds(stack):
    aods, rows, cols, valid = stack
    mesh = make_mesh(MeshConfig(data=2), ["cpu"] * 2)
    with pytest.raises(ValueError) as got:
        batch_identify_sharded(aods[:2], _statics(CFG), [0.5, 0.7],
                               rows[:2], cols[:2], valid[:2], mesh)
    with pytest.raises(ValueError) as want:
        jax_batch(aods[:2], jax_statics(JaxRGCfg(max_fires=8)), [0.5, 0.7],
                  rows[:2], cols[:2], valid[:2],
                  jax_make_mesh(JaxMeshConfig(data=2)))
    assert str(got.value) == str(want.value)
