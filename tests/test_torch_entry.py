"""``plumekit_torch/entry.py``, the port's counterpart of the root
``__graft_entry__.py``: ``entry()`` gives the flagship ``UNetConfig()``
inference forward with its example arguments (the JAX entry's config,
tile and batch) on the CPU, held against the JAX entry's forward on the
JAX entry's weights; ``dryrun_multichip(2)`` runs one data-parallel step
on two gloo ranks, held against the one-process step, and one spatially
sharded forward on a (1, 2, 1) mesh of the CPU, held against the JAX
package's sharded inference on the same weights; more ranks than cards is
the JAX mesh error."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plumekit.config.train import MeshConfig as JaxMeshConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import choose_halo as jax_choose_halo
from plumekit.infer import make_sharded_infer as jax_sharded
from plumekit.models import UNet as JaxUNet
from plumekit.parallel import make_mesh as jax_make_mesh
from plumekit_torch import entry as port_entry
from plumekit_torch.config import TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax, to_flax
from plumekit_torch.entry import _mesh_shape, dryrun_multichip, entry
from plumekit_torch.models import build_model
from plumekit_torch.parallel import mesh as port_mesh

import __graft_entry__ as graft

# bf16: the repo's bound for a bf16 replay against the reference
# (test_torch_unet.py, test_fused_forward.py:68-72)
BF16_TOL, BF16_MIN_CORR = 5e-2, 0.999
# the sharded raster against the JAX package's
# (test_torch_sharded_infer.py, tests/test_infer_parallel.py:175-180)
SHARDED_TOL = 1e-4
# two fp32 losses of one batch whose batch-norm sums run over other splits
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_is_the_flagship_forward_on_the_cpu():
    fn, (model, x) = entry(device="cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(
        JaxUNetConfig())
    assert tuple(x.shape) == (8, 256, 256, 2) and x.dtype == torch.float32
    assert x.device.type == "cpu" and not model.training
    # the JAX entry's PRNGKey(0) weights carried into the port's model, and
    # both forwards on a corner of a seeded batch (the whole batch takes
    # minutes on the CPU)
    jfn, (variables, jx) = graft.entry()
    assert jx.shape == tuple(x.shape)
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    corner = np.random.default_rng(0).random((1, 32, 32, 2), np.float32)
    out = fn(model, torch.from_numpy(corner))
    want = np.asarray(jfn(variables, jnp.asarray(corner)), np.float32)
    assert tuple(out.shape) == want.shape == (1, 32, 32, 1)
    g, w = out.float().numpy().ravel(), want.ravel()
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= BF16_TOL
    assert np.corrcoef(g, w)[0, 1] > BF16_MIN_CORR


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


@pytest.mark.parametrize("n", [1, 2, 4, 8, 6])
def test_mesh_shape_is_the_jax_drivers(n):
    assert _mesh_shape(n) == graft._mesh_shape(n)


def test_dryrun_multichip_refuses_more_ranks_than_cards(monkeypatch):
    """On CUDA the ranks take distinct cards: one card for two ranks is the
    JAX package's mesh error, not a rehearsal on the one card."""
    monkeypatch.setattr(port_mesh, "visible_devices",
                        lambda: [torch.device("cuda", 0)])
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:1])
    with pytest.raises(ValueError) as port_error:
        port_entry._devices(2, "cuda")
    assert str(port_error.value) == str(jax_error.value)
    assert port_entry._devices(1, "cuda") == [torch.device("cuda", 0)]


def test_dryrun_multichip_on_two_gloo_ranks():
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_train_step, step_generator

    summary = dryrun_multichip(2, device="cpu")
    assert summary["mesh"] == (1, 2, 1)
    assert summary["sharded_infer"] == (64, 32)
    assert summary["devices"] == ["cpu", "cpu"]

    # the two ranks' step against the one-process step on the same batch
    rng = np.random.default_rng(0)
    xs = rng.random((4, 32, 32, 2), np.float32)
    ys = (rng.random((4, 32, 32, 1)) > 0.7).astype(np.float32)
    state = create_state(UNetConfig(**port_entry.SMALL_UNET),
                         TrainConfig(**port_entry.SMALL_TRAIN), "cpu")
    _, metrics = make_train_step(0.5, augment=True)(
        state, torch.from_numpy(xs), torch.from_numpy(ys),
        step_generator(0, 0, "cpu"))
    assert abs(summary["loss"] - float(metrics["loss"])) <= LOSS_TOL

    # the sharded raster against the JAX package's sharded inference on
    # the same weights, mesh shape and halo, edges included (the interior
    # of a 64 x 32 raster is empty at a receptive field of 20)
    cfg = UNetConfig(**port_entry.SMALL_UNET)
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    variables = jax.tree.map(jnp.asarray, to_flax(model.state_dict()))
    halo = jax_choose_halo(8, 32, cfg.depth, block_w=32)
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, y=2, x=1))
    jmodel = JaxUNet(JaxUNetConfig(**port_entry.SMALL_UNET))
    jp, _ = jax_sharded(jmodel.apply, jmesh, halo)(
        variables, jnp.asarray(summary["image"]))
    np.testing.assert_allclose(summary["probs"], np.asarray(jp),
                               atol=SHARDED_TOL)
