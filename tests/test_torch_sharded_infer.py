"""plumekit_torch's sharded inference against the JAX package's on its
8-device virtual CPU mesh: spatial sharding with halo exchange
(``make_sharded_infer``, as ``tests/test_infer_parallel.py:154-201``) and
the granule group split over the data axis (``make_batch_infer_sharded``,
as ``:245-263``), for the plain forward and the int8 forward; then the
stream's staging of each granule onto its slot, and the replicas. The
port's meshes are repeated CPU devices, each slot with its own replica of
the model built from the same state dict."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import MeshConfig as JaxMeshConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import make_batch_infer_sharded as jax_batch_sharded
from plumekit.infer import make_sharded_infer as jax_sharded
from plumekit.models import build_model as jax_build_model
from plumekit.models import quantized_forward as jq
from plumekit.parallel import make_mesh as jax_make_mesh
from plumekit_torch.config import InferConfig, MeshConfig, UNetConfig
from plumekit_torch.convert import from_flax, qvars_from_flax
from plumekit_torch.infer import (choose_halo, make_batch_infer_sharded,
                                  make_multi_granule_infer,
                                  make_sharded_infer)
from plumekit_torch.infer import streaming
from plumekit_torch.models import build_model, receptive_field, \
    replicate_model
from plumekit_torch.models import quantized_forward as tq
from plumekit_torch.models.fused_forward import blocks_of
from plumekit_torch.parallel import make_mesh

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
# the stitched probabilities of two fp32 forwards whose convolutions run
# at other batch sizes (tests/test_infer_parallel.py:256-262)
BATCH_TOL = 1e-5
# the sharded raster's interior against the unsharded forward
# (tests/test_infer_parallel.py:175-180)
INTERIOR_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(arch="unet", seed=0):
    """flax variables with nontrivial running statistics and the port's
    model of the same weights."""
    cfg = dict(KW, arch=arch)
    variables = jax_build_model(JaxUNetConfig(**cfg)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 2)), train=False)
    variables = jax.tree.map(
        lambda a: a + 0.03 * jnp.arange(a.size, dtype=a.dtype)
        .reshape(a.shape) if a.ndim == 1 else a, variables)
    model = build_model(UNetConfig(**cfg))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)))
    return variables, model.eval()


@pytest.fixture(scope="module")
def carried():
    return _carried()


def _forward(model, x):
    return model(x)


@pytest.mark.parametrize("arch", ["unet", "unetpp"])
def test_sharded_infer_matches_jax_and_unsharded(arch):
    """A (64, 128) raster on a (1, 2, 4) grid: the interior equals the JAX
    package's sharded inference and the unsharded forward, the shard seams
    included."""
    variables, model = _carried(arch, seed=3)
    image = np.random.default_rng(2).random((64, 128, 2)).astype(np.float32)
    r = receptive_field(KW["depth"])
    halo = choose_halo(r, 64 // 2, KW["depth"])
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, y=2, x=4))
    jmodel = jax_build_model(JaxUNetConfig(**dict(KW, arch=arch)))
    jp, jm = jax_sharded(jmodel.apply, jmesh, halo)(variables,
                                                    jnp.asarray(image))
    mesh = make_mesh(MeshConfig(data=1, y=2, x=4), ["cpu"] * 8)
    infer = make_sharded_infer(_forward, mesh, halo)
    replicas = replicate_model(model, [d for row in mesh.grid()
                                       for d in row])
    with torch.inference_mode():
        probs, mask = infer(replicas, image)
        direct = torch.sigmoid(model(torch.from_numpy(image)[None])[0, ..., 0])
    p, d = probs.numpy(), direct.numpy()
    assert p.shape == (64, 128) and np.isfinite(p).all()
    np.testing.assert_allclose(p[r:-r, r:-r], np.asarray(jp)[r:-r, r:-r],
                               atol=INTERIOR_TOL)
    np.testing.assert_allclose(p[r:-r, r:-r], d[r:-r, r:-r],
                               atol=INTERIOR_TOL)
    # the row seam at y = 32 and the column seams in the compared interior
    np.testing.assert_allclose(p[28:36, r:-r], d[28:36, r:-r],
                               atol=INTERIOR_TOL)
    np.testing.assert_array_equal(mask.numpy(), p > 0.5)


def test_sharded_infer_refusals():
    _, model = _carried()
    mesh = make_mesh(MeshConfig(data=1, y=2, x=4), ["cpu"] * 8)
    with pytest.raises(ValueError, match="halo must be >= 1"):
        make_sharded_infer(_forward, mesh, 0)
    infer = make_sharded_infer(_forward, mesh, 12)
    replicas = [model] * 8
    with pytest.raises(ValueError, match="exceeds per-shard block"):
        infer(replicas, np.zeros((16, 32, 2), np.float32))
    with pytest.raises(ValueError, match="does not divide by the mesh"):
        infer(replicas, np.zeros((15, 32, 2), np.float32))
    with pytest.raises(ValueError, match="replicas for a grid"):
        infer(replicas[:2], np.zeros((64, 128, 2), np.float32))


def test_batch_infer_sharded_matches_jax_and_unsharded(carried):
    """8 granules over 4 devices, G = 2 a device, the general stitching
    path (overlap 16 of tile 64): the JAX package's sharded program and the
    port's unsharded multi-granule program."""
    variables, model = carried
    cfg = dict(tile_size=64, overlap=16, batch_tiles=4)
    images = np.random.default_rng(3).random((8, 96, 96, 2)) \
        .astype(np.float32)
    jmodel = jax_build_model(JaxUNetConfig(**KW))
    jp, jm = jax_batch_sharded(jmodel.apply,
                               jax_make_mesh(JaxMeshConfig(data=4)),
                               JaxInferConfig(**cfg), channels=2)(
        variables, jnp.asarray(images))
    mesh = make_mesh(MeshConfig(data=4), ["cpu"] * 4)
    sharded = make_batch_infer_sharded(_forward, mesh, InferConfig(**cfg))
    plain = make_multi_granule_infer(_forward, InferConfig(**cfg))
    with torch.inference_mode():
        ps, ms = sharded(replicate_model(model, sharded.devices),
                         torch.from_numpy(images))
        pu, mu = plain(model, torch.from_numpy(images))
    np.testing.assert_allclose(ps.numpy(), pu.numpy(), rtol=BATCH_TOL,
                               atol=BATCH_TOL)
    np.testing.assert_array_equal(ms.numpy(), mu.numpy())
    np.testing.assert_allclose(ps.numpy(), np.asarray(jp), rtol=BATCH_TOL,
                               atol=BATCH_TOL)
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jm))


def test_batch_infer_sharded_int8_matches_jax_and_unsharded(carried):
    """The int8 forward on the JAX quantized state carried over, each slot
    with its own copy of it: the port's unsharded program and the JAX
    package's sharded int8 program, within the batch tolerance, masks
    equal."""
    variables, _ = carried
    calib = np.random.default_rng(4).random((4, 32, 32, 2)) \
        .astype(np.float32)
    jcfg = JaxUNetConfig(**KW)
    qvars = jax.tree.map(np.asarray,
                         jq.quantize_unet(variables, jcfg, jnp.asarray(calib)))
    cfg = dict(tile_size=32, overlap=8, batch_tiles=4)
    images = np.random.default_rng(5).random((4, 64, 64, 2)) \
        .astype(np.float32)
    jp, jm = jax_batch_sharded(jq.make_quantized_apply(jcfg),
                               jax_make_mesh(JaxMeshConfig(data=2)),
                               JaxInferConfig(**cfg), channels=2)(
        jax.tree.map(jnp.asarray, qvars), jnp.asarray(images))
    apply = tq.make_quantized_apply(UNetConfig(**KW))
    mesh = make_mesh(MeshConfig(data=2), ["cpu"] * 2)
    sharded = make_batch_infer_sharded(apply, mesh, InferConfig(**cfg))
    port_qvars = qvars_from_flax(qvars)
    replicas = [tq.qvars_to(port_qvars, d) for d in sharded.devices]
    assert replicas[0]["blocks"][0]["wq1"].data_ptr() \
        != replicas[1]["blocks"][0]["wq1"].data_ptr()
    with torch.inference_mode():
        ps, ms = sharded(replicas, torch.from_numpy(images))
        pu, mu = make_multi_granule_infer(apply, InferConfig(**cfg))(
            port_qvars, torch.from_numpy(images))
    np.testing.assert_allclose(ps.numpy(), pu.numpy(), rtol=BATCH_TOL,
                               atol=BATCH_TOL)
    np.testing.assert_array_equal(ms.numpy(), mu.numpy())
    np.testing.assert_allclose(ps.numpy(), np.asarray(jp), rtol=BATCH_TOL,
                               atol=BATCH_TOL)
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jm))


def test_batch_infer_sharded_refuses_misplaced_parts(carried):
    _, model = carried
    mesh = make_mesh(MeshConfig(data=2), ["cpu", "meta"])
    infer = make_batch_infer_sharded(_forward, mesh,
                                     InferConfig(tile_size=32, overlap=0))
    x = torch.zeros(1, 32, 32, 2)
    with pytest.raises(ValueError, match="a part on cpu for a slot on meta"):
        infer([model, model], [x, x])
    with pytest.raises(ValueError, match="2 replicas for"):
        make_batch_infer_sharded(_forward, make_mesh(
            MeshConfig(data=3), ["cpu"] * 3), InferConfig())([model] * 2, x)


def test_replicas_hold_their_own_packed_blocks():
    """The fused forward's folded blocks are cached per model: each
    replica folds its own, from its own tensors."""
    _, model = _carried()
    replicas = replicate_model(model, ["cpu", "cpu"])
    dev = torch.device("cpu")
    a, b = (blocks_of(r, torch.float32, dev) for r in replicas)
    assert a is not b and a[0][0].data_ptr() != b[0][0].data_ptr()
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


def _granule_items(n, size=32, odd_at=None):
    rng = np.random.default_rng(6)
    items = {}
    for i in range(n):
        s = size + 16 if i == odd_at else size
        items[f"g{i}"] = (f"g{i}", rng.random((s, s, 2)).astype(np.float32),
                          (s, s))
    return items


@pytest.mark.parametrize("quantize", [False, True])
def test_stream_stages_each_granule_on_its_slot(quantize, monkeypatch):
    """``stream_inference(devices=...)``: 7 granules, one of another shape,
    in groups of 2 slots × 2: each granule is staged onto its slot's device
    (recorded by the put), the ragged groups padded, and the probabilities
    equal the one-device stream's."""
    monkeypatch.setattr(streaming, "decode_pool",
                        lambda paths, decode, workers, depth:
                        map(decode, paths))
    items = _granule_items(7, odd_at=4)
    slots = [torch.device("cpu", 0), torch.device("cpu", 1)]
    staged = []
    real_put = streaming.make_device_put

    def put_for(device):
        put = real_put("cpu")

        def recorded(item):
            staged.append((item[0], device))
            return put(item)
        return recorded

    def infer(variables, parts):
        assert [p.shape[0] for p in parts] == [2, 2]
        x = torch.cat(parts)
        probs = torch.sigmoid(x[..., 0] * 2 - 1)
        return probs, probs > 0.5

    def one(variables, x):
        probs = torch.sigmoid(x[..., 0] * 2 - 1)
        return probs, probs > 0.5

    paths = list(items)
    monkeypatch.setattr(streaming, "make_device_put", put_for)
    got = list(streaming.stream_inference(
        paths, infer, None, 2, "cpu", quantize=quantize, batch_granules=4,
        predecoded=dict(items), infer_is_batched=True, devices=slots,
        decode_workers=1))
    # groups: g0-g3 (the 32² shape), g4 alone (48²), g5-g6 (32²)
    assert staged == [("g0", slots[0]), ("g1", slots[0]), ("g2", slots[1]),
                      ("g3", slots[1]), ("g4", slots[0]), ("g5", slots[0]),
                      ("g6", slots[0])]
    monkeypatch.undo()
    monkeypatch.setattr(streaming, "decode_pool",
                        lambda paths, decode, workers, depth:
                        map(decode, paths))
    want = list(streaming.stream_inference(
        paths, one, None, 2, "cpu", quantize=quantize, batch_granules=1,
        predecoded=dict(items), decode_workers=1))
    assert [n for n, _ in got] == [n for n, _ in want] == paths
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_stream_refuses_a_group_that_does_not_split():
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        list(streaming.stream_inference([], None, None, 2, "cpu",
                                        batch_granules=3,
                                        infer_is_batched=True,
                                        devices=["cpu", "cpu"]))
