"""plumekit_torch's meshes, shards and halo exchange
(``plumekit_torch/parallel``) against the JAX package's on its 8-device
virtual CPU mesh (``tests/conftest.py``): the mesh's errors, the halo
exchange bit for bit on a (1, 2, 4) mesh, its errors, ``choose_halo``;
then the port's own helpers, and two processes joined by
``init_distributed`` running a data-parallel step and sharded inference
(the counterpart of ``tests/test_distributed.py``). The port's meshes here
are repeated CPU devices, the rehearsal of a multi-card mesh."""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from plumekit.config.train import MeshConfig as JaxMeshConfig
from plumekit.infer.sharded import choose_halo as jax_choose_halo
from plumekit.parallel import exchange_halo_block as jax_exchange
from plumekit.parallel import halo_pad as jax_halo_pad
from plumekit.parallel import make_mesh as jax_make_mesh
from plumekit.parallel.halo import shard_map
from plumekit_torch.config import MeshConfig
from plumekit_torch.infer import choose_halo
from plumekit_torch.parallel import (AXES, exchange_halo_blocks, gather,
                                     halo_pad, init_distributed, make_mesh,
                                     run_per_device, shard)
from plumekit_torch.parallel.halo import split_blocks
from plumekit_torch.parallel.mesh import DEVICE_THREAD_NAME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_mesh_axes_shape_and_device_count_error():
    mesh = make_mesh(MeshConfig(data=1, y=2, x=4), CPU8)
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, y=2, x=4))
    assert mesh.axis_names == AXES == jmesh.axis_names
    assert mesh.shape == dict(jmesh.shape)
    assert len(mesh.grid()) == 2 and len(mesh.grid()[0]) == 4
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "y": 1,
                                                    "x": 1}
    assert (_error(make_mesh, MeshConfig(data=9), CPU8)
            == _error(jax_make_mesh, JaxMeshConfig(data=9)))


def test_mesh_default_is_every_visible_card_and_no_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # no card: the default mesh refuses, it does not fall back to the CPU
    assert _error(make_mesh) == "mesh needs 1 devices, have 0"


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_halo_exchange_matches_jax_bit_for_bit(trailing):
    """(16, 32[, 3]) raster on a (1, 2, 4) mesh, halo 3: every extended
    block equals the JAX package's ``exchange_halo_block`` under
    ``shard_map`` and the zero-padded raster's window."""
    h, w, halo = 16, 32, 3
    full = np.random.default_rng(0).random((h, w) + trailing) \
        .astype(np.float32)
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, y=2, x=4))
    spec = P("y", "x") if not trailing else P("y", "x", None)
    out_spec = P("y", "x", *([None] * (2 + len(trailing))))
    want = np.asarray(shard_map(
        lambda b: jax_exchange(b, halo)[None, None], mesh=jmesh,
        in_specs=(spec,), out_specs=out_spec)(jnp.asarray(full)))
    got = halo_pad(make_mesh(MeshConfig(data=1, y=2, x=4), CPU8), full, halo)
    padded = np.pad(full, ((halo, halo), (halo, halo))
                    + ((0, 0),) * len(trailing))
    for iy in range(2):
        for ix in range(4):
            block = got[iy][ix].numpy()
            np.testing.assert_array_equal(block, want[iy, ix])
            np.testing.assert_array_equal(
                block, padded[iy * 8:iy * 8 + 8 + 2 * halo,
                              ix * 8:ix * 8 + 8 + 2 * halo])


def test_halo_pad_matches_jax_halo_pad():
    full = np.random.default_rng(1).random((8, 12)).astype(np.float32)
    want = np.asarray(jax_halo_pad(jax_make_mesh(
        JaxMeshConfig(data=1, y=2, x=2)), jnp.asarray(full), 2))
    got = halo_pad(make_mesh(MeshConfig(data=1, y=2, x=2), CPU8), full, 2)
    np.testing.assert_array_equal(
        np.stack([np.stack([b.numpy() for b in row]) for row in got]), want)


@pytest.mark.parametrize("halo", [0, 5])
def test_halo_errors_read_as_jax(halo):
    """halo < 1, and a halo beyond the block: the JAX package's texts."""
    full = np.zeros((8, 16), np.float32)
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, y=2, x=4))
    want = _error(lambda: shard_map(
        lambda b: jax_exchange(b, halo)[None, None], mesh=jmesh,
        in_specs=(P("y", "x"),),
        out_specs=P("y", "x", None, None))(jnp.asarray(full)))
    got = _error(halo_pad, make_mesh(MeshConfig(data=1, y=2, x=4), CPU8),
                 full, halo)
    assert got == want


def test_halo_pad_divisibility_error_reads_as_jax():
    full = np.zeros((9, 16), np.float32)
    want = _error(jax_halo_pad, jax_make_mesh(JaxMeshConfig(data=1, y=2,
                                                            x=4)),
                  jnp.asarray(full), 1)
    got = _error(halo_pad, make_mesh(MeshConfig(data=1, y=2, x=4), CPU8),
                 full, 1)
    assert got == want


def test_choose_halo_matches_jax():
    for min_halo in (0, 1, 5, 12):
        for block_h in (16, 30, 32, 33, 64):
            for depth in (2, 3, 4):
                for block_w in (None, 16, 34):
                    try:
                        want = jax_choose_halo(min_halo, block_h, depth,
                                               block_w)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            choose_halo(min_halo, block_h, depth, block_w)
                        assert str(got.value) == str(e)
                        continue
                    assert choose_halo(min_halo, block_h, depth,
                                       block_w) == want


def test_shard_and_gather_round_trip():
    x = np.arange(24, dtype=np.float32).reshape(6, 2, 2)
    parts = shard(x, ["cpu"] * 3)
    assert [p.shape[0] for p in parts] == [2, 2, 2]
    np.testing.assert_array_equal(gather(parts, "cpu").numpy(), x)
    assert "does not divide" in _error(shard, x, ["cpu"] * 4)


def test_split_blocks_tiles_the_raster_row_by_row():
    x = np.arange(8 * 12).reshape(8, 12)
    blocks = split_blocks(make_mesh(MeshConfig(data=1, y=2, x=3), CPU8), x)
    np.testing.assert_array_equal(blocks[1][2].numpy(), x[4:, 8:])


def test_exchange_halo_blocks_of_a_one_block_grid_pads_zeros():
    block = torch.ones(4, 5)
    (got,), = exchange_halo_blocks([[block]], 1)
    want = torch.nn.functional.pad(block, (1, 1, 1, 1))
    assert torch.equal(got, want)


def test_run_per_device_keeps_slot_order_modes_and_errors():
    """Each slot on its own named thread, results in slot order, the
    caller's inference mode carried over; the first slot's error raised
    after all slots ran."""
    seen = []

    def fn(i):
        seen.append(i)
        assert threading.current_thread().name.startswith(DEVICE_THREAD_NAME)
        return i * 10, torch.is_inference_mode_enabled()

    with torch.inference_mode():
        out = run_per_device(fn, ["cpu"] * 4, range(4))
    assert out == [(0, True), (10, True), (20, True), (30, True)]
    assert sorted(seen) == [0, 1, 2, 3]

    def fail(i):
        seen.append(i)
        if i == 1:
            raise ValueError("slot 1")
        return i

    seen.clear()
    with pytest.raises(ValueError, match="slot 1"):
        run_per_device(fail, ["cpu"] * 3, range(3))
    assert sorted(seen) == [0, 1, 2]


def test_run_per_device_under_a_short_switch_interval():
    """More slots than cores, each adding into its own tensor and a shared
    tally under a lock: no lost update, every thread joined."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tally, lock = [0], threading.Lock()

        def work(i):
            t = torch.zeros(8)
            for _ in range(200):
                t += 1
                with lock:
                    tally[0] += 1
            return float(t.sum()) + i

        n = 2 * (os.cpu_count() or 1) + 1
        out = run_per_device(work, ["cpu"] * n, range(n))
    finally:
        sys.setswitchinterval(old)
    assert out == [1600.0 + i for i in range(n)]
    assert tally[0] == 200 * n
    assert not [t for t in threading.enumerate()
                if t.name.startswith(DEVICE_THREAD_NAME)]


def test_init_distributed_without_a_cluster_does_nothing(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is None
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_dp_step_and_sharded_infer():
    """Two processes join one gloo group from a coordinator address, take
    one data-parallel step and serve their parts of a granule stack: both
    print the same global loss and probability checksum."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_distributed_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", coord],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
    oks = [[ln for ln in out.splitlines() if ln.startswith("WORKER-OK")]
           for out in outs]
    assert all(oks), outs
    assert oks[0][0] == oks[1][0], (oks[0][0], oks[1][0])
