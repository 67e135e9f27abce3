"""One process of the two-process ``torch.distributed`` test of
``tests/test_torch_parallel.py`` (never collected by pytest): it joins the
group through ``plumekit_torch.parallel.mesh.init_distributed`` from the
coordinator address it is given, runs one data-parallel train step on its
part of a global batch, then serves its part of a granule stack on a
two-replica CPU mesh, and prints ``WORKER-OK <loss> <checksum>``, the loss
of the global batch and the sum of every rank's probabilities. Both ranks
must print the same line. Imports no JAX.

Usage: ``python tests/torch_distributed_worker.py RANK NPROC HOST:PORT``."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from plumekit_torch.config import (InferConfig, MeshConfig, TrainConfig,
                                   UNetConfig)
from plumekit_torch.infer import make_batch_infer_sharded
from plumekit_torch.models import replicate_model
from plumekit_torch.parallel.mesh import init_distributed, make_mesh
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step


def main(rank: int, nproc: int, coordinator: str) -> None:
    torch.set_num_threads(1)
    init_distributed(coordinator, nproc, rank, backend="gloo")
    assert dist.get_world_size() == nproc and dist.get_rank() == rank
    cfg = UNetConfig(in_channels=2, base_features=8, depth=2,
                     compute_dtype="float32")
    state = create_state(cfg, TrainConfig(batch_size=4, tile_size=32,
                                          learning_rate=1e-3), "cpu")
    rng = np.random.default_rng(7)
    xs = rng.random((4, 32, 32, 2)).astype(np.float32)
    ys = (rng.random((4, 32, 32, 1)) > 0.7).astype(np.float32)
    part = slice(rank * 4 // nproc, (rank + 1) * 4 // nproc)
    step = make_train_step(augment=False, group=dist.group.WORLD)
    state, metrics = step(state, torch.from_numpy(xs[part]),
                          torch.from_numpy(ys[part]), None)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)

    # this rank's two granules on a two-replica CPU mesh
    mesh = make_mesh(MeshConfig(data=2), ["cpu", "cpu"])
    infer = make_batch_infer_sharded(
        lambda model, x: model(x), mesh,
        InferConfig(tile_size=32, overlap=0, batch_tiles=4), channels=2)
    granules = rng.random((2 * nproc, 64, 64, 2)).astype(np.float32)
    model = state.model.eval()
    with torch.inference_mode():
        probs, _ = infer(replicate_model(model, infer.devices),
                         torch.from_numpy(granules[2 * rank:2 * rank + 2]))
    total = probs.double().sum().reshape(1)
    dist.all_reduce(total)
    checksum = float(total)
    assert np.isfinite(checksum)
    print(f"WORKER-OK {loss:.9f} {checksum:.6f}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
