"""Spawn the ranks of a data-parallel run: one process per device, joined
into one ``torch.distributed`` process group.

NCCL runs the collectives of ranks on distinct cards; gloo those of ranks
on the CPU, and of several ranks on one card (NCCL refuses two ranks on
one device), which is how a multi-card run is rehearsed on one card. The
processes are spawned, not forked (the parent may hold threads and a CUDA
context), so what a rank runs is named by import path.
"""

from __future__ import annotations

import socket
from typing import Callable, List, Optional, Sequence

import torch

from plumekit_torch.config.train import MeshConfig
from plumekit_torch.parallel.mesh import init_distributed, make_mesh


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_parallel_devices(n: int, device) -> List[torch.device]:
    """The devices of an ``n``-rank run on ``device``'s kind: ``n``
    distinct cards (the JAX CLI's "mesh needs N devices, have M" when there
    are fewer), or ``n`` ranks on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    return make_mesh(MeshConfig(data=n)).axis_devices("data")


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL for ranks on distinct cards, gloo otherwise."""
    cards = [d for d in devices if d.type == "cuda"]
    if cards and len({d.index for d in cards}) == len(devices):
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, devices, backend, port, args, results):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(f"localhost:{port}", len(devices), rank, backend)
    import torch.distributed as dist

    try:
        out = fn(rank, device, *args)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, args: tuple = (),
           backend: Optional[str] = None):
    """Run ``fn(rank, device, *args)`` in one spawned process per entry of
    ``devices``, the processes joined into one process group
    (``backend``: :func:`default_backend` when None) on a free localhost
    port; returns rank 0's return value. ``fn`` and ``args`` cross to the
    processes by pickling, so ``fn`` is a module-level function. A rank
    that raises stops the run: the others are terminated and the error is
    raised here."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, devices, backend, free_port(), args, results),
        nprocs=len(devices), join=False, start_method="spawn")
    out, have = None, False
    # drain rank 0's result while joining: a result larger than the pipe's
    # buffer would otherwise block its writer, and the join with it
    while not procs.join(timeout=0.2):
        if not have and not results.empty():
            out, have = results.get(), True
    if not have and not results.empty():
        out = results.get()
    return out


__all__ = ["data_parallel_devices", "default_backend", "free_port",
           "launch"]
