"""Device meshes of the port (``plumekit/parallel/mesh.py``).

A mesh is a (data, y, x) grid of ``torch.device``s: ``data`` for batch
sharding, ``y``/``x`` for the raster plane. There is no sharded tensor type
in PyTorch, so a tensor sharded over an axis is a list of per-device
tensors, one per slot of the axis: :func:`shard` splits dim 0 straight
onto the slots' devices and :func:`gather` joins the parts on one device.
:func:`run_per_device` runs one function per slot, each on a host thread
of its own, so that every device's share is launched before any of them is
read back.

A device may stand in more than one slot: D replicas on one card, or on the
CPU, rehearse a D-device mesh, as the JAX package's tests rehearse theirs on
virtual CPU devices. Across processes, :func:`init_distributed` joins the
``torch.distributed`` process group that the collectives of data-parallel
training (``parallel/data_parallel.py``) run on.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from plumekit_torch.config.train import MeshConfig

AXES = ("data", "y", "x")

#: the name prefix of :func:`run_per_device`'s threads
DEVICE_THREAD_NAME = "plumekit-device"


class Mesh:
    """A (data, y, x) grid of devices (``devices``: an object array of
    ``torch.device`` of shape ``MeshConfig.shape``)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is a grid over {AXES}, got an array "
                             f"of {devices.ndim} dims")
        self.devices = devices

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(AXES, self.devices.shape))

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, at index 0 of the other axes: the
        slots a tensor sharded over ``axis`` alone lies on."""
        index = [0] * len(AXES)
        index[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def grid(self) -> List[List[torch.device]]:
        """The (y, x) grid of devices at data index 0, row by row."""
        return [list(row) for row in self.devices[0]]


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, in index order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, y, x) mesh. Without ``devices``, every visible CUDA
    device; without a config, all of them on ``data``. ``devices`` may
    repeat a device (the rehearsal on one card or on the CPU)."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else visible_devices())
    if cfg is None:
        cfg = MeshConfig(data=max(1, len(devices)))
    if cfg.n_devices > len(devices):
        raise ValueError(
            f"mesh needs {cfg.n_devices} devices, have {len(devices)}")
    grid = np.empty(cfg.n_devices, dtype=object)
    for i, d in enumerate(devices[:cfg.n_devices]):
        grid[i] = d
    return Mesh(grid.reshape(cfg.shape))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the ``torch.distributed`` process group of several processes.
    ``coordinator`` is ``host:port`` (or a URL such as
    ``tcp://localhost:29500``); without it, the ``MASTER_ADDR`` /
    ``WORLD_SIZE`` / ``RANK`` environment of a launcher such as
    ``torchrun``. ``backend`` defaults to NCCL on the card and gloo without
    one. With neither a coordinator nor that environment, or with a group
    already joined, it does nothing. A requested or env-configured join
    that fails raises: each process would otherwise train its own model and
    fight over the same checkpoint directory."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env_cluster = all(os.environ.get(v)
                      for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if coordinator is None and not env_cluster:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        method = "env://"
    else:
        method = coordinator if "://" in coordinator else \
            f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=method,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)


def shard(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Dim 0 of ``x`` (a tensor or a numpy array) split into
    ``len(devices)`` equal parts, part i on ``devices[i]``. A host array's
    parts go straight from the host to their devices."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not divide over "
                         f"{n} devices; pad it first")
    k = x.shape[0] // n
    return [torch.as_tensor(x[i * k:(i + 1) * k]).to(d)
            for i, d in enumerate(devices)]


def gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The per-device parts of a tensor joined along dim 0 on ``device``."""
    return torch.cat([p.to(device) for p in parts])


def run_per_device(fn: Callable, devices: Sequence[torch.device],
                   *per_slot: Sequence) -> list:
    """``[fn(*args_i) for each slot i]``, slot i on a host thread of its own
    with ``devices[i]`` as the current CUDA device (and the caller's grad
    and inference modes, which are per thread): every slot's work is
    launched before any slot's result is read. ``per_slot`` holds one
    sequence per argument, indexed by slot. The first slot's exception, if
    any, is raised after every slot has finished."""
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()

    def run(i):
        device = torch.device(devices[i])
        on_card = (torch.cuda.device(device) if device.type == "cuda"
                   else contextlib.nullcontext())
        with torch.inference_mode(inference), \
                torch.set_grad_enabled(grad), on_card:
            return fn(*(args[i] for args in per_slot))

    with ThreadPoolExecutor(len(devices),
                            thread_name_prefix=DEVICE_THREAD_NAME) as pool:
        futures = [pool.submit(run, i) for i in range(len(devices))]
        return [f.result() for f in futures]


__all__ = ["AXES", "DEVICE_THREAD_NAME", "Mesh", "gather", "init_distributed",
           "make_mesh", "run_per_device", "shard", "visible_devices"]
