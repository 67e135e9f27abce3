"""What the ranks of ``tests/test_torch_train_dp.py`` run (never collected
by pytest): each function is handed to ``plumekit_torch.parallel.launch``
and runs in a spawned process as one rank of a gloo group on the CPU, so it
lives in a module that imports no JAX. Inputs and outputs are numpy."""

import os

import torch
import torch.distributed as dist

from plumekit_torch.config import (DataConfig, MeshConfig, TrainConfig,
                                   UNetConfig)
from plumekit_torch.parallel.data_parallel import rank_slice
from plumekit_torch.train.loop import train
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_train_step, step_generator


def _same_on_every_rank(model) -> bool:
    flat = torch.cat([t.double().reshape(-1)
                      for t in model.state_dict().values()])
    everyone = [torch.empty_like(flat)
                for _ in range(dist.get_world_size())]
    dist.all_gather(everyone, flat)
    return all(torch.equal(everyone[0], e) for e in everyone)


def steps(rank, device, payload):
    """Data-parallel steps over ``payload["batches"]`` (global batches),
    from ``payload["state"]``, for each run of ``payload["runs"]`` (name →
    augment, compute dtype; the codes of ``step_generator(payload["seed"],
    i)``): per step the loss, the IoU and the averaged gradients; the final
    state dict; whether every rank holds the same parameters and
    buffers."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    out = {}
    for name, (augment, dtype) in payload["runs"].items():
        state = create_state(UNetConfig(**{**payload["kw"],
                                           "compute_dtype": dtype}),
                             TrainConfig(**payload["tcfg"]), device)
        state.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     payload["state"].items()})
        step = make_train_step(0.5, augment=augment, group=group)
        metrics, grads = [], []
        for i, (xs, ys) in enumerate(payload["batches"]):
            part = rank_slice(xs.shape[0], group)
            state, m = step(state, torch.from_numpy(xs[part]),
                            torch.from_numpy(ys[part]),
                            step_generator(payload["seed"], i, device))
            metrics.append((float(m["loss"]), float(m["iou"])))
            grads.append({n: p.grad.numpy().copy()
                          for n, p in state.model.named_parameters()})
        out[name] = {"metrics": metrics, "grads": grads,
                     "state": {k: v.numpy() for k, v in
                               state.model.state_dict().items()},
                     "same": _same_on_every_rank(state.model)}
    return out


def loops(rank, device, payload):
    """``train`` with ``mesh_cfg`` for each run of ``payload["runs"]``
    (name → TrainConfig overrides and, under ``"resume_from"``, the steps
    of a first call in the same directory); returns the histories."""
    torch.set_num_threads(1)
    mesh = MeshConfig(data=dist.get_world_size())
    histories = {}
    for name, extra in payload["runs"].items():
        extra = dict(extra)
        first = extra.pop("resume_from", None)
        tcfg = TrainConfig(**{**payload["tcfg"], **extra,
                              "checkpoint_dir": os.path.join(
                                  payload["root"], name)})
        kwargs = dict(unet_cfg=UNetConfig(**payload["kw"]),
                      data_cfg=DataConfig(**payload["dcfg"]), device=device,
                      mesh_cfg=mesh)
        if first is not None:
            train(train_cfg=TrainConfig(**{**tcfg.__dict__,
                                           "total_steps": first}), **kwargs)
        histories[name] = train(train_cfg=tcfg, **kwargs)
        # each rank evaluates its part of the dev batches: every rank must
        # still read the same dev IoUs, or their early stops would part
        dev = histories[name]["eval_iou_curve"] + histories[name]["eval_iou"]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, dev)
        assert all(d == dev for d in every), (name, every)
    return histories
