"""Driver entry points of the port (the counterpart of the root
``__graft_entry__.py``): :func:`entry` returns the flagship U-Net's
inference forward with example arguments, and :func:`dryrun_multichip`
runs the two parallel modes once on tiny shapes.

Both run on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from plumekit_torch.config import MeshConfig, TrainConfig, UNetConfig

#: the tiny configuration of the dry run
SMALL_UNET = dict(in_channels=2, base_features=8, depth=2,
                  compute_dtype="float32")
SMALL_TRAIN = dict(batch_size=8, tile_size=32, warmup_steps=2,
                   total_steps=10, augment=True)


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(model, x)`` is the inference forward of
    the flagship ``UNetConfig()`` (base 32, depth 4, bf16) and
    ``example_args`` its model, seeded from 0, with an (8, 256, 256, 2)
    float32 batch of zeros (the JAX entry's tile and batch), both on
    ``device``."""
    from plumekit_torch.device import resolve_device
    from plumekit_torch.models import build_model

    device = resolve_device(device)
    cfg = UNetConfig()
    model = build_model(cfg, torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    x = torch.zeros((8, 256, 256, cfg.in_channels), dtype=torch.float32,
                    device=device)
    return fn, (model, x)


def _mesh_shape(n: int):
    """Factor n into (data, y, x), spending factors of 2 on the spatial
    axes first (at most 4 spatial slots), as the JAX driver does."""
    y = x = 1
    while n % 2 == 0 and y * 2 * x <= 4:
        if y <= x:
            y *= 2
        else:
            x *= 2
        n //= 2
    return n, y, x


def _devices(n: int, device) -> List[torch.device]:
    """``n`` distinct cards, or ``device`` repeated ``n`` times where it is
    the CPU (the rehearsal on gloo ranks). Fewer visible cards than ``n``
    is the JAX mesh error."""
    from plumekit_torch.parallel.mesh import visible_devices

    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    cards = visible_devices()
    if len(cards) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(cards)}")
    return cards[:n]


def _dp_rank(rank, device, payload):
    """One rank's data-parallel step on its part of the global batch;
    returns the loss and whether every rank holds the same parameters."""
    import torch.distributed as dist

    from plumekit_torch.parallel.data_parallel import rank_slice
    from plumekit_torch.train.state import create_state
    from plumekit_torch.train.step import make_train_step, step_generator

    group = dist.group.WORLD
    state = create_state(UNetConfig(**SMALL_UNET),
                         TrainConfig(**SMALL_TRAIN), device)
    xs, ys = (torch.from_numpy(a) for a in payload)
    part = rank_slice(xs.shape[0], group)
    step = make_train_step(0.5, augment=True, group=group)
    state, metrics = step(state, xs[part].to(device), ys[part].to(device),
                          step_generator(0, 0, device))
    # on the rank's device: NCCL gathers no host tensor
    flat = torch.cat([t.detach().double().reshape(-1)
                      for t in state.model.state_dict().values()])
    everyone = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(everyone, flat)
    return {"loss": float(metrics["loss"]),
            "same": all(torch.equal(everyone[0], e) for e in everyone)}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One data-parallel train step over ``n_devices`` ranks
    (:func:`plumekit_torch.parallel.launch`: NCCL on ``n_devices`` distinct
    cards, gloo ranks on the CPU) and one spatially sharded forward with halo
    exchange over the (y, x) grid of a ``(data, y, x)`` mesh of
    ``n_devices`` slots, on tiny shapes. Raises on a non-finite loss,
    ranks that disagree, or non-finite probabilities; returns a summary
    (the mesh, the loss, the sharded forward's image and probabilities)."""
    from plumekit_torch.device import resolve_device
    from plumekit_torch.infer import choose_halo, make_sharded_infer
    from plumekit_torch.models import build_model, replicate_model
    from plumekit_torch.parallel import make_mesh
    from plumekit_torch.parallel.launch import launch

    device = resolve_device(device)
    devices = _devices(n_devices, device)
    data, y, x = _mesh_shape(n_devices)
    rng = np.random.default_rng(0)
    b = max(n_devices * 2, 4)
    xs = rng.random((b, 32, 32, 2), np.float32)
    ys = (rng.random((b, 32, 32, 1)) > 0.7).astype(np.float32)
    step = launch(_dp_rank, devices, ((xs, ys),))
    if not np.isfinite(step["loss"]) or not step["same"]:
        raise RuntimeError(f"data-parallel step: {step}")

    cfg = UNetConfig(**SMALL_UNET)
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    mesh = make_mesh(MeshConfig(data=data, y=y, x=x), devices)
    grid = [d for row in mesh.grid() for d in row]
    block = 32
    halo = choose_halo(8, block, cfg.depth, block_w=block)
    infer = make_sharded_infer(lambda m, t: m(t), mesh, halo)
    image = rng.random((block * y, block * x, 2), np.float32)
    with torch.inference_mode():
        probs, _mask = infer(replicate_model(model, grid),
                             torch.from_numpy(image))
    probs = probs.cpu().numpy()
    if probs.shape != (block * y, block * x) or not np.isfinite(probs).all():
        raise RuntimeError(f"sharded forward: shape {probs.shape}, finite "
                           f"{np.isfinite(probs).all()}")
    summary = {"mesh": (data, y, x), "loss": step["loss"],
               "sharded_infer": probs.shape, "image": image, "probs": probs,
               "devices": [str(d) for d in devices]}
    print(f"dryrun_multichip ok: mesh(data={data}, y={y}, x={x}) on "
          f"{summary['devices']}, loss={step['loss']:.4f}, sharded-infer "
          f"{probs.shape}")
    return summary
