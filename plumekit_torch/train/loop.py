"""Training driver of ``plumekit/train/loop.py``: synthetic (or weakly
labelled) granules → tile stream → train step → metrics CSV and step
checkpoints, with resume, periodic dev evaluation and early stopping.

Batches come from the host iterator (``tile_batches`` seeded with
``np.random.default_rng((seed, start_step))``, as in the JAX package) or,
with ``device_data``, are drawn on the device. Steps run in chunks that end
at every log, checkpoint and eval step (``steps_per_dispatch`` caps a
chunk); a step's augmentation draws from :func:`step_generator` of (seed,
step). On the host stream a stager thread draws, stacks and uploads whole
chunks two ahead of the steps (:func:`host_chunks`), as the JAX loop does;
:func:`host_batches` is the serial form, kept as the reference. With
``quantize_transfer`` the granules are encoded once
(``quantize_samples``), tiles cross as uint16 channels and uint8 masks
(``tile_batches_quant``, or a quantized card-resident set) and each step
decodes its batch on the device.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from plumekit_torch.config.train import (DataConfig, MeshConfig, TrainConfig,
                                         UNetConfig)
from plumekit_torch.device import resolve_device
from plumekit_torch.models.flops import PEAK_TFLOPS, model_flops_per_pixel
from plumekit_torch.train import checkpoint as ckpt
from plumekit_torch.train.curated import make_curated_dataset
from plumekit_torch.train.distill import distill_samples
from plumekit_torch.io.prefetch import device_prefetch, make_device_put
from plumekit_torch.ops.quant import uint16_bits
from plumekit_torch.train.data import (make_synthetic_dataset,
                                       make_weak_label_dataset,
                                       quantize_samples, tile_batches,
                                       tile_batches_quant)
from plumekit_torch.train.device_data import (build_device_dataset,
                                              make_device_multi_step)
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_eval_step, make_multi_train_step
from plumekit_torch.utils import MetricsWriter, get_logger, timers

logger = get_logger(__name__)


def chunk_schedule(start: int, total: int, k_max: int, intervals):
    """Chunk sizes from ``start`` to ``total``: ``min(k_max, distance to
    the next multiple of any interval or to total)``."""
    intervals = [iv for iv in intervals if iv and iv > 0]
    done = start
    while done < total:
        nxt = min([(done // iv + 1) * iv for iv in intervals] + [total])
        c = min(k_max, nxt - done)
        yield c
        done += c


def host_batches(samples, tile: int, batch_size: int, rng, device):
    """The host tile stream handed to ``device`` in order, drawn on the
    calling thread: each batch is copied from pinned memory without
    blocking the host. The serial reference of :func:`host_chunks`."""
    pin = torch.device(device).type == "cuda"
    for xs, ys in tile_batches(samples, tile, batch_size, rng):
        xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
        if pin:
            xs, ys = xs.pin_memory(), ys.pin_memory()
        yield (xs.to(device, non_blocking=True),
               ys.to(device, non_blocking=True))


def _stacked(batches):
    """(K, B, ...) arrays of K batches (a view when K is 1); uint16 codes
    as their int16 bits, the form they are uploaded in."""
    out = []
    for part in zip(*batches):
        a = part[0][None] if len(part) == 1 else np.stack(part)
        out.append(uint16_bits(a) if a.dtype == np.uint16 else a)
    return tuple(out)


def host_chunks(samples, tile: int, batch_size: int, rng, device, sizes,
                quantize: bool = False, buffer_size: int = 2,
                part: slice = slice(None)):
    """The host tile stream as the loop takes it: for each chunk size K of
    ``sizes``, K batches of ``tile_batches`` (``tile_batches_quant`` with
    ``quantize``, over ``quantize_samples`` output) stacked into (K, B, ...)
    tensors on ``device``. A stager thread draws, stacks and uploads them
    ``buffer_size`` chunks ahead (``io/prefetch.device_prefetch``). Under
    data parallelism every rank draws the global batches of ``batch_size``
    and stacks and uploads only its ``part`` of each. With the recorder on
    (``utils/timers``) each chunk's draw and stack is a ``train.draw``
    span on the stager thread."""
    draw = (tile_batches_quant if quantize else tile_batches)(
        samples, tile, batch_size, rng)

    def chunks():
        for k in sizes:
            with timers.span("train.draw", steps=k):
                chunk = _stacked([tuple(a[part] for a in next(draw))
                                  for _ in range(k)])
            yield chunk

    return device_prefetch(chunks(), buffer_size=buffer_size,
                           device_put=make_device_put(device))


def _data_parallel_group(mesh_cfg: Optional[MeshConfig], batch: int):
    """The process group of a data-parallel run (None for one process):
    ``mesh_cfg.data`` ranks, already joined (``parallel/launch.py``), over
    which the batch divides."""
    if mesh_cfg is None or mesh_cfg.n_devices <= 1:
        return None
    if mesh_cfg.y != 1 or mesh_cfg.x != 1:
        raise ValueError("training shards the batch over the data axis "
                         f"only; got {mesh_cfg}")
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError(
            f"data-parallel training over {mesh_cfg.data} ranks needs a "
            "joined process group (plumekit_torch.parallel.launch)")
    if dist.get_world_size() != mesh_cfg.data:
        raise ValueError(f"mesh data axis {mesh_cfg.data} but the process "
                         f"group has {dist.get_world_size()} ranks")
    if batch % mesh_cfg.data:
        raise ValueError(f"batch size {batch} does not divide over "
                         f"{mesh_cfg.data} ranks")
    return dist.group.WORLD


def train(unet_cfg: UNetConfig = UNetConfig(),
          train_cfg: TrainConfig = TrainConfig(),
          data_cfg: DataConfig = DataConfig(), weak_labels: bool = False,
          device="cuda", curated_dir: Optional[str] = None,
          mesh_cfg: Optional[MeshConfig] = None
          ) -> Dict[str, List[float]]:
    """Run the supervised loop on ``device``; returns the metric history.
    ``weak_labels`` trains on the rg detector's masks instead of synthetic
    ground truth; ``curated_dir`` (``prepare_model_data``'s samples)
    overrides both, holding out its last sample as the dev set when it has
    4 or more. With ``train_cfg.distill_from`` the training samples (not
    the dev set) are relabelled by that teacher first. The run resumes from
    the newest step checkpoint in ``train_cfg.checkpoint_dir`` (a step-0
    checkpoint starts it from given weights).

    With ``mesh_cfg.data`` D > 1 this process is one rank of a D-rank
    process group (``parallel/launch.launch``), ``device`` its device, and
    ``train_cfg.batch_size`` the global batch: every rank draws the same
    global batches and keeps its part, the step is the data-parallel one
    (``train/step.make_train_step``), the parameters start equal to rank
    0's and stay equal, every rank restores a resumed run, and rank 0 alone
    writes ``model_config.json``, the checkpoints and the metrics and logs
    them. The history equals the one-process run's."""
    if unet_cfg.prune_level is not None:
        raise ValueError(
            "prune_level is serving-only; train with the full depth")
    group = _data_parallel_group(mesh_cfg, train_cfg.batch_size)
    part, lead = slice(None), True
    if group is not None:
        from plumekit_torch.parallel import data_parallel as dp

        part = dp.rank_slice(train_cfg.batch_size, group)
        lead = dp.world(group)[0] == 0
    device = resolve_device(device)
    state = create_state(unet_cfg, train_cfg, device)

    start_step = 0
    last = ckpt.latest_step(train_cfg.checkpoint_dir)
    if lead:
        ckpt.save_model_config(train_cfg.checkpoint_dir, unet_cfg)
    if last is not None and last <= train_cfg.total_steps:
        ckpt.restore_checkpoint(train_cfg.checkpoint_dir, state, last)
        start_step = last
        if lead:
            logger.info("resumed from checkpoint step %d", last)
    if group is not None:
        dp.broadcast_state(state.model, group)

    if curated_dir:
        samples = make_curated_dataset(curated_dir)
        if len(samples) >= 4:
            train_set, eval_set = samples[:-1], samples[-1:]
        else:
            train_set = eval_set = samples
        if lead:
            logger.info("curated dataset: %d train / %d eval "
                        "granule-layers", len(train_set), len(eval_set))
    elif weak_labels:
        train_set = make_weak_label_dataset(data_cfg, True, device=device)
        eval_set = make_weak_label_dataset(data_cfg, False, device=device)
    else:
        train_set = make_synthetic_dataset(data_cfg, train=True)
        eval_set = make_synthetic_dataset(data_cfg, train=False)
    if train_cfg.distill_from:
        # one teacher pass per training granule, before the stream starts;
        # the dev set keeps its labels, so dev IoU stays comparable
        train_set = distill_samples(
            train_set, train_cfg.distill_from,
            alpha=train_cfg.distill_alpha,
            temperature=train_cfg.distill_temp,
            prune_level=train_cfg.distill_prune_level,
            infer_cfg=train_cfg.distill_infer, tta=train_cfg.distill_tta,
            calibrate_threshold=train_cfg.distill_calibrate, device=device)

    tile, batch = train_cfg.tile_size, train_cfg.batch_size
    quantize = train_cfg.quantize_transfer
    eval_fn = make_eval_step(train_cfg.dice_weight, group)
    intervals = [train_cfg.log_every, train_cfg.eval_every,
                 train_cfg.checkpoint_every]
    k_max = max(1, train_cfg.steps_per_dispatch)
    device_fn = chunks = None
    if train_cfg.device_data:
        device_set = build_device_dataset(train_set, tile, device,
                                          quantized=quantize)
        device_fn = make_device_multi_step(
            train_cfg.dice_weight, train_cfg.augment, train_cfg.label_smooth,
            seed=train_cfg.seed, tile=tile, batch_size=batch, group=group)
        nbytes = sum(t.numel() * t.element_size() for t in device_set
                     if t is not None)
        if lead:
            logger.info("device-resident dataset: %d granules, %.1f MB",
                        device_set.channels.shape[0], nbytes / 1e6)
    else:
        if quantize:
            # encoded once, off the step's path; the float copy is dropped
            train_set = quantize_samples(train_set)
        multi_fn = make_multi_train_step(
            train_cfg.dice_weight, train_cfg.augment, train_cfg.label_smooth,
            seed=train_cfg.seed, dequant=quantize, group=group)
        # the stager walks its own instance of the loop's chunk schedule
        chunks = host_chunks(
            train_set, tile, batch,
            np.random.default_rng((train_cfg.seed, start_step)), device,
            chunk_schedule(start_step, train_cfg.total_steps, k_max,
                           intervals), quantize=quantize, part=part)
    # under data parallelism each rank evaluates its part of every dev
    # batch and the IoU sums are reduced: every rank reads the same dev IoU
    # and makes the same early-stop and best-state decision
    eval_batches = [
        (torch.from_numpy(xs[part]).to(device),
         torch.from_numpy(ys[part]).to(device))
        for xs, ys in tile_batches(eval_set, tile, batch,
                                   np.random.default_rng(1), steps=4)]

    def dev_iou() -> float:
        return float(np.mean([float(eval_fn(state, xs, ys)["iou"])
                              for xs, ys in eval_batches]))

    history: Dict[str, List[float]] = {"loss": [], "iou": [], "eval_iou": [],
                                       "eval_steps": [],
                                       "eval_iou_curve": []}
    writer = (MetricsWriter(train_cfg.checkpoint_dir.rstrip("/")
                            + "_metrics.csv") if lead else None)
    px_per_step = batch * tile * tile
    flops_per_step = 3.0 * model_flops_per_pixel(unet_cfg) * px_per_step
    best_dev, best_step, misses, best_state = -1.0, -1, 0, None
    last_log_step = done = start_step
    t0 = time.perf_counter()
    for k in chunk_schedule(start_step, train_cfg.total_steps, k_max,
                            intervals):
        if device_fn is not None:
            state, metrics = device_fn(state, device_set,
                                       range(done, done + k))
        else:
            state, metrics = multi_fn(state, next(chunks),
                                      range(done, done + k))
        done += k
        if train_cfg.log_every and done % train_cfg.log_every == 0:
            loss, iou = float(metrics["loss"]), float(metrics["iou"])
            dt = time.perf_counter() - t0
            steps = done - last_log_step
            mpix_s = px_per_step * steps / dt / 1e6
            tflops = flops_per_step * steps / dt / 1e12
            last_log_step = done
            rate = f"{tflops:.1f} TFLOP/s"
            if device.type == "cuda":
                rate += (f", {100.0 * tflops / PEAK_TFLOPS['bf16']:.1f}% of "
                         f"the H100's {PEAK_TFLOPS['bf16']:.0f} bf16 peak")
            history["loss"].append(loss)
            history["iou"].append(iou)
            if lead:
                logger.info("step %d loss=%.4f iou=%.3f %.2f MPix/s (%s)",
                            done, loss, iou, mpix_s, rate)
                writer.write(done, {"loss": loss, "iou": iou,
                                    "mpix_s": mpix_s})
            t0 = time.perf_counter()
        if (lead and train_cfg.checkpoint_every
                and done % train_cfg.checkpoint_every == 0):
            ckpt.save_checkpoint(train_cfg.checkpoint_dir, state, done)

        # dev-set early stopping: weak labels overfit, dev IoU peaks and
        # then degrades; keep the peak
        if train_cfg.eval_every and done % train_cfg.eval_every == 0:
            dev = dev_iou()
            history["eval_steps"].append(done)
            history["eval_iou_curve"].append(dev)
            if dev > best_dev:
                best_dev, best_step, misses = dev, done, 0
                best_state = copy.deepcopy(state.state_dict())
            else:
                misses += 1
            if lead:
                logger.info("dev IoU %.3f @ step %d (best %.3f @ %d)",
                            dev, done, best_dev, best_step)
            if (train_cfg.early_stop_patience
                    and misses >= train_cfg.early_stop_patience):
                if lead:
                    logger.info("early stop: no dev improvement in %d "
                                "evals", misses)
                break
    if chunks is not None:
        chunks.close()      # stops the stager and drops its staged chunks

    restored_best = bool(train_cfg.eval_every) and best_state is not None
    if restored_best:
        # serve the peak: persist it at its own step and drop the later
        # interval checkpoints, so latest_step is the peak and a resume
        # continues from it
        state.load_state_dict(best_state)
        if lead:
            ckpt.prune_after(train_cfg.checkpoint_dir, best_step)
            ckpt.save_checkpoint(train_cfg.checkpoint_dir, state, best_step,
                                 overwrite=True)
            logger.info("restored best dev state (step %d, IoU %.3f)",
                        best_step, best_dev)
    if lead and not restored_best and start_step < train_cfg.total_steps:
        if (ckpt.latest_step(train_cfg.checkpoint_dir) or 0) < done:
            # a run shorter than checkpoint_every ends with its state saved
            ckpt.save_checkpoint(train_cfg.checkpoint_dir, state, done)
        else:
            ckpt.save_weights(train_cfg.checkpoint_dir, state.model)
    history["eval_iou"].append(dev_iou())
    if train_cfg.eval_every:
        history["best_dev_iou"] = [best_dev]
        history["best_dev_step"] = [float(best_step)]
    if lead:
        logger.info("final eval IoU: %.3f%s", history["eval_iou"][-1],
                    "" if train_cfg.eval_every else
                    " (eval_every=0: a smoke value, not a trained-quality "
                    "metric)")
    if group is not None:
        # no rank returns before rank 0's files are written: a resume in
        # the same group reads them
        import torch.distributed as dist

        dist.barrier(group)
    return history


__all__ = ["chunk_schedule", "host_batches", "host_chunks", "train"]
