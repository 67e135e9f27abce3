"""Offline knowledge distillation of ``plumekit/train/distill.py``: the
training granules relabelled with a teacher checkpoint's soft
probabilities, ``mask' = alpha * p_teacher + (1 - alpha) * mask``, before
training. The teacher runs once per granule through the sliding-window
inference, so nothing is added to the train step; binary cross-entropy is
linear in its target, so the blend is the mixed distillation loss.

The teacher is a port checkpoint served in eval mode: a ``use_pallas``
checkpoint forwards through the fused double-conv kernel (K6), a
``use_mega`` one through the whole-forward kernel (K7), as
``predict_model`` serves them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from plumekit_torch.config.train import InferConfig
from plumekit_torch.device import resolve_device
from plumekit_torch.train.data import GranuleSample
from plumekit_torch.utils import get_logger

logger = get_logger(__name__)


def load_teacher(ckpt_dir: str, prune_level: Optional[int] = None,
                 device="cuda"):
    """A trained port checkpoint as ``(apply_fn, model, cfg)`` for serving
    on ``device``: ``model_config.json`` and ``weights.pt``, or the newest
    step checkpoint where there is no ``weights.pt``. The model holds the
    full recorded config; ``prune_level`` truncates only the served
    forward (a deep-supervised UNet++)."""
    from plumekit_torch.models import build_model
    from plumekit_torch.train import checkpoint as ckpt

    cfg = ckpt.load_model_config(ckpt_dir)
    if cfg is None:
        raise ValueError(
            f"no model_config.json under {ckpt_dir!r} — the teacher must "
            "be a plumekit_torch checkpoint directory written by "
            "train_model")
    serve_cfg = cfg if prune_level is None else dataclasses.replace(
        cfg, prune_level=prune_level)
    model = build_model(serve_cfg)
    step = ckpt.latest_step(ckpt_dir)
    if ckpt.load_weights(ckpt_dir, model):
        source = ckpt.WEIGHTS_BASENAME
    elif step is not None:
        saved = torch.load(os.path.join(ckpt_dir, f"step_{step:08d}.pt"),
                           map_location="cpu", weights_only=True)
        model.load_state_dict(saved["model"])
        source = f"step {step}"
    elif ckpt.has_orbax_steps(ckpt_dir):
        raise ValueError(
            f"{ckpt_dir} holds orbax step_* checkpoints of the JAX trainer, "
            "which plumekit_torch does not read; convert them where "
            "plumekit is installed with `python tools/orbax_to_torch.py "
            f"{ckpt_dir} OUT_DIR` and pass OUT_DIR as the teacher")
    else:
        raise ValueError(f"no checkpoints under {ckpt_dir!r}")
    logger.info("teacher: %s %s (arch=%s ds=%s prune=%s)", ckpt_dir, source,
                cfg.arch, cfg.deep_supervision, prune_level)

    def apply_fn(m, x):
        return m(x)

    return apply_fn, model.to(resolve_device(device)).eval(), serve_cfg


def distill_samples(samples: List[GranuleSample], teacher_ckpt_dir: str,
                    alpha: float = 0.7, temperature: float = 1.0,
                    prune_level: Optional[int] = None,
                    infer_cfg: Optional[InferConfig] = None,
                    tta: bool = False,
                    calibrate_threshold: Optional[float] = None,
                    device="cuda") -> List[GranuleSample]:
    """``samples`` relabelled with the teacher of ``teacher_ckpt_dir`` on
    ``device``: ``mask' = alpha * sigmoid((z - logit(t*)) / T) + (1 - alpha)
    * mask`` (the shift only with ``calibrate_threshold`` t*, recentred
    before tempering so t* maps to 0.5 at every T), D4-averaged over the
    recentred, tempered probabilities with ``tta``. ``alpha=0`` returns the
    samples without loading the teacher. Channels are untouched; the dev
    set should not pass through here."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"distill alpha must be in [0, 1], got {alpha}")
    if temperature <= 0.0:
        raise ValueError(f"distill temperature must be > 0, got "
                         f"{temperature}")
    if calibrate_threshold is not None and not 0.0 < calibrate_threshold < 1.0:
        raise ValueError(f"calibrate_threshold must be in (0, 1), got "
                         f"{calibrate_threshold}")
    if alpha == 0.0:
        logger.warning("distill_alpha=0: labels unchanged, teacher at %s "
                       "not loaded", teacher_ckpt_dir)
        return list(samples)
    device = resolve_device(device)
    apply_fn, model, cfg = load_teacher(teacher_ckpt_dir, prune_level,
                                        device)
    if samples and samples[0].channels.shape[-1] != cfg.in_channels:
        raise ValueError(
            f"teacher expects {cfg.in_channels} input channels, samples "
            f"have {samples[0].channels.shape[-1]}")

    shift = (0.0 if calibrate_threshold is None
             else float(np.log(calibrate_threshold
                               / (1.0 - calibrate_threshold))))
    if temperature != 1.0 or shift != 0.0:
        base_apply = apply_fn

        def apply_fn(m, x):     # noqa: F811
            # recentre, then temper
            return (base_apply(m, x) - shift) / temperature
    if tta:
        # after the shift: the views average the recentred probabilities
        from plumekit_torch.infer.tta import make_tta_apply

        apply_fn = make_tta_apply(apply_fn)

    from plumekit_torch.infer import make_sliding_infer
    from plumekit_torch.models.quantized_forward import full_fp32

    infer = make_sliding_infer(apply_fn, infer_cfg or InferConfig(),
                               channels=cfg.in_channels)
    out = []
    # an fp32 teacher runs in full fp32, not TF32
    with torch.inference_mode(), full_fp32():
        for s in samples:
            probs, _mask = infer(model, torch.from_numpy(
                np.ascontiguousarray(s.channels)).to(device))
            soft = probs.float().cpu().numpy()
            blended = alpha * soft + (1.0 - alpha) * s.mask.astype(np.float32)
            out.append(GranuleSample(channels=s.channels, mask=blended))
    logger.info("distilled %d granules (alpha=%.2f T=%.2f tta=%s "
                "calibrate=%s)", len(out), alpha, temperature, tta,
                calibrate_threshold)
    return out


__all__ = ["distill_samples", "load_teacher"]
