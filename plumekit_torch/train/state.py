"""Train state of ``plumekit/train/state.py``: fp32 master parameters and
batch-norm buffers in the model, AdamW with a linear warmup and a cosine
decay.

optax's ``adamw`` there masks nothing, so weight decay (decoupled) applies
to every parameter, norm scales and shifts and biases included; optax
evaluates the schedule at the update count before the update, so the first
update runs at lr 0. ``LambdaLR`` over :func:`make_schedule` gives the same
sequence: optimizer step ``i`` (from 0) runs at ``schedule(i)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from plumekit_torch.config.train import TrainConfig, UNetConfig


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: 0 → ``learning_rate`` over
    ``warmup_steps``, then a cosine down to 0.05·``learning_rate`` at step
    ``max(total_steps, warmup_steps + 1)``, flat after it."""
    peak = cfg.learning_rate
    warmup = cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else 0.05

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        count = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass
class TrainState:
    """The model (parameters and batch-norm buffers), its optimizer and lr
    scheduler, and the number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def create_state(unet_cfg: UNetConfig, train_cfg: TrainConfig,
                 device) -> TrainState:
    """Model on ``device`` in train mode, initialised from a generator
    seeded by ``train_cfg.seed``, and its optimizer."""
    from plumekit_torch.models import build_model

    model = build_model(unet_cfg, torch.Generator().manual_seed(
        train_cfg.seed)).to(device).train()
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=train_cfg.learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=train_cfg.weight_decay)
    schedule = make_schedule(train_cfg)
    peak = train_cfg.learning_rate
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / peak if peak else 0.0)
    return TrainState(model, optimizer, scheduler)


__all__ = ["TrainState", "create_state", "make_schedule"]
