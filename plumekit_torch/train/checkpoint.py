"""Model checkpoints of the port (``plumekit/train/checkpoint.py``).

A checkpoint directory holds the JAX package's ``model_config.json``,
``weights.pt`` (the model's ``state_dict``, what ``predict_model``
serves) and the trainer's step checkpoints ``step_<8 digits>.pt`` (model,
optimizer and scheduler state and the step). Each file is written to a
temporary sibling and moved in place with ``os.replace``, so a reader sees
the old file or the new one and never half of one; a crash leaves at most
a temporary file, which readers ignore and the next writer removes.

Orbax ``step_*`` directories written by the JAX trainer are not read here:
reading them needs JAX and orbax. ``python tools/orbax_to_torch.py
CKPT_DIR OUT_DIR [--step N]``, run where ``plumekit`` is installed,
converts one into ``weights.pt`` and ``model_config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.utils import get_logger

WEIGHTS_BASENAME = "weights.pt"
_STEP = re.compile(r"step_(\d{8})\.pt$")
logger = get_logger(__name__)


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_model_config(ckpt_dir: str, unet_cfg: UNetConfig) -> None:
    """Persist the architecture next to its weights (atomic write). A
    directory that holds step checkpoints of another config is refused:
    the record is what lets serving and resume rebuild those checkpoints."""
    recorded = load_model_config(ckpt_dir)
    last = latest_step(ckpt_dir)
    if last is not None and recorded is not None and recorded != unet_cfg:
        raise ValueError(
            f"checkpoint dir {ckpt_dir!r} holds step-{last} checkpoints "
            f"trained with {recorded}; the requested config is {unet_cfg}. "
            "Pass the matching config to resume, or point checkpoint_dir "
            "at a fresh directory")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "model_config.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(unet_cfg), f, indent=1)
    os.replace(tmp, path)


def load_model_config(ckpt_dir: str):
    """The persisted :class:`UNetConfig`, or ``None`` when absent. Fields
    this code does not know are dropped with a warning."""
    path = os.path.join(ckpt_dir, "model_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    known = {f.name for f in dataclasses.fields(UNetConfig)}
    dropped = set(d) - known
    if dropped:
        logger.warning("model_config.json has unknown fields %s — ignored",
                       dropped)
    return UNetConfig(**{k: v for k, v in d.items() if k in known})


def save_weights(ckpt_dir: str, model: torch.nn.Module) -> str:
    """Write ``weights.pt`` (the model's state_dict, on the CPU) atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, WEIGHTS_BASENAME)
    _atomic_save({k: v.detach().cpu()
                  for k, v in model.state_dict().items()}, path)
    return path


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.match,
                                               os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step checkpoint of the port's trainer, or ``None``."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state, step: int,
                    overwrite: bool = False) -> None:
    """Write ``state`` (a :class:`plumekit_torch.train.state.TrainState`)
    as step ``step`` and refresh ``weights.pt`` from it. An existing step
    checkpoint is kept unless ``overwrite`` (the final save of a restored
    best state, whose step may hold the later state of an interval save)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # we are the writer: temporaries of a crashed save can go
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            try:
                os.remove(os.path.join(ckpt_dir, name))
            except OSError:
                pass
    path = _step_path(ckpt_dir, step)
    if overwrite or not os.path.exists(path):
        _atomic_save(state.state_dict(), path)
    save_weights(ckpt_dir, state.model)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load step ``step`` (default: the newest) into ``state``; returns
    ``state``, unchanged when there is no checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return state
    saved = torch.load(_step_path(ckpt_dir, step), map_location="cpu",
                       weights_only=True)
    state.load_state_dict(saved)
    return state


def prune_after(ckpt_dir: str, step: int) -> None:
    """Delete step checkpoints after ``step`` (early stopping restores the
    dev peak and drops the later interval checkpoints, so ``latest_step``
    is the peak itself)."""
    for s in _steps(ckpt_dir):
        if s > step:
            os.remove(_step_path(ckpt_dir, s))


def has_orbax_steps(ckpt_dir: str) -> bool:
    """True when ``ckpt_dir`` holds the JAX trainer's orbax ``step_*``
    directories; the port's own step checkpoints are files."""
    return os.path.isdir(ckpt_dir) and any(
        d.startswith("step_") and not d.endswith(".tmp")
        and os.path.isdir(os.path.join(ckpt_dir, d))
        for d in os.listdir(ckpt_dir))


def load_weights(ckpt_dir: str, model: torch.nn.Module) -> bool:
    """Load ``weights.pt`` into ``model`` (strict); False when absent."""
    path = os.path.join(ckpt_dir, WEIGHTS_BASENAME)
    if not os.path.exists(path):
        return False
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return True


class WorkLog:
    """Processed-item log with the reference's resume semantics
    (``plume_identifier_rg.py:557-568``), as ``plumekit.train.checkpoint.
    WorkLog``: one item per line, membership by exact line."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def done(self, item: str) -> bool:
        return item in self.items()

    def items(self) -> set:
        try:
            with open(self.path) as f:
                return set(f.read().splitlines())
        except OSError:
            return set()

    def mark(self, item: str) -> None:
        with open(self.path, "a") as f:
            f.write(item + "\n")
            f.flush()
            os.fsync(f.fileno())
