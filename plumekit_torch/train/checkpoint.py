"""Model checkpoints of the port: the JAX package's ``model_config.json``
beside a torch ``state_dict`` in ``weights.pt``.

Orbax ``step_*`` directories written by the JAX trainer are not read here
yet: reading them needs JAX on the reading side (ROADMAP.md, queue A:
'orbax checkpoint import'). ``plumekit_torch.convert.from_flax`` carries
restored flax variables over where JAX is at hand.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.utils import get_logger

WEIGHTS_BASENAME = "weights.pt"
logger = get_logger(__name__)


def save_model_config(ckpt_dir: str, unet_cfg: UNetConfig) -> None:
    """Persist the architecture next to its weights (atomic write)."""
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
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               tmp)
    os.replace(tmp, path)
    return path


def has_orbax_steps(ckpt_dir: str) -> bool:
    return os.path.isdir(ckpt_dir) and any(
        d.startswith("step_") and not d.endswith(".tmp")
        for d in os.listdir(ckpt_dir))


def load_weights(ckpt_dir: str, model: torch.nn.Module) -> bool:
    """Load ``weights.pt`` into ``model`` (strict); False when absent."""
    path = os.path.join(ckpt_dir, WEIGHTS_BASENAME)
    if not os.path.exists(path):
        return False
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return True
