"""Configs, copied from ``plumekit.config`` (which imports JAX)."""

from plumekit_torch.config.paths import PathsConfig
from plumekit_torch.config.train import InferConfig, UNetConfig

__all__ = ["InferConfig", "PathsConfig", "UNetConfig"]
