"""Configs, copied from ``plumekit.config`` (which imports JAX)."""

from plumekit_torch.config.paths import PathsConfig
from plumekit_torch.config.train import (DataConfig, InferConfig,
                                         MeshConfig, TrainConfig, UNetConfig)

__all__ = ["DataConfig", "InferConfig", "MeshConfig", "PathsConfig",
           "TrainConfig", "UNetConfig"]
