"""Model layer: the U-Net (``plumekit/models``)."""

from __future__ import annotations

from typing import Optional

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.unet import DoubleConv, UNet, receptive_field

__all__ = ["DoubleConv", "UNet", "build_model", "init_weights",
           "receptive_field"]


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation in place: conv and transposed-conv kernels
    from N(0, 1/fan_in) (flax's lecun-normal scale), biases 0, norms at
    identity (scale 1, shift 0, running mean 0, variance 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[1 if isinstance(m, torch.nn.Conv2d) else 0]
                fan_in *= w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                m.reset_parameters()
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.reset_running_stats()


def build_model(cfg: UNetConfig,
                generator: Optional[torch.Generator] = None) -> UNet:
    """The one place ``UNetConfig.arch`` is resolved to a module. With a
    ``generator`` the weights are initialised from it (:func:`init_weights`)."""
    if cfg.arch == "unetpp" or cfg.deep_supervision or cfg.prune_level:
        raise NotImplementedError(
            "UNet++ (arch='unetpp', deep supervision, prune levels) is not "
            "ported to plumekit_torch yet (ROADMAP.md, queue A: 'UNet++')")
    if cfg.arch != "unet":
        raise ValueError(f"unknown UNetConfig.arch {cfg.arch!r} "
                         "(expected 'unet' or 'unetpp')")
    model = UNet(cfg)
    if generator is not None:
        init_weights(model, generator)
    return model
