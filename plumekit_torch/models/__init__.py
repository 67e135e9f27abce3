"""Model layer: the U-Net and UNet++ (``plumekit/models``), and the
SegFormer (``models/segformer.py``), which the JAX package does not have."""

from __future__ import annotations

from typing import Optional

import torch

from plumekit_torch.config.segformer import SegFormerConfig
from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.segformer import SegFormer
from plumekit_torch.models.unet import DoubleConv, UNet, receptive_field
from plumekit_torch.models.unetpp import UNetPP, effective_level

__all__ = ["DoubleConv", "SegFormer", "UNet", "UNetPP", "build_model",
           "effective_level", "init_weights", "receptive_field",
           "replicate_model"]


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation in place: conv, transposed-conv and linear
    kernels from N(0, 1/fan_in) (flax's lecun-normal scale), biases 0,
    norms at identity (scale 1, shift 0, running mean 0, variance 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               / m.in_features ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
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


def build_model(cfg, generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """The one place a model config is resolved to a module: a
    :class:`SegFormerConfig` to the SegFormer, a :class:`UNetConfig` by its
    ``arch``, with the JAX package's checks. With a ``generator`` the
    weights are initialised from it (:func:`init_weights`)."""
    if isinstance(cfg, SegFormerConfig):
        model = SegFormer(cfg)
        if generator is not None:
            init_weights(model, generator)
        return model
    if cfg.deep_supervision and cfg.arch != "unetpp":
        raise ValueError(
            "deep_supervision is a UNet++ mode (side heads on the nested "
            f"top-row columns); arch is {cfg.arch!r} — a silently ignored "
            "flag would also be persisted into model_config.json")
    effective_level(cfg)  # validate prune_level against arch/ds/depth
    if cfg.arch == "unetpp":
        model = UNetPP(cfg)
    elif cfg.arch == "unet":
        model = UNet(cfg)
    else:
        raise ValueError(f"unknown UNetConfig.arch {cfg.arch!r} "
                         "(expected 'unet' or 'unetpp')")
    if generator is not None:
        init_weights(model, generator)
    return model


def replicate_model(model: torch.nn.Module, devices) -> list:
    """One replica of ``model`` per entry of ``devices``: each built from
    ``model.cfg`` on the meta device (no random draw), then given storage
    on its device and ``model``'s state dict. A replica shares no tensor
    with ``model`` or with another replica, so the caches that the fused,
    megakernel and int8 forwards key on a model or a weight tensor (its
    packed weights) are its own and on its device."""
    state = model.state_dict()
    replicas = []
    for device in devices:
        with torch.device("meta"):
            replica = build_model(model.cfg)
        replica.to_empty(device=device)
        replica.load_state_dict(state)
        replicas.append(replica.train(model.training))
    return replicas
