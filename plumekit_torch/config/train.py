"""The model and serving configs of ``plumekit/config/train.py``: the same
fields and defaults, so a ``model_config.json`` reads the same in both
packages."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class UNetConfig:
    """U-Net: double-conv encoder blocks, transposed-conv upsampling, skip
    concatenations, fp32 1×1 head."""

    in_channels: int = 2          # AOD + rasterised fire channel
    out_channels: int = 1         # plume logit
    base_features: int = 32
    depth: int = 4                # number of down/up stages
    norm: str = "batch"           # "batch" | "group" | "none"
    group_norm_groups: int = 8
    #: "unet" or "unetpp" (UNet++, not ported yet)
    arch: str = "unet"
    #: UNet++ only
    deep_supervision: bool = False
    #: UNet++ deep supervision only, serving time
    prune_level: int | None = None
    #: compute dtype; parameters stay fp32 masters
    compute_dtype: str = "bfloat16"
    #: inference through the hand-written fused double-conv kernel
    #: (``models/kernels/fused_conv.py``) instead of the plain forward
    use_pallas: bool = False
    #: whole-forward megakernel (not ported yet)
    use_mega: bool = False


@dataclass(frozen=True)
class InferConfig:
    """Sliding-window full-granule inference."""

    tile_size: int = 288
    overlap: int = 32             # blended overlap between adjacent tiles
    batch_tiles: int = 64         # tiles per forward
    threshold: float = 0.5        # mask = sigmoid(logit) > threshold
    #: probability-plane dtype of the returned canvas: "float" (fp32) or
    #: "uint8" (p8 = rint(p·255)); the uint8 mask compares p8 against
    #: ⌊threshold·255⌋
    emit: str = "float"
