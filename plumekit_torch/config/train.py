"""The model, training, data and serving configs of
``plumekit/config/train.py``: the same fields and defaults, so a
``model_config.json`` and a training call read the same in both packages."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
    #: "unet" or "unetpp" (UNet++, ``models/unetpp.py``)
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
    #: inference through the whole-forward kernel
    #: (``models/kernels/unet_mega.py``) where ``mega_eligible`` holds; read
    #: before ``use_pallas``
    use_mega: bool = False


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    tile_size: int = 512          # config 2: 512x512 multi-band tiles
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 2000
    dice_weight: float = 0.5      # loss = w*dice + (1-w)*bce
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 200
    log_every: int = 20
    augment: bool = True          # per-sample D4 flips and transposes
    #: BCE target smoothing ε (y → y·(1−2ε)+ε) — weak-label noise hedge
    label_smooth: float = 0.0
    #: evaluate the dev set every N steps (0 = only at the end)
    eval_every: int = 0
    #: stop after this many consecutive evals without dev-IoU improvement
    #: (0 = never stop early); requires eval_every > 0
    early_stop_patience: int = 0
    #: optimizer steps per chunk between host-visible boundaries; chunks
    #: never cross a log, eval or checkpoint step, and every step's data and
    #: augmentation are those of the single-step loop
    steps_per_dispatch: int = 1
    #: uint16 channels and uint8 masks across the host-to-device hop (or
    #: in the card-resident set), decoded on the device in the step
    quantize_transfer: bool = False
    #: keep the whole training set in the card's memory and draw and
    #: augment tiles there (``train/device_data.py``); the draws are
    #: counter-based in (seed, step), a different sequence from the host
    #: iterator's numpy draws
    device_data: bool = False
    #: offline distillation (``train/distill.py``): the training samples
    #: relabelled by this checkpoint's soft probabilities before training;
    #: ``distill_infer`` None serves the teacher at ``InferConfig()``
    distill_from: Optional[str] = None
    distill_alpha: float = 1.0
    distill_temp: float = 1.0
    distill_prune_level: Optional[int] = None
    distill_infer: Optional["InferConfig"] = None
    distill_tta: bool = False
    distill_calibrate: Optional[float] = None


@dataclass(frozen=True)
class DataConfig:
    """Synthetic-granule dataset."""

    granule_size: int = 1200      # a full MAIAC tile is 1200x1200
    tile_size: int = 256
    tiles_per_granule: int = 32
    n_train_granules: int = 8
    n_eval_granules: int = 2
    seed: int = 1234


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes (``plumekit_torch.parallel.mesh``): ``data`` for
    batch sharding, ``y``/``x`` for spatial sharding of the raster plane
    with halo exchange."""

    data: int = 1
    y: int = 1
    x: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.y, self.x)

    @property
    def n_devices(self) -> int:
        return self.data * self.y * self.x


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
