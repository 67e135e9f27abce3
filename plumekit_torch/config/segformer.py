"""The SegFormer's model config (Xie et al., *SegFormer: Simple and
Efficient Design for Semantic Segmentation with Transformers*, NeurIPS 2021,
arXiv:2105.15203). The defaults are the widths and depths of SegFormer-B5
as Hugging Face's ``nvidia/segformer-b5-finetuned-cityscapes-1024-1024``
publishes them, with the port's two input channels (AOD, fire density; the
published ``num_channels`` is 3) and one output, the plume logit (the
published ``num_labels`` is 19). The field names are that config's, so a
``model_config.json`` reads like it."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class SegFormerConfig:
    """MiT encoder (four stages of overlapped patch embedding, efficient
    self-attention and Mix-FFN blocks) and the all-MLP decode head."""

    arch: str = "segformer"
    in_channels: int = 2          # AOD + rasterised fire channel
    out_channels: int = 1         # plume logit
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 6, 40, 3)
    num_attention_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    decoder_hidden_size: int = 768
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    #: compute dtype; parameters stay fp32 masters
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        # a model_config.json holds lists; the config is hashable either way
        for name in ("hidden_sizes", "depths", "num_attention_heads",
                     "sr_ratios", "patch_sizes", "strides", "mlp_ratios"):
            value = tuple(int(v) for v in getattr(self, name))
            if len(value) != 4:
                raise ValueError(f"{name} needs one entry per stage (4), "
                                 f"got {value}")
            object.__setattr__(self, name, value)
        if self.total_stride & (self.total_stride - 1):
            raise ValueError(f"strides {self.strides} multiply to "
                             f"{self.total_stride}, not a power of two")
        if self.arch != "segformer":
            raise ValueError(f"a SegFormerConfig's arch is 'segformer', not "
                             f"{self.arch!r}")
        if self.hidden_act != "gelu":
            raise ValueError(f"hidden_act {self.hidden_act!r}: the port "
                             "builds the published exact GELU only")
        for c, h in zip(self.hidden_sizes, self.num_attention_heads):
            if c % h:
                raise ValueError(f"hidden size {c} does not split into {h} "
                                 "heads")

    @property
    def total_stride(self) -> int:
        """Input pixels a side of one pixel of the last stage."""
        return math.prod(self.strides)

    @property
    def depth(self) -> int:
        """log2 of the total stride: the stream pads a granule to a
        multiple of ``2**depth``, as it does for a U-Net of that depth."""
        return int(math.log2(self.total_stride))
