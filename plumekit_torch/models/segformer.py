"""SegFormer: the MiT encoder and the all-MLP decode head (Xie et al.,
NeurIPS 2021, arXiv:2105.15203), configured by
:class:`plumekit_torch.config.segformer.SegFormerConfig`.

The interface is the U-Net's: ``SegFormer(cfg)(x)`` takes NHWC tiles (N, H,
W, in_channels) with H and W divisible by ``cfg.total_stride`` and returns
fp32 logits (N, H, W, out_channels). Inside, tokens stay NHWC, so every
linear layer is a product over the last dimension; convolutions see the
same memory as NCHW views in the channels-last format. Parameters are fp32
masters cast to the compute dtype per forward; LayerNorm takes its
statistics in fp32 (PyTorch's kernel accumulates a bf16 input in fp32), the
attention's softmax runs in fp32 inside the fused kernel, and the head's
last upsample is fp32.

Per stage i: an overlapped patch embedding (conv k×k, stride s, padding
k//2, then LayerNorm), ``depths[i]`` blocks ``x += Attn(LN₁ x)``,
``x += MixFFN(LN₂ x)``, and a LayerNorm. Attention is the efficient
self-attention: queries from every token, keys and values from the tokens
reduced by a conv of kernel and stride ``sr`` and a LayerNorm where
``sr > 1``, softmax(q kᵀ / √64) v over C/64 heads, then an output
projection; it runs through ``F.scaled_dot_product_attention``, and on the
card with the math backend excluded, so that a shape no fused kernel takes
raises instead of materialising the scores. Mix-FFN is Linear C→4C, a
depthwise 3×3 conv, exact GELU, Linear 4C→C. The head maps each stage to
``decoder_hidden_size`` channels, upsamples bilinearly to H/4
(``align_corners=False``), concatenates [c4, c3, c2, c1], applies a 1×1
conv without bias, batch norm and ReLU, the 1×1 classifier, and upsamples
the logits ×4 back to the tile. In eval mode the batch norm is folded into
the 1×1 conv. Departure: every LayerNorm takes the config's
``layer_norm_eps`` (1e-6, the original MiT's norm); Hugging Face's module
builds its LayerNorms at torch's default 1e-5.

Parameter names are those of Hugging Face's
``SegformerForSemanticSegmentation`` state dict (``segformer.encoder.
patch_embeddings.{i}.proj``, ``segformer.encoder.block.{i}.{j}.attention.
self.query``, ``... .mlp.dwconv.dwconv``, ``decode_head.linear_c.{i}.proj``,
``decode_head.linear_fuse``, ``decode_head.batch_norm``,
``decode_head.classifier``), so that a converted public checkpoint loads.

With the recorder on (``utils/timers``), a forward records the span
``segformer.forward`` (device ms, ``tiles``), inside it one
``segformer.stage`` per stage (``stage`` 1..4, device ms) and
``segformer.decode`` (device ms), and the counters ``segformer.forwards``
and ``segformer.tiles``.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from plumekit_torch.config.segformer import SegFormerConfig
from plumekit_torch.models.unet import DTYPES
from plumekit_torch.utils import timers


def _as(t: torch.Tensor, x: torch.Tensor):
    return None if t is None else t.to(x.dtype)


def _linear(x, layer: nn.Linear):
    return F.linear(x, _as(layer.weight, x), _as(layer.bias, x))


def _layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, norm.normalized_shape, _as(norm.weight, x),
                        _as(norm.bias, x), norm.eps)


def _conv_nhwc(x, conv: nn.Conv2d):
    """``conv`` over NHWC ``x`` (the NCHW view in the channels-last
    format), NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), _as(conv.weight, x),
                 _as(conv.bias, x), conv.stride, conv.padding, 1,
                 conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _upsample_nhwc(x, size):
    """Bilinear resize of NHWC ``x`` to ``size`` (align_corners False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def attention_backends(device: torch.device):
    """The scaled-dot-product backends the forward allows on ``device``:
    on the card the fused kernels only (flash, memory-efficient), so that a
    shape they cannot take raises instead of falling to the math backend,
    which would materialise every score; elsewhere PyTorch's own choice."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION])


class OverlapPatchEmbed(nn.Module):
    def __init__(self, patch: int, stride: int, cin: int, c: int,
                 eps: float):
        super().__init__()
        self.proj = nn.Conv2d(cin, c, patch, stride, padding=patch // 2)
        self.layer_norm = nn.LayerNorm(c, eps=eps)

    def forward(self, x):
        return _layer_norm(_conv_nhwc(x, self.proj), self.layer_norm)


class EfficientSelfAttention(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.sr_ratio = sr
        if sr > 1:
            self.sr = nn.Conv2d(c, c, sr, sr)
            self.layer_norm = nn.LayerNorm(c, eps=eps)

    def forward(self, x):
        n, h, w, c = x.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(n, -1, self.heads, d).transpose(1, 2)

        kv = x
        if self.sr_ratio > 1:
            kv = _layer_norm(_conv_nhwc(x, self.sr), self.layer_norm)
        o = F.scaled_dot_product_attention(heads(_linear(x, self.query)),
                                           heads(_linear(kv, self.key)),
                                           heads(_linear(kv, self.value)))
        return o.transpose(1, 2).reshape(n, h, w, c)


class _Attention(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, eps: float):
        super().__init__()
        self.self = EfficientSelfAttention(c, heads, sr, eps)
        self.output = nn.Module()
        self.output.dense = nn.Linear(c, c)

    def forward(self, x):
        return _linear(self.self(x), self.output.dense)


class MixFFN(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(c, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, 1, 1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, c)

    def forward(self, x):
        h = _conv_nhwc(_linear(x, self.dense1), self.dwconv.dwconv)
        return _linear(F.gelu(h), self.dense2)


class Block(nn.Module):
    def __init__(self, c: int, heads: int, sr: int, mlp_ratio: int,
                 eps: float):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(c, eps=eps)
        self.attention = _Attention(c, heads, sr, eps)
        self.layer_norm_2 = nn.LayerNorm(c, eps=eps)
        self.mlp = MixFFN(c, c * mlp_ratio)

    def forward(self, x):
        x = x + self.attention(_layer_norm(x, self.layer_norm_1))
        return x + self.mlp(_layer_norm(x, self.layer_norm_2))


class Encoder(nn.Module):
    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        cins = (cfg.in_channels,) + cfg.hidden_sizes[:-1]
        self.patch_embeddings = nn.ModuleList([
            OverlapPatchEmbed(p, s, cin, c, eps) for p, s, cin, c in zip(
                cfg.patch_sizes, cfg.strides, cins, cfg.hidden_sizes)])
        self.block = nn.ModuleList([
            nn.ModuleList([Block(c, heads, sr, r, eps) for _ in range(d)])
            for c, heads, sr, r, d in zip(
                cfg.hidden_sizes, cfg.num_attention_heads, cfg.sr_ratios,
                cfg.mlp_ratios, cfg.depths)])
        self.layer_norm = nn.ModuleList([nn.LayerNorm(c, eps=eps)
                                         for c in cfg.hidden_sizes])

    def forward(self, x) -> List[torch.Tensor]:
        """The four stages' NHWC outputs of NHWC ``x``."""
        out = []
        for i, (embed, blocks, norm) in enumerate(zip(
                self.patch_embeddings, self.block, self.layer_norm)):
            with timers.span("segformer.stage", device=x.device,
                             stage=i + 1):
                x = embed(x)
                for block in blocks:
                    x = block(x)
                x = _layer_norm(x, norm)
            out.append(x)
        return out


class DecodeHead(nn.Module):
    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList()
        for c in cfg.hidden_sizes:
            mlp = nn.Module()
            mlp.proj = nn.Linear(c, d)
            self.linear_c.append(mlp)
        n = len(cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(n * d, d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d)
        self.classifier = nn.Conv2d(d, cfg.out_channels, 1)

    def folded(self):
        """The 1×1 fuse conv with the eval batch norm folded in: fp32
        (weight (d, n·d), bias (d,))."""
        bn = self.batch_norm
        scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        weight = self.linear_fuse.weight[:, :, 0, 0] * scale[:, None]
        return weight, bn.bias - bn.running_mean * scale

    def forward(self, features: List[torch.Tensor], size) -> torch.Tensor:
        """fp32 NHWC logits at ``size`` of the stages' NHWC outputs."""
        x1 = features[0]
        n, h, w = x1.shape[:3]
        d = self.linear_fuse.out_channels
        cat = torch.empty((n, h, w, len(features) * d), dtype=x1.dtype,
                          device=x1.device)
        # written in place, branch by branch, in the published order
        # [c4, c3, c2, c1]; a branch is upsampled a few tiles at a time, as
        # the channels-last resize kernel writes fewer than 2^31 elements
        step = max(1, (2**31 - 1) // (d * h * w))
        for k, i in enumerate(reversed(range(len(features)))):
            y = _linear(features[i], self.linear_c[i].proj)
            for a in range(0, n, step):
                part = y[a:a + step]
                if part.shape[1:3] != (h, w):
                    part = _upsample_nhwc(part, (h, w))
                cat[a:a + step, ..., k * d:(k + 1) * d] = part
            del y
        weight, bias = self.folded()
        fused = torch.relu(F.linear(cat, weight.to(cat.dtype),
                                    bias.to(cat.dtype)))
        del cat
        cls = self.classifier
        logits = F.linear(fused, cls.weight[:, :, 0, 0].to(fused.dtype),
                          cls.bias.to(fused.dtype))
        return _upsample_nhwc(logits.float(), size).contiguous()


class SegFormer(nn.Module):
    """SegFormer over NHWC tensors; eval mode only (training is not
    ported)."""

    def __init__(self, cfg: SegFormerConfig = SegFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.segformer = nn.Module()
        self.segformer.encoder = Encoder(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "the SegFormer's train mode (batch statistics in the head, "
                "a loss) is not ported: ROADMAP S.1; call .eval()")
        n, size = x.shape[0], tuple(x.shape[1:3])
        if size[0] % self.cfg.total_stride or size[1] % self.cfg.total_stride:
            raise ValueError(f"tile {size} is not a multiple of the "
                             f"SegFormer's total stride "
                             f"{self.cfg.total_stride}")
        timers.count("segformer.forwards")
        timers.count("segformer.tiles", n)
        with timers.span("segformer.forward", device=x.device, tiles=n), \
                attention_backends(x.device):
            x = x.to(DTYPES[self.cfg.compute_dtype]).contiguous()
            features = self.segformer.encoder(x)
            with timers.span("segformer.decode", device=x.device):
                return self.decode_head(features, size)
