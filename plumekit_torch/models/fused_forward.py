"""Fused inference forward for the U-Net (``plumekit/models/fused_forward.py``).

Replays the batch-norm U-Net with the hand-written double-conv kernel
(:mod:`plumekit_torch.models.kernels.fused_conv`) at every one of its
``2·depth + 1`` blocks, on NHWC activations in the compute dtype. The
structural ops stay plain PyTorch: 2×2 max-pool as a reshape-max, the 2×2
stride-2 transposed conv as one matmul plus a pixel shuffle, the 1×1 head
as an fp32 matmul. Inference only: running statistics, no autograd. The
BatchNorm folding and, on a card, the kernel's weight packing are done once
per model and device and again only after a parameter changed.
"""

from __future__ import annotations

import weakref

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.kernels.fused_conv import (
    double_conv3x3_bn_relu_ref,
    fold_batchnorm,
    fused_double_conv3x3_bn_relu_packed,
    pack_double_conv,
    state_key,
)
from plumekit_torch.models.unet import DTYPES

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fold(block, dtype):
    folded = []
    for conv, bn in zip(block.conv, block.norm):
        scale, shift = fold_batchnorm(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
        folded += [conv.weight.permute(2, 3, 1, 0).to(dtype),  # OIHW→HWIO
                   scale.to(dtype), shift.to(dtype)]
    return tuple(folded)


def blocks_of(model, dtype, device, packed=None) -> list:
    """Per double-conv block of ``model``: its folded (w1, s1, b1, w2, s2,
    b2) or, with ``packed`` (the default on a card), those packed for K6
    (:func:`fused_conv.pack_double_conv`); cached on the model under
    :func:`fused_conv.state_key`, so a forward neither folds nor packs."""
    if packed is None:
        packed = device.type == "cuda"
    key = state_key(model, device) + (dtype, packed)
    cached = _CACHE.get(model)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            blocks = [_fold(block, dtype) for block in model.blocks]
            if packed:
                blocks = [pack_double_conv(*folded) for folded in blocks]
        cached = _CACHE[model] = (key, blocks)
    return cached[1]


def _double_conv(x, block):
    if x.device.type == "cpu":
        return double_conv3x3_bn_relu_ref(x, *block)
    return fused_double_conv3x3_bn_relu_packed(x, block)


def _max_pool2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv_transpose2(x, weight, bias):
    """2×2 stride-2 transposed conv as matmul + pixel shuffle.

    weight: (Cin, Cout, 2, 2), torch's ConvTranspose2d layout, in which
    ``out[2i+di, 2j+dj] = x[i, j] @ weight[:, :, di, dj]``. (The flax kernel
    is the same array flipped in both spatial axes; ``convert`` flips it.)
    """
    b, h, w, cin = x.shape
    cout = weight.shape[1]
    k = weight.permute(0, 2, 3, 1).reshape(cin, 4 * cout).to(x.dtype)
    y = (x.reshape(-1, cin) @ k).reshape(b, h, w, 2, 2, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)
    return y + bias.to(x.dtype)


def make_fused_apply(cfg: UNetConfig):
    """Returns ``apply(model, x, train=False) -> logits`` with the semantics
    of the model's forward, through the fused kernel. ``model`` is a
    batch-norm :class:`plumekit_torch.models.UNet`; x is NHWC."""
    if cfg.norm != "batch":
        raise ValueError("fused forward requires the batch-norm U-Net")
    depth = cfg.depth
    dtype = DTYPES[cfg.compute_dtype]

    @torch.no_grad()
    def apply(model, x, train: bool = False):
        if train:
            raise ValueError("fused forward is inference-only")
        x = x.to(dtype).contiguous()
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {x.device}")
        blocks = blocks_of(model, dtype, x.device)
        skips = []
        for block in blocks[:depth]:
            x = _double_conv(x, block)
            skips.append(x)
            x = _max_pool2(x)
        x = _double_conv(x, blocks[depth])
        for u, skip in enumerate(reversed(skips)):
            up = model.ups[u]
            x = _conv_transpose2(x, up.weight, up.bias)
            x = torch.cat([skip, x], dim=-1)
            x = _double_conv(x, blocks[depth + 1 + u])
        head = model.head
        return (x.float() @ head.weight[:, :, 0, 0].float().t()
                + head.bias.float())

    return apply
