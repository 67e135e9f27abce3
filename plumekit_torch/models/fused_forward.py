"""Fused inference forward for the U-Net (``plumekit/models/fused_forward.py``).

Replays the batch-norm U-Net with the hand-written double-conv kernel
(:mod:`plumekit_torch.models.kernels.fused_conv`) at every one of its
``2·depth + 1`` blocks, on NHWC activations in the compute dtype. The
structural ops stay plain PyTorch: 2×2 max-pool as a reshape-max, the 2×2
stride-2 transposed conv as one matmul plus a pixel shuffle, the 1×1 head
as an fp32 matmul. Inference only: running statistics, no autograd.
"""

from __future__ import annotations

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.kernels.fused_conv import (
    fold_batchnorm,
    fused_double_conv3x3_bn_relu,
)
from plumekit_torch.models.unet import DTYPES


def _double_conv(x, block):
    folded = []
    for conv, bn in zip(block.conv, block.norm):
        scale, shift = fold_batchnorm(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
        folded += [conv.weight.permute(2, 3, 1, 0).to(x.dtype),  # OIHW→HWIO
                   scale.to(x.dtype), shift.to(x.dtype)]
    return fused_double_conv3x3_bn_relu(x, *folded)


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
        skips = []
        for block in model.blocks[:depth]:
            x = _double_conv(x, block)
            skips.append(x)
            x = _max_pool2(x)
        x = _double_conv(x, model.blocks[depth])
        for u, skip in enumerate(reversed(skips)):
            up = model.ups[u]
            x = _conv_transpose2(x, up.weight, up.bias)
            x = torch.cat([skip, x], dim=-1)
            x = _double_conv(x, model.blocks[depth + 1 + u])
        head = model.head
        return (x.float() @ head.weight[:, :, 0, 0].float().t()
                + head.bias.float())

    return apply
