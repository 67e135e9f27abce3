"""Fused inference forward for the U-Net (``plumekit/models/fused_forward.py``).

Replays the batch-norm U-Net with the hand-written double-conv kernel
(:mod:`plumekit_torch.models.kernels.fused_conv`) at every one of its
``2·depth + 1`` blocks, on NHWC activations in the compute dtype. The
structural ops stay plain PyTorch: 2×2 max-pool as a reshape-max, the 2×2
stride-2 transposed conv as one matmul plus a pixel shuffle, the 1×1 head
as an fp32 matmul. Inference only: running statistics, no autograd. The
BatchNorm folding and, on a card, the kernel's weight packing are done once
per model and device and again only after a parameter changed.

The forward reads one tree of tensors (:func:`fused_tree`): the blocks as
K6's op takes them, the transposed convs and the head. The live forward
builds it from the model's cache; an exported program
(:mod:`plumekit_torch.infer.export`) takes it as an input, built once when
the artifact is loaded.
"""

from __future__ import annotations

import weakref

import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.kernels.fused_conv import (
    fold_batchnorm,
    fused_double_conv3x3_op,
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


def fused_tree(model, dtype, device) -> dict:
    """The tensors the fused forward reads, on ``device``: ``blocks``, per
    double conv the six tensors of :func:`blocks_of` (folded on the CPU,
    packed for K6 on a card); ``ups``, per transposed conv its (Cin, Cout,
    2, 2) weight and bias; ``head``, the 1×1 head's (out, C0) weight and
    bias, all fp32 but the blocks."""
    blocks = blocks_of(model, dtype, device)
    if device.type == "cuda":
        blocks = [b.first.tensors + b.second.tensors for b in blocks]
    return {"blocks": list(blocks),
            "ups": [(up.weight.detach(), up.bias.detach())
                    for up in model.ups],
            "head": (model.head.weight.detach()[:, :, 0, 0].float(),
                     model.head.bias.detach().float())}


def block_channels(cfg: UNetConfig) -> list:
    """(mid, out) channels of each double conv, in the flax block order."""
    feats = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    return [(f, f) for f in feats + feats[-2::-1]]


def _double_conv(x, block, cmid: int, cout: int):
    """K6's op on one block of :func:`fused_tree`: folded on the CPU,
    packed on the card."""
    return fused_double_conv3x3_op(x.contiguous(), *block, cmid, cout)


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


def make_fused_tree_apply(cfg: UNetConfig):
    """Returns ``apply(tree, x) -> logits``: the fused forward on a
    :func:`fused_tree`, one K6 op per block; x is NHWC."""
    if cfg.norm != "batch":
        raise ValueError("fused forward requires the batch-norm U-Net")
    depth = cfg.depth
    dtype = DTYPES[cfg.compute_dtype]
    channels = block_channels(cfg)

    def apply(tree, x):
        blocks = tree["blocks"]
        x = x.to(dtype).contiguous()
        skips = []
        for i in range(depth):
            x = _double_conv(x, blocks[i], *channels[i])
            skips.append(x)
            x = _max_pool2(x)
        x = _double_conv(x, blocks[depth], *channels[depth])
        for u, skip in enumerate(reversed(skips)):
            x = _conv_transpose2(x, *tree["ups"][u])
            x = torch.cat([skip, x], dim=-1)
            x = _double_conv(x, blocks[depth + 1 + u],
                               *channels[depth + 1 + u])
        head_w, head_b = tree["head"]
        return x.float() @ head_w.t() + head_b

    return apply


def make_fused_apply(cfg: UNetConfig):
    """Returns ``apply(model, x, train=False) -> logits`` with the semantics
    of the model's forward, through the fused kernel. ``model`` is a
    batch-norm :class:`plumekit_torch.models.UNet`; x is NHWC."""
    tree_apply = make_fused_tree_apply(cfg)
    dtype = DTYPES[cfg.compute_dtype]

    @torch.no_grad()
    def apply(model, x, train: bool = False):
        if train:
            raise ValueError("fused forward is inference-only")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {x.device}")
        return tree_apply(fused_tree(model, dtype, x.device), x)

    return apply
