"""Plain reference of the SegFormer forward (Xie et al., NeurIPS 2021,
arXiv:2105.15203) in fp32 PyTorch: the MiT encoder and the all-MLP decode
head, written from the paper and Hugging Face's
``SegformerForSemanticSegmentation``, with no kernel, cache or batching of
the program's. It imports nothing of ``plumekit_torch``, ``plumekit`` or
JAX. Matrix products and convolutions run in full fp32 (TF32 off for both),
LayerNorm, softmax, GELU and the head's batch norm are written out.

``weights`` maps the Hugging Face state-dict names (``segformer.encoder.
patch_embeddings.{i}.proj.weight``, ...) to fp32 tensors; ``cfg`` holds the
published widths under the config's keys (``hidden_sizes``, ``depths``,
``num_attention_heads``, ``sr_ratios``, ``patch_sizes``, ``strides``,
``decoder_hidden_size``, ``layer_norm_eps``; a mapping or an object with
those attributes). Departure from Hugging Face: every LayerNorm takes
``layer_norm_eps`` (the original MiT's 1e-6; Hugging Face builds its norms
at torch's 1e-5); the head's batch norm takes torch's 1e-5.

Two readings that a check's limits are set against live here too:
``low=True`` rounds every operand of every product, convolution and
attention product (q, k, the softmax's probabilities, v) to float8 e4m3 at
a per-tensor scale, the control; ``fault`` is ``"no_dwconv"`` (the first
block's depthwise conv of stage 1 left out) or ``"scale64"`` (stage 1's
softmax scale 1/64 instead of 1/√64).

:func:`granule_probs` serves a whole granule by its own sliding window: the
granule edge-padded onto the stride lattice, every tile's sigmoid weighted
by the separable linear taper over the overlap, the sums divided by the
summed weights."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

#: float8 e4m3's largest finite value
FP8_MAX = 448.0
#: faults the reference can read instead of the model
FAULTS = ("no_dwconv", "scale64")
#: eps of the head's batch norm (torch's BatchNorm2d)
BN_EPS = 1e-5


def _get(cfg, name):
    return cfg[name] if isinstance(cfg, dict) else getattr(cfg, name)


@contextlib.contextmanager
def exact_fp32():
    """Products and convolutions in full fp32 for the block, restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 at a per-tensor scale, back in fp32."""
    scale = (t.abs().amax() / FP8_MAX).clamp(min=1e-12)
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ops:
    """The forward's operations, each operand rounded to fp8 under
    ``low``."""

    def __init__(self, w: Dict[str, torch.Tensor], low: bool):
        self.w = w
        self.q = fp8 if low else (lambda t: t)

    def conv(self, x, name, stride=1, padding=0, groups=1, bias=True):
        return F.conv2d(self.q(x), self.q(self.w[name + ".weight"]),
                        self.w[name + ".bias"] if bias else None, stride,
                        padding, 1, groups)

    def linear(self, t, name):
        """``t`` (..., C) times the layer's weight, plus its bias."""
        return self.q(t) @ self.q(self.w[name + ".weight"]).t() \
            + self.w[name + ".bias"]

    def layer_norm(self, t, name, eps):
        mean = t.mean(-1, keepdim=True)
        var = ((t - mean) ** 2).mean(-1, keepdim=True)
        return (t - mean) / torch.sqrt(var + eps) * self.w[name + ".weight"] \
            + self.w[name + ".bias"]

    def attention(self, q, k, v, scale):
        """softmax(q kᵀ · scale) v, the softmax written out."""
        s = (self.q(q) @ self.q(k).transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        return self.q(p) @ self.q(v)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _block(ops: _Ops, t, hw, b: str, c: int, heads: int, sr: int, eps,
           scale: float, dwconv: bool):
    """One block on tokens ``t`` (N, L, C) of an (h, w) plane."""
    n, length, _ = t.shape
    h, w = hw
    d = c // heads
    a = f"{b}.attention.self"
    x = ops.layer_norm(t, f"{b}.layer_norm_1", eps)
    q = ops.linear(x, f"{a}.query")
    kv = x
    if sr > 1:
        img = x.transpose(1, 2).reshape(n, c, h, w)
        kv = ops.conv(img, f"{a}.sr", stride=sr).flatten(2).transpose(1, 2)
        kv = ops.layer_norm(kv, f"{a}.layer_norm", eps)
    k, v = ops.linear(kv, f"{a}.key"), ops.linear(kv, f"{a}.value")

    def split(z):
        return z.reshape(n, -1, heads, d).transpose(1, 2)

    o = ops.attention(split(q), split(k), split(v), scale)
    o = o.transpose(1, 2).reshape(n, length, c)
    t = t + ops.linear(o, f"{b}.attention.output.dense")
    x = ops.layer_norm(t, f"{b}.layer_norm_2", eps)
    x = ops.linear(x, f"{b}.mlp.dense1")
    if dwconv:
        hidden = x.shape[-1]
        img = x.transpose(1, 2).reshape(n, hidden, h, w)
        img = ops.conv(img, f"{b}.mlp.dwconv.dwconv", padding=1,
                       groups=hidden)
        x = img.flatten(2).transpose(1, 2)
    return t + ops.linear(_gelu(x), f"{b}.mlp.dense2")


def forward(weights: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            low: bool = False, fault: Optional[str] = None) -> torch.Tensor:
    """fp32 logits (N, H, W, labels) of NHWC tiles ``x`` (N, H, W, C)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
    ops = _Ops(weights, low)
    eps = _get(cfg, "layer_norm_eps")
    size = tuple(x.shape[1:3])
    with exact_fp32():
        img = x.float().permute(0, 3, 1, 2)
        feats = []
        for i, c in enumerate(_get(cfg, "hidden_sizes")):
            p = f"segformer.encoder.patch_embeddings.{i}"
            k, s = _get(cfg, "patch_sizes")[i], _get(cfg, "strides")[i]
            img = ops.conv(img, f"{p}.proj", stride=s, padding=k // 2)
            n, _, h, w = img.shape
            t = ops.layer_norm(img.flatten(2).transpose(1, 2),
                               f"{p}.layer_norm", eps)
            heads = _get(cfg, "num_attention_heads")[i]
            scale = 1.0 / math.sqrt(c // heads)
            if fault == "scale64" and i == 0:
                scale = 1.0 / 64.0
            for j in range(_get(cfg, "depths")[i]):
                t = _block(ops, t, (h, w), f"segformer.encoder.block.{i}.{j}",
                           c, heads, _get(cfg, "sr_ratios")[i], eps, scale,
                           dwconv=not (fault == "no_dwconv" and i == j == 0))
            t = ops.layer_norm(t, f"segformer.encoder.layer_norm.{i}", eps)
            img = t.transpose(1, 2).reshape(n, c, h, w)
            feats.append(img)
        h1, w1 = feats[0].shape[2:]
        branches = []
        for i in reversed(range(len(feats))):
            y = ops.linear(feats[i].permute(0, 2, 3, 1),
                           f"decode_head.linear_c.{i}.proj")
            y = y.permute(0, 3, 1, 2)
            if y.shape[2:] != (h1, w1):
                y = F.interpolate(y, size=(h1, w1), mode="bilinear",
                                  align_corners=False)
            branches.append(y)
        y = ops.conv(torch.cat(branches, dim=1), "decode_head.linear_fuse",
                     bias=False)
        bn = {k: weights[f"decode_head.batch_norm.{k}"][:, None, None]
              for k in ("running_mean", "running_var", "weight", "bias")}
        y = (y - bn["running_mean"]) / torch.sqrt(bn["running_var"] + BN_EPS) \
            * bn["weight"] + bn["bias"]
        y = ops.conv(torch.relu(y), "decode_head.classifier")
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


def taper(tile: int, overlap: int) -> torch.Tensor:
    """1-D blend weight: a linear ramp (k / (overlap + 1), k = 1..overlap)
    over the overlap at each end, 1 in the core."""
    w = torch.ones(tile, dtype=torch.float32)
    if overlap > 0:
        ramp = torch.arange(1, overlap + 1, dtype=torch.float32) \
            / (overlap + 1)
        w[:overlap] = torch.minimum(w[:overlap], ramp)
        w[-overlap:] = torch.minimum(w[-overlap:], ramp.flip(0))
    return w


def granule_probs(weights: Dict[str, torch.Tensor], cfg,
                  channels: torch.Tensor, tile: int, overlap: int,
                  chunk: int = 4, low: bool = False,
                  fault: Optional[str] = None) -> torch.Tensor:
    """Blended probabilities (H, W) of one granule (H, W, C) on its device,
    tiles in chunks of ``chunk``."""
    h, w = channels.shape[:2]
    stride = tile - overlap
    if overlap > stride or h < tile or w < tile:
        raise ValueError("the reference serves granules of at least one "
                         "tile with overlap <= stride")
    h2 = tile + -(-(h - tile) // stride) * stride
    w2 = tile + -(-(w - tile) // stride) * stride
    dev = channels.device
    rows = torch.arange(h2, device=dev).clamp(max=h - 1)
    cols = torch.arange(w2, device=dev).clamp(max=w - 1)
    img = channels[rows][:, cols]
    origins = [(y, x) for y in range(0, h2 - tile + 1, stride)
               for x in range(0, w2 - tile + 1, stride)]
    t1 = taper(tile, overlap).to(dev)
    w2d = t1[:, None] * t1[None, :]
    canvas = torch.zeros((h2, w2), dtype=torch.float32, device=dev)
    weight = torch.zeros((h2, w2), dtype=torch.float32, device=dev)
    for at in range(0, len(origins), chunk):
        batch = origins[at:at + chunk]
        x = torch.stack([img[y:y + tile, x_:x_ + tile] for y, x_ in batch])
        p = torch.sigmoid(forward(weights, cfg, x, low, fault)[..., 0])
        for k, (y, x_) in enumerate(batch):
            canvas[y:y + tile, x_:x_ + tile] += p[k] * w2d
            weight[y:y + tile, x_:x_ + tile] += w2d
    return (canvas / weight)[:h, :w]


__all__: List[str] = ["FAULTS", "exact_fp32", "forward", "fp8",
                      "granule_probs", "taper"]
