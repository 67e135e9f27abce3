"""The whole U-Net inference forward as one kernel launch (K7).

Replaces the Pallas TPU megakernel ``mega_forward`` of
``plumekit/models/pallas/unet_mega.py`` (:364): every level of the batch-norm
U-Net (double convs, 2×2 max pools, 2×2 stride-2 transposed convs with bias,
concat-free skip joins, the 1×1 fp32 head) in one launch. The CUDA kernel is
``plumekit_torch/csrc/unet_mega.cu``, a persistent cooperative kernel with one
stage per double conv and a grid-wide barrier between stages; its source note
gives the design. Weights stream from L2 and the activation pyramid lives in
one device-memory scratch buffer that the wrapper allocates; nothing between
the stages is computed by a PyTorch operator.

Numerics, mirrored exactly by the plain version :func:`mega_forward_ref`:
activations in the compute dtype, fp32 accumulation; every conv's result is
scaled, shifted and ReLU'd in fp32 and then rounded to the compute dtype,
except the last decoder block's, which stays fp32 into the fp32 head (the
per-block fused forward rounds it first); folded scales and shifts are
rounded to the compute dtype before use; the transposed conv rounds each
tap's product to the compute dtype and adds the bias in that dtype.

On the card the kernel is bf16 only, as K6 is: ``compute_dtype="float32"``
runs the plain version on the CPU and raises on the card, through
:class:`plumekit_torch.models.UNet` too: nothing gives way to another
forward under a flag that names this kernel.
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.kernels import conv_tiles
from plumekit_torch.models.kernels.conv_tiles import pack_vector, round_up
from plumekit_torch.models.kernels.fused_conv import (
    conv3x3_bn_relu_ref,
    fold_batchnorm,
    state_key,
)

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

_HEAD_OUT = 8        # the head's padded width: out_channels <= 8
_ALIGN = 256         # bytes: every packed tensor and scratch plane starts here
_PLAN_FIELDS = 32    # kPlanFields of csrc/unet_mega.cu
_POOL, _UP, _HEAD = 0, 1, 2


def mega_eligible(cfg: UNetConfig, h: int, w: int) -> bool:
    """True when the whole-forward kernel supports this config and tile
    shape: a batch-norm ``unet`` of depth >= 1 in bf16 or fp32, at most 128
    input and 8 output channels, h and w divisible by ``2**depth`` with a
    bottleneck of at least 2 px. These are the gates of the JAX package's
    ``mega_eligible`` that are about the function, so both packages route
    the same inputs; its estimate of the TPU's on-chip memory is not carried
    over. The card's kernel picks each stage's tile to fit a block's shared
    memory (:func:`conv_tiles.double_conv_tile`), so no tile size is
    refused; its device-memory scratch (about 10 bytes per input pixel and base feature
    at depth 4: 389 MB for 128 tiles of 96² at base 32) is allocated per
    call, and a batch that does not fit raises torch's out-of-memory
    error."""
    d = cfg.depth
    return (cfg.norm == "batch"
            and cfg.arch == "unet"
            and d >= 1
            and cfg.compute_dtype in ("bfloat16", "float32")
            and cfg.in_channels <= 128
            and h % (1 << d) == 0 and w % (1 << d) == 0
            and (h >> d) >= 2 and (w >> d) >= 2
            and cfg.out_channels <= _HEAD_OUT)


# ----------------------------------------------------------- folded weights

def fold_weights(model, dtype) -> dict:
    """The model's weights as the kernel uses them, by flax block order:
    ``blocks[i]`` = {w1, s1, b1, w2, s2, b2} (HWIO weights, folded BatchNorm
    scales and shifts, all rounded to ``dtype``), ``ups[u]`` = {w, b} (the
    transposed conv's (Cin, Cout, 2, 2) weight and bias in ``dtype``),
    ``head_w`` (C0, out) and ``head_b`` in fp32."""
    blocks = []
    for block in model.blocks:
        entry = {}
        for j, (conv, bn) in enumerate(zip(block.conv, block.norm), start=1):
            scale, shift = fold_batchnorm(bn.weight, bn.bias, bn.running_mean,
                                          bn.running_var, bn.eps)
            entry[f"w{j}"] = conv.weight.detach().permute(2, 3, 1, 0) \
                .to(dtype).contiguous()                      # OIHW → HWIO
            entry[f"s{j}"] = scale.detach().to(dtype)
            entry[f"b{j}"] = shift.detach().to(dtype)
        blocks.append(entry)
    ups = [{"w": up.weight.detach().to(dtype), "b": up.bias.detach().to(dtype)}
           for up in model.ups]
    head = model.head
    return {"blocks": blocks, "ups": ups,
            "head_w": head.weight.detach()[:, :, 0, 0].float().t().contiguous(),
            "head_b": head.bias.detach().float()}


# ------------------------------------------------------------ plain version

def double_conv_ref(x, blk, out_f32: bool = False):
    """(conv3×3 + scale/shift + ReLU) × 2, each result rounded to ``x.dtype``;
    with ``out_f32`` the second stays fp32."""
    y = conv3x3_bn_relu_ref(x, blk["w1"], blk["s1"], blk["b1"])
    return conv3x3_bn_relu_ref(y, blk["w2"], blk["s2"], blk["b2"],
                               out_dtype=torch.float32 if out_f32 else None)


def conv_transpose_ref(x, up):
    """2×2 stride-2 transposed conv: ``out[2i+di, 2j+dj] = x[i, j] @
    w[:, :, di, dj]``, accumulated in fp32 and rounded to ``x.dtype`` per
    tap, then the bias added in ``x.dtype``."""
    b, h, w, cin = x.shape
    cout = up["w"].shape[1]
    k = up["w"].permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    y = (x.reshape(-1, cin).float() @ k.float()).to(x.dtype)
    y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, cout) + up["b"]


def max_pool_ref(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def mega_forward_ref(weights: dict, x, head_in_f32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel on :func:`fold_weights` output:
    x (B, h, w, Cin) → fp32 logits (B, h, w, out). The compute dtype is the
    weights'. The decoder's first conv sums the skip and the upsampled half
    into one fp32 accumulator (a conv over their concatenation, skip
    channels first). ``head_in_f32=False`` rounds the last block to the
    compute dtype before the head, which the kernel must not do: the checks
    on the card hold the kernel nearer to this function as it is than to
    that variant."""
    blocks, ups = weights["blocks"], weights["ups"]
    depth = len(ups)
    x = x.to(blocks[0]["w1"].dtype)
    skips = []
    for blk in blocks[:depth]:
        x = double_conv_ref(x, blk)
        skips.append(x)
        x = max_pool_ref(x)
    x = double_conv_ref(x, blocks[depth])
    for u, skip in enumerate(reversed(skips)):
        x = torch.cat([skip, conv_transpose_ref(x, ups[u])], dim=-1)
        x = double_conv_ref(x, blocks[depth + 1 + u],
                            out_f32=(head_in_f32 and u == depth - 1))
    return x.float() @ weights["head_w"] + weights["head_b"]


# ------------------------------------------------- packing for the kernel

@dataclass
class MegaWeights:
    """One model's weights on one device: folded (for the plain version)
    and, on a card, packed into one blob with the kernel's stage table."""

    folded: dict
    blob: torch.Tensor | None = None
    #: per stage, the fields of the plan that do not depend on the batch
    #: or the tile shape
    stages: List[dict] = field(default_factory=list)
    #: (B, h, w) → (ctypes plan array, scratch elements)
    plans: Dict[Tuple[int, int, int], tuple] = field(default_factory=dict)


def _pack(folded: dict, device) -> Tuple[torch.Tensor, List[dict]]:
    """Lay the folded bf16 weights out for ``csrc/unet_mega.cu``: per stage
    (block) its two convs packed for the stage's path
    (:func:`conv_tiles.pack_conv`: w1, s1, b1, w2, s2, b2), and for a stage
    that upsamples the transposed conv as the weight stream of a one-tap
    (Cout_p32 × 4·Cup_p) product (column tap·Cup_p + co) and its bias; then
    the fp32 head (Cout_p, 8) and bias (8). Padding is zero. A decoder
    block's first conv reads the skip plane at padded channels [0, C_p) and
    the upsampled plane from C_p on, C_p the half's count rounded to 32.
    Returns the byte blob and each stage's offsets and channel counts."""
    blocks, ups = folded["blocks"], folded["ups"]
    depth = len(ups)
    pieces: List[torch.Tensor] = []
    size = 0

    def add(t: torch.Tensor) -> int:
        nonlocal size
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        offset = size
        pad = round_up(raw.numel(), _ALIGN) - raw.numel()
        pieces.append(torch.nn.functional.pad(raw, (0, pad)))
        size += raw.numel() + pad
        return offset

    pad = torch.nn.functional.pad
    stages = []
    for i, blk in enumerate(blocks):
        cin, cmid = blk["w1"].shape[2:]
        cout = blk["w2"].shape[3]
        path = conv_tiles.path_for(cmid)
        cmid_p = conv_tiles.padded_channels(path, cin, cmid)[1]
        cout_p = conv_tiles.padded_channels(path, cmid, cout)[1]
        st = {"path": path, "cin": cin, "cmid": cmid, "cmid_p": cmid_p,
              "cout": cout, "cout_p": cout_p}
        w1 = blk["w1"]
        if i <= depth:                       # encoder, bottleneck: one source
            st.update(c0=cin, c0p=round_up(cin, conv_tiles.CHUNK_K), c1=0)
            st["cin_p"] = st["c0p"]
        else:                                # decoder: skip, then upsampled
            c = cin // 2
            c_p = round_up(c, conv_tiles.CHUNK_K)
            st.update(c0=c, c0p=c_p, c1=c, cin_p=2 * c_p)
            w1 = torch.cat([pad(w1[:, :, :c], (0, 0, 0, c_p - c)),
                            pad(w1[:, :, c:], (0, 0, 0, c_p - c))], dim=2)
        w2 = pad(blk["w2"], (0, 0, 0, cmid_p - cmid))
        for j, conv in ((1, conv_tiles.pack_conv(path, w1, blk["s1"],
                                                 blk["b1"])),
                        (2, conv_tiles.pack_conv(path, w2, blk["s2"],
                                                 blk["b2"]))):
            for name, t in zip((f"w{j}t", f"s{j}", f"b{j}"), conv):
                st[name] = add(t)
        if i < depth:
            st["kind"] = _POOL
        elif i < 2 * depth:
            st["kind"] = _UP
            up = ups[i - depth]
            up_cout = up["w"].shape[1]
            up_cout_p = round_up(up_cout, conv_tiles.MMA_PAD)
            up_kp = round_up(cout, conv_tiles.CHUNK_K)
            # (Cin, Cout, 2, 2) → (1 tap, Cin, 4 · Cout_p): column
            # (2·dy + dx) · Cout_p + co
            k = pad(up["w"].permute(0, 2, 3, 1), (0, up_cout_p - up_cout))
            k = k.reshape(1, cout, 4 * up_cout_p)
            st.update(up_cout=up_cout, up_cout_p=up_cout_p, up_kp=up_kp,
                      upw=add(conv_tiles.pack_weight_stream(
                          k, up_kp, 4 * up_cout_p)),
                      upb=add(pack_vector(up["b"], up_cout_p)))
        else:
            st["kind"] = _HEAD
            hw = folded["head_w"]
            n_out = hw.shape[1]
            st.update(n_out=n_out,
                      head_w=add(pad(hw, (0, _HEAD_OUT - n_out,
                                          0, cout_p - cout))),
                      head_b=add(pad(folded["head_b"],
                                     (0, _HEAD_OUT - n_out))))
        stages.append(st)
    return torch.cat(pieces).to(device), stages


def stage_tile(st: dict, h: int, w: int) -> conv_tiles.Tile:
    """The tile of one stage over its (h, w) plane: the fused double conv's
    rule; a stage that pools its own tiles starts them at even pixels."""
    return conv_tiles.double_conv_tile(
        h, w, st["cin"], st["cmid"], st["cout"], even=st["kind"] == _POOL,
        head=st["kind"] == _HEAD)


def _plan(stages: List[dict], b: int, h: int, w: int):
    """The kernel's stage table for a (b, h, w) batch as a
    (stages, _PLAN_FIELDS) int64 array, and the scratch size in bf16
    elements. Fields: kind, H, W, src0, c0, c0p, src1, c1, Cin_p, Cmid_p,
    Cout, Cout_p, w1t, s1, b1, w2t, s2, b2, out, aux, upw, upb, up_cout,
    up_cout_p, head_w, head_b, n_out, path, th, tw, images, up_kp. Plane
    offsets are in scratch elements (-1: the network input, or no plane),
    weight offsets in bytes of the blob. A block's ``out`` plane is its
    result (the skip of an encoder level), ``aux`` the pooled or the
    upsampled plane that the next block reads; path, th, tw and images are
    :func:`stage_tile`'s choice for the stage's plane."""
    depth = (len(stages) - 1) // 2
    size = 0

    def plane(level: int, channels: int) -> int:
        nonlocal size
        offset = size
        size += round_up(b * (h >> level) * (w >> level) * channels,
                         _ALIGN // 2)
        return offset

    plan = np.zeros((len(stages), _PLAN_FIELDS), np.int64)
    skips = {}
    feed = -1                                 # the plane the next block reads
    for i, st in enumerate(stages):
        level = i if i <= depth else 2 * depth - i
        out = aux = -1
        src0, src1 = feed, -1
        if st["kind"] == _POOL:
            out = skips[level] = plane(level, st["cout"])
            aux = feed = plane(level + 1, st["cout"])
        else:
            if i > depth:
                src0, src1 = skips[level], feed
            if st["kind"] == _UP:
                out = plane(level, st["cout"])
                aux = feed = plane(level - 1, st["up_cout"])
        tile = stage_tile(st, h >> level, w >> level)
        plan[i] = [
            st["kind"], h >> level, w >> level, src0, st["c0"], st["c0p"],
            src1, st["c1"], st["cin_p"], st["cmid_p"], st["cout"],
            st["cout_p"], st["w1t"], st["s1"], st["b1"], st["w2t"], st["s2"],
            st["b2"], out, aux, st.get("upw", 0), st.get("upb", 0),
            st.get("up_cout", 0), st.get("up_cout_p", 0),
            st.get("head_w", 0), st.get("head_b", 0), st.get("n_out", 0),
            tile.path_id, tile.th, tile.tw, tile.images, st.get("up_kp", 0)]
    return plan, size


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def weights_of(model, dtype, device) -> MegaWeights:
    """The model's folded (and, on a card, packed) weights, cached on the
    model: not once per forward."""
    key = state_key(model, device) + (dtype,)
    cached = _CACHE.get(model)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            folded = fold_weights(model, dtype)
            weights = MegaWeights(folded)
            if device.type == "cuda":
                weights.blob, weights.stages = _pack(folded, device)
        cached = _CACHE[model] = (key, weights)
    return cached[1]


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("unet_mega.cu", "pk_unet_mega",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])


def mega_forward(weights: MegaWeights, x) -> torch.Tensor:
    """One launch of the kernel: x (B, h, w, Cin) bf16 on the card, weights
    packed for that card → fp32 logits (B, h, w, out)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous (B, h, w, C) bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if weights.blob is None or weights.blob.device != x.device:
        raise ValueError("weights and input lie on different devices")
    b, h, w, cin = x.shape
    if cin != weights.stages[0]["c0"]:
        raise ValueError(f"input has {cin} channels, the packed weights "
                         f"{weights.stages[0]['c0']}")
    shape = (b, h, w)
    if shape not in weights.plans:
        plan, scratch_elems = _plan(weights.stages, b, h, w)
        weights.plans[shape] = (
            (ctypes.c_longlong * plan.size)(*plan.ravel().tolist()),
            scratch_elems)
    plan_arr, scratch_elems = weights.plans[shape]
    n_out = weights.stages[-1]["n_out"]
    scratch = torch.empty(scratch_elems, dtype=torch.bfloat16, device=x.device)
    logits = torch.empty((b, h, w, n_out), dtype=torch.float32,
                         device=x.device)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_unet_mega(x.data_ptr(), weights.blob.data_ptr(),
                               scratch.data_ptr(), logits.data_ptr(),
                               ctypes.addressof(plan_arr),
                               len(weights.stages), b, stream)
    if err != 0:
        raise RuntimeError("whole-forward kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    LAUNCHES += 1
    return logits


def make_mega_apply(cfg: UNetConfig):
    """Returns ``apply(model, x, train=False) -> logits`` with the semantics
    of the model's inference forward, through the whole-forward kernel
    (the plain version for a tensor on the CPU). ``model`` is a batch-norm
    :class:`plumekit_torch.models.UNet` on ``x``'s device; x is NHWC."""
    from plumekit_torch.models.unet import DTYPES

    if cfg.norm != "batch":
        raise ValueError("megakernel forward requires the batch-norm U-Net")
    dtype = DTYPES[cfg.compute_dtype]

    @torch.no_grad()
    def apply(model, x, train: bool = False):
        if train:
            raise ValueError("megakernel forward is inference-only")
        _b, h, w, cin = x.shape
        if cin != cfg.in_channels:
            raise ValueError(
                f"input has {cin} channels but the config declares "
                f"{cfg.in_channels}; the megakernel packs weights from the "
                "config, so a mismatch cannot fall through silently")
        if not mega_eligible(cfg, h, w):
            raise ValueError(
                f"megakernel ineligible for shape {(h, w)} / config "
                "(see mega_eligible); use the plain forward")
        if x.device.type == "cpu":
            return mega_forward_ref(
                weights_of(model, dtype, x.device).folded, x)
        if dtype != torch.bfloat16:
            raise ValueError("the whole-forward kernel is bf16 only on the "
                             f"card; compute_dtype is {cfg.compute_dtype}")
        return mega_forward(weights_of(model, dtype, x.device),
                            x.to(dtype).contiguous())

    return apply
