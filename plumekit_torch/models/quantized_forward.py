"""Int8 post-training-quantized U-Net and UNet++ forwards, weights and
activations (``plumekit/models/quantized_forward.py``).

The scale algebra is the JAX package's, so every tensor is rounded once:

* activations: per-tensor symmetric scales ``amax/127``, calibrated by an
  fp32 replay of the BatchNorm-folded forward (:func:`calibrate_unet`);
* weights: per-output-channel symmetric int8, each input channel's
  activation scale folded into its weight column first
  (:func:`_quant_weight`), so the decoder's ``concat([skip, up])`` halves
  keep their own scales;
* BatchNorm folds into the dequant multiplier: each conv ends in
  ``relu(acc·a + b)``, and the block's output is requantized in the same
  epilogue (Q1, :mod:`plumekit_torch.models.kernels.int8_conv`: one launch
  per conv on the card, its plain version elsewhere);
* max-pool runs on raw int8; the 2×2 stride-2 transposed conv is one s8
  product with its dequant, pixel shuffle and requant (Q2,
  :mod:`plumekit_torch.models.kernels.int8_upsample`: one launch per
  upsample on the card, its plain version, ``torch._int_mm`` and eager
  glue, elsewhere); the 1×1 head is fp32.

Layouts are the JAX package's (NHWC activations, HWIO weights; the
transposed conv's kernel ``(2, 2, Cin, Cout)`` pre-flipped, which is torch's
``ConvTranspose2d`` weight with its axes moved), so
:func:`plumekit_torch.convert.qvars_from_flax` carries the JAX quantized
state over value for value. Scales are 0-d float32 tensors on the model's
device. The JAX package's ``custom_vmap`` batch fold, which works around
JAX's batching of int8 ops, has nothing to do here.

The UNet++ (``arch="unetpp"``, at ``effective_level``) keeps the same
algebra over its nested grid: node ``X[i][j]``'s first conv reads
``concat(X[i][0..j-1], up)``, every participant at its own scale. Q1 takes
the concat as two sources, the ``j`` same-scale planes (one ``torch.cat``
along channels, none for ``j = 1``) and the upsample. Its heads read fp32
nodes: ``X[0][L]`` is head-only (``s_out`` None), and under deep
supervision each ``X[0][j]``, ``j < L``, is written fp32 by its second Q1
and requantized for the later concats by ``quant_act``, the JAX graph's
order.

Usage::

    qvars = quantize_unet(model, cfg, calib)        # model: the port's UNet
    apply = make_quantized_apply(cfg)               # (qvars, tiles) -> logits
    infer = make_multi_granule_infer(apply, icfg)   # drop-in apply_fn

The forward reads one tree of tensors, :func:`int8_tree` of the quantized
variables: on the CPU the variables themselves, on the card each conv's and
upsample's weights packed for Q1 and Q2 (``plumekit::int8_conv3x3`` and
``plumekit::int8_upsample2x2``, one op each). The live forward builds the
tree on every call from the kernel modules' packing caches; an exported
program (:mod:`plumekit_torch.infer.export`) takes it as an input, packed
once when the artifact is loaded.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from plumekit_torch.config.train import UNetConfig
from plumekit_torch.models.kernels import int8_conv, int8_upsample
from plumekit_torch.models.kernels.fused_conv import fold_batchnorm
from plumekit_torch.models.unetpp import (decoder_nodes, effective_level,
                                          head_names)

_quant_act = int8_conv.quant_act
_upsample_q = int8_upsample.upsample_dequant_ref


def _check_cfg(cfg: UNetConfig) -> None:
    if cfg.arch not in ("unet", "unetpp"):
        raise ValueError(f"int8 quantized forward supports arch 'unet' or "
                         f"'unetpp', got {cfg.arch!r}")
    if cfg.norm != "batch":
        raise ValueError("int8 quantized forward requires norm='batch' "
                         "(BN folds into the dequant multiplier)")
    effective_level(cfg)  # validate prune_level against arch/ds/depth


def _amax(x):
    return torch.clamp(x.abs().max(), min=1e-8).float()


def _quant_weight(w, in_scales):
    """Per-output-channel int8 with input activation scales folded in.

    ``w`` (kh, kw, cin, cout) fp32; ``in_scales`` (cin,). Returns ``(wq
    int8, sw (cout,) fp32)`` with ``conv_fp(x, w) ≈ conv_s8(xq, wq) · sw``
    for ``x ≈ xq·s_x``."""
    wp = w.float() * in_scales[None, None, :, None]
    sw = torch.clamp(wp.abs().amax(dim=(0, 1, 2)), min=1e-12) \
        / int8_conv.scale_tensor(127.0, wp)
    wq = torch.clamp(torch.round(wp / sw), -127, 127).to(torch.int8)
    return wq, sw


def _max_pool2_q(xq):
    b, h, w, c = xq.shape
    return xq.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _qblock(xq, blk, skip=None, planes=None, cout=None):
    """Int8 DoubleConv, two Q1 ops: conv → dequant+BN+ReLU → requant at
    ``s_mid`` → conv → dequant+BN+ReLU → requant at ``s_out``, or fp32 where
    ``s_out`` is None (the last decoder block, which feeds the head). With
    ``skip`` the first conv reads ``concat([skip, xq])``; a list ``planes``
    gets the int8 planes made. ``blk`` is one block of :func:`int8_tree`,
    ``cout`` its output channels (read off the raw weight by default)."""
    cout = blk["wq2"].shape[-1] if cout is None else cout
    mq = int8_conv.conv_op(xq, blk["wq1"], blk["a1"], blk["b1"],
                           blk["s_mid"], skip, cout)
    y = int8_conv.conv_op(mq, blk["wq2"], blk["a2"], blk["b2"],
                          blk["s_out"], None, cout)
    if planes is not None:
        planes += [mq] if blk["s_out"] is None else [mq, y]
    return y


def _upsample(xq, up, cout):
    return int8_upsample.upsample_op(xq, up["kq"], up["sw"], up["bias"],
                                     up["s_up"], cout)


def _pack_block(blk, with_skip: bool):
    cin, cout = blk["wq1"].shape[2:]
    first = int8_conv.pack_conv(blk["wq1"], blk["a1"], blk["b1"],
                                cin - cout if with_skip else None)
    second = int8_conv.pack_conv(blk["wq2"], blk["a2"], blk["b2"])
    return {**blk, "wq1": first.wt, "a1": first.a, "b1": first.b,
            "wq2": second.wt, "a2": second.a, "b2": second.b}


def _pack_up(up):
    packed = int8_upsample.pack_upsample(up["kq"], up["sw"], up["bias"])
    return {**up, "kq": packed.wt, "sw": packed.a, "bias": packed.b}


def int8_tree(qvars, cfg: UNetConfig, device=None) -> Dict[str, Any]:
    """The tensors the int8 forward reads on ``device`` (the variables'
    by default): on the CPU ``qvars`` as they are; on a card a copy whose
    every 3×3 conv (``wq``, ``a``, ``b``) is packed for Q1 and every
    transposed conv (``kq``, ``sw``, ``bias``) for Q2, under the same
    keys. A decoder block's first conv reads ``[skip, up]``: its skip
    channels are its input channels less its output channels."""
    device = torch.device(qvars["s_in"].device if device is None
                          else device)
    if device.type != "cuda":
        return qvars
    blocks = qvars["blocks"]
    if cfg.arch == "unetpp":
        packed = {name: _pack_block(blk, not name.endswith("_0"))
                  for name, blk in blocks.items()}
        ups = {name: _pack_up(up) for name, up in qvars["ups"].items()}
    else:
        packed = [_pack_block(blk, idx > cfg.depth)
                  for idx, blk in enumerate(blocks)]
        ups = [_pack_up(up) for up in qvars["ups"]]
    return {**qvars, "blocks": packed, "ups": ups}


def _folded_block(block):
    """[(w1, a_bn1, b1), (w2, a_bn2, b2)] of one port ``DoubleConv``:
    HWIO fp32 weights and the folded BatchNorm."""
    out = []
    for conv, bn in zip(block.conv, block.norm):
        scale, shift = fold_batchnorm(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
        out.append((conv.weight.detach().permute(2, 3, 1, 0).float(),
                    scale.detach().float(), shift.detach().float()))
    return out


def _conv_bn_relu(x, w, a, b):
    """fp32 oracle tap of the calibration replay: NHWC ``x``, HWIO ``w``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) * a + b)


def _conv_transpose_fp32(x, up):
    """fp32 2×2 stride-2 transposed conv of NHWC ``x`` by the port's
    ``ConvTranspose2d`` ``up``, as the calibration replay computes it: one
    product and the pixel shuffle."""
    k = up.weight.detach().float()                      # (cin, cout, 2, 2)
    b_, h, w_, cin = x.shape
    cout = k.shape[1]
    y = (x.reshape(-1, cin) @ k.permute(0, 2, 3, 1).reshape(
        cin, 4 * cout)).reshape(b_, h, w_, 2, 2, cout)
    return (y.permute(0, 1, 3, 2, 4, 5).reshape(b_, 2 * h, 2 * w_, cout)
            + up.bias.detach().float())


def _per_channel(scale, n):
    return scale * torch.ones((n,), dtype=torch.float32, device=scale.device)


def _head_vars(head):
    """The fp32 1×1 head of a port ``Conv2d``: HWIO kernel and bias."""
    return {"kernel": head.weight.detach().float().permute(2, 3, 1, 0),
            "bias": head.bias.detach().float()}


@contextmanager
def full_fp32():
    """fp32 convolutions and products in full fp32, not TF32 (cuDNN's
    default for convolutions), restored after: the JAX reference replays in
    exact fp32, and a TF32 ``amax`` moves many weights to another int8."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@torch.no_grad()
def calibrate_unet(model, cfg: UNetConfig, calib) -> Dict[str, Any]:
    """Record per-tensor |max| at every quantization point by replaying the
    BN-folded fp32 forward of the port's ``UNet`` ``model`` on ``calib``
    (B, H, W, C), H and W divisible by ``2**cfg.depth``, on the model's
    device. Returns ``{name: amax}`` (0-d float32 tensors) under the JAX
    package's names: ``in``; ``b{i}_mid``; ``b{i}_out`` for every block but
    the last decoder block; ``up{u}``. Calibrate on a batch of tiles, not a
    whole granule: the replay keeps full-resolution fp32 planes of every
    level. A UNet++ takes :func:`_calibrate_unetpp`."""
    _check_cfg(cfg)
    if cfg.arch == "unetpp":
        return _calibrate_unetpp(model, cfg, calib)
    depth = cfg.depth
    amax: Dict[str, Any] = {}
    with full_fp32():
        x = torch.as_tensor(calib, dtype=torch.float32,
                            device=model.head.weight.device)
        amax["in"] = _amax(x)
        skips: List[Any] = []
        idx = 0
        for _ in range(depth):
            (w1, a1, b1), (w2, a2, b2) = _folded_block(model.blocks[idx])
            x = _conv_bn_relu(x, w1, a1, b1)
            amax[f"b{idx}_mid"] = _amax(x)
            x = _conv_bn_relu(x, w2, a2, b2)
            amax[f"b{idx}_out"] = _amax(x)
            skips.append(x)
            x = _max_pool2_q(x)
            idx += 1
        (w1, a1, b1), (w2, a2, b2) = _folded_block(model.blocks[idx])
        x = _conv_bn_relu(x, w1, a1, b1)
        amax[f"b{idx}_mid"] = _amax(x)
        x = _conv_bn_relu(x, w2, a2, b2)
        amax[f"b{idx}_out"] = _amax(x)
        idx += 1

        for u, skip in enumerate(reversed(skips)):
            x = _conv_transpose_fp32(x, model.ups[u])
            amax[f"up{u}"] = _amax(x)
            x = torch.cat([skip, x], dim=-1)
            (w1, a1, b1), (w2, a2, b2) = _folded_block(model.blocks[idx])
            x = _conv_bn_relu(x, w1, a1, b1)
            amax[f"b{idx}_mid"] = _amax(x)
            x = _conv_bn_relu(x, w2, a2, b2)
            if idx != 2 * depth:  # last decoder output stays fp32 for the head
                amax[f"b{idx}_out"] = _amax(x)
            idx += 1
    return amax


@torch.no_grad()
def quantize_unet(model, cfg: UNetConfig, calib) -> Dict[str, Any]:
    """The int8 serving variables of the port's trained ``UNet`` ``model``
    (conv weights, BatchNorm parameters and running statistics) and a
    calibration batch, on the model's device, in the JAX package's
    structure: ``{"s_in", "blocks": [...], "ups": [...], "head"}``; of a
    ``UNetPP`` :func:`_quantize_unetpp`'s. Runs once, off the serving hot
    path."""
    _check_cfg(cfg)
    if cfg.arch == "unetpp":
        return _quantize_unetpp(model, cfg, calib)
    amax = calibrate_unet(model, cfg, calib)
    s = {k: v / int8_conv.scale_tensor(127.0, v) for k, v in amax.items()}
    depth = cfg.depth

    def block_vars(idx, s_in, s_out):
        (w1, a1, b1), (w2, a2, b2) = _folded_block(model.blocks[idx])
        wq1, sw1 = _quant_weight(w1, s_in)
        wq2, sw2 = _quant_weight(w2, _per_channel(s[f"b{idx}_mid"],
                                                  w2.shape[2]))
        return {"wq1": wq1, "a1": sw1 * a1, "b1": b1,
                "s_mid": s[f"b{idx}_mid"],
                "wq2": wq2, "a2": sw2 * a2, "b2": b2, "s_out": s_out}

    blocks = []
    in_name = "in"
    for idx in range(depth + 1):  # encoder levels + bottleneck
        cin = model.blocks[idx].conv[0].weight.shape[1]
        blocks.append(block_vars(idx, _per_channel(s[in_name], cin),
                                 s[f"b{idx}_out"]))
        in_name = f"b{idx}_out"

    ups = []
    for u in range(depth):
        up = model.ups[u]
        # torch's ConvTranspose2d weight (cin, cout, 2, 2) is the flax
        # kernel flipped in both spatial axes: moved to (2, 2, cin, cout) it
        # is the JAX package's pre-flipped kernel
        k = up.weight.detach().float().permute(2, 3, 0, 1)
        src = f"b{depth + u}_out"  # u=0 reads the bottleneck output
        kq, sw = _quant_weight(k, _per_channel(s[src], k.shape[2]))
        ups.append({"kq": kq, "sw": sw, "bias": up.bias.detach().float(),
                    "s_up": s[f"up{u}"]})

        # decoder block DoubleConv_{depth+1+u}: conv1 reads concat([skip
        # (encoder level depth-1-u), up u]); each half keeps its own scale
        idx = depth + 1 + u
        c_skip = model.blocks[depth - 1 - u].conv[1].weight.shape[0]
        s_cat = torch.cat([
            _per_channel(s[f"b{depth - 1 - u}_out"], c_skip),
            _per_channel(s[f"up{u}"], k.shape[-1])])
        last = idx == 2 * depth
        # the last decoder output feeds the fp32 head un-quantized
        blocks.append(block_vars(idx, s_cat,
                                 None if last else s[f"b{idx}_out"]))

    return {"s_in": s["in"], "blocks": blocks, "ups": ups,
            "head": _head_vars(model.head)}


def make_quantized_tree_apply(cfg: UNetConfig):
    """Returns ``apply(tree, x, planes=None) -> logits (B, H, W, out)``,
    the int8 twin of the U-Net's forward on an :func:`int8_tree`. Every
    3×3 conv is Q1, every transposed conv with its requant Q2; the only
    fp32 work is in their epilogues and the 1×1 head. With a list
    ``planes``, every int8 plane of the forward is appended to it in order
    (a debug form for comparing two devices). A UNet++ config takes
    :func:`_make_unetpp_apply`."""
    _check_cfg(cfg)
    if cfg.arch == "unetpp":
        return _make_unetpp_apply(cfg)
    depth = cfg.depth
    feats = [cfg.base_features * 2**i for i in range(depth + 1)]

    def apply(tree, x, planes: Optional[list] = None):
        def keep(t):
            if planes is not None:
                planes.append(t)
            return t

        xq = keep(_quant_act(x.float(), tree["s_in"]))
        skips = []
        for i in range(depth):
            skips.append(_qblock(xq, tree["blocks"][i], planes=planes,
                                 cout=feats[i]))
            xq = keep(_max_pool2_q(skips[-1]))
        xq = _qblock(xq, tree["blocks"][depth], planes=planes,
                     cout=feats[depth])
        for u, skip in enumerate(reversed(skips)):
            level = depth - 1 - u
            uq = keep(_upsample(xq, tree["ups"][u], feats[level]))
            xq = _qblock(uq, tree["blocks"][depth + 1 + u], skip, planes,
                         feats[level])
        head = tree["head"]           # xq: the last block's fp32 output
        return xq @ head["kernel"][0, 0] + head["bias"]

    return apply


def make_quantized_apply(cfg: UNetConfig):
    """Returns ``apply(qvars, x, train=False, planes=None) -> logits``,
    drop-in as ``make_multi_granule_infer``'s ``apply_fn``: the forward of
    :func:`make_quantized_tree_apply` on :func:`int8_tree` of ``qvars`` on
    ``x``'s device."""
    tree_apply = make_quantized_tree_apply(cfg)

    @torch.no_grad()
    def apply(qvars, x, train: bool = False,
              planes: Optional[list] = None):
        if train:
            raise ValueError("int8 quantized forward is inference-only")
        return tree_apply(int8_tree(qvars, cfg, x.device), x, planes)

    return apply


def qvars_to(qvars, device) -> Dict[str, Any]:
    """A copy of the int8 serving variables on ``device``."""
    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v) for v in t]
        return None if t is None else t.to(device, copy=True)

    return move(qvars)


# ---------------------------------------------------------------------------
# UNet++ (plumekit/models/quantized_forward.py:391-557). Tensor names: "in",
# "x{i}_{j}_mid", "x{i}_{j}_out", "up{i}_{j}"; X[0][L] is head-only, so it
# has no "_out".
# ---------------------------------------------------------------------------


@torch.no_grad()
def _calibrate_unetpp(model, cfg: UNetConfig, calib) -> Dict[str, Any]:
    """:func:`calibrate_unet` of the port's ``UNetPP`` ``model``: the fp32
    replay of its BN-folded grid up to ``effective_level(cfg)``."""
    level = effective_level(cfg)
    amax: Dict[str, Any] = {}
    with full_fp32():
        x = torch.as_tensor(calib, dtype=torch.float32,
                            device=next(model.parameters()).device)
        amax["in"] = _amax(x)

        def node(i, j, h):
            (w1, a1, b1), (w2, a2, b2) = _folded_block(
                model.nodes[f"x_{i}_{j}"])
            h = _conv_bn_relu(h, w1, a1, b1)
            amax[f"x{i}_{j}_mid"] = _amax(h)
            h = _conv_bn_relu(h, w2, a2, b2)
            if (i, j) != (0, level):
                amax[f"x{i}_{j}_out"] = _amax(h)
            return h

        grid = {}
        h = x
        for i in range(level + 1):
            if i:
                h = _max_pool2_q(h)
            h = grid[(i, 0)] = node(i, 0, h)
        for i, j in decoder_nodes(level):
            up = _conv_transpose_fp32(grid[(i + 1, j - 1)],
                                      model.ups[f"up_{i}_{j}"])
            amax[f"up{i}_{j}"] = _amax(up)
            grid[(i, j)] = node(i, j, torch.cat(
                [grid[(i, k)] for k in range(j)] + [up], dim=-1))
    return amax


@torch.no_grad()
def _quantize_unetpp(model, cfg: UNetConfig, calib) -> Dict[str, Any]:
    """The int8 serving variables of the port's ``UNetPP`` ``model`` at
    ``effective_level(cfg)``, in the JAX package's structure: ``{"s_in",
    "blocks": {"x{i}_{j}": ...}, "ups": {"up{i}_{j}": ...}, "heads":
    {"head" or "head_{j}": ...}}``."""
    amax = _calibrate_unetpp(model, cfg, calib)
    s = {k: v / int8_conv.scale_tensor(127.0, v) for k, v in amax.items()}
    level = effective_level(cfg)
    feats = [cfg.base_features * 2**i for i in range(level + 1)]

    def quant_block(i, j, in_scales):
        (w1, a1, b1), (w2, a2, b2) = _folded_block(model.nodes[f"x_{i}_{j}"])
        wq1, sw1 = _quant_weight(w1, in_scales)
        wq2, sw2 = _quant_weight(w2, _per_channel(s[f"x{i}_{j}_mid"],
                                                  w2.shape[2]))
        return {"wq1": wq1, "a1": sw1 * a1, "b1": b1,
                "s_mid": s[f"x{i}_{j}_mid"],
                "wq2": wq2, "a2": sw2 * a2, "b2": b2,
                "s_out": None if (i, j) == (0, level) else s[f"x{i}_{j}_out"]}

    blocks: Dict[str, Any] = {}
    ups: Dict[str, Any] = {}
    for i in range(level + 1):
        s_in = s["in"] if i == 0 else s[f"x{i - 1}_0_out"]
        cin = cfg.in_channels if i == 0 else feats[i - 1]
        blocks[f"x{i}_0"] = quant_block(i, 0, _per_channel(s_in, cin))
    for i, j in decoder_nodes(level):
        up = model.ups[f"up_{i}_{j}"]
        # torch's (cin, cout, 2, 2) weight moved to (2, 2, cin, cout) is the
        # JAX package's pre-flipped kernel
        k = up.weight.detach().float().permute(2, 3, 0, 1)
        s_src = s[f"x{i + 1}_{j - 1}_out"]
        kq, sw = _quant_weight(k, _per_channel(s_src, k.shape[2]))
        ups[f"up{i}_{j}"] = {"kq": kq, "sw": sw,
                             "bias": up.bias.detach().float(),
                             "s_up": s[f"up{i}_{j}"]}
        s_cat = torch.cat(
            [_per_channel(s[f"x{i}_{k_}_out"], feats[i]) for k_ in range(j)]
            + [_per_channel(s[f"up{i}_{j}"], feats[i])])
        blocks[f"x{i}_{j}"] = quant_block(i, j, s_cat)
    heads = {name: _head_vars(model.heads[name])
             for name in head_names(cfg, level).values()}
    return {"s_in": s["in"], "blocks": blocks, "ups": ups, "heads": heads}


def _make_unetpp_apply(cfg: UNetConfig):
    """:func:`make_quantized_tree_apply` of a UNet++ config: 2 Q1 ops per
    node and one Q2 per upsample, ``(L + 1)(L + 2)`` and ``L(L + 1)/2`` at
    level L."""
    level = effective_level(cfg)
    feats = [cfg.base_features * 2**i for i in range(level + 1)]

    def apply(tree, x, planes: Optional[list] = None):
        def keep(t):
            if planes is not None:
                planes.append(t)
            return t

        gridq = {}
        top_fp = {}            # the fp32 top-row nodes the heads read
        h = keep(_quant_act(x.float(), tree["s_in"]))
        for i in range(level + 1):
            if i:
                h = keep(_max_pool2_q(gridq[(i - 1, 0)]))
            gridq[(i, 0)] = _qblock(h, tree["blocks"][f"x{i}_0"],
                                    planes=planes, cout=feats[i])
        for i, j in decoder_nodes(level):
            uq = keep(_upsample(gridq[(i + 1, j - 1)],
                                tree["ups"][f"up{i}_{j}"], feats[i]))
            blk = tree["blocks"][f"x{i}_{j}"]
            # the concat [X[i][0..j-1], up] as Q1's two sources
            skip = (gridq[(i, 0)] if j == 1 else torch.cat(
                [gridq[(i, k)] for k in range(j)], dim=-1))
            if blk["s_out"] is None:                    # X[0][L]
                top_fp[j] = _qblock(uq, blk, skip, planes, feats[i])
            elif i == 0 and cfg.deep_supervision:
                # a side head reads the fp32 node, later concats its requant
                top_fp[j] = _qblock(uq, {**blk, "s_out": None}, skip,
                                    planes, feats[i])
                gridq[(i, j)] = keep(_quant_act(top_fp[j], blk["s_out"]))
            else:
                gridq[(i, j)] = _qblock(uq, blk, skip, planes, feats[i])
        outs = [top_fp[j] @ tree["heads"][name]["kernel"][0, 0]
                + tree["heads"][name]["bias"]
                for j, name in head_names(cfg, level).items()]
        return sum(outs) / len(outs) if cfg.deep_supervision else outs[0]

    return apply
