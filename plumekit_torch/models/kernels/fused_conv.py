"""Fused 3×3 conv + folded BatchNorm + ReLU: once (K5) and twice, the U-Net
double-conv block (K6).

Replaces the Pallas TPU kernels ``fused_conv3x3_bn_relu`` (:259) and
``fused_double_conv3x3_bn_relu`` (:180) of
``plumekit/models/pallas/fused_conv.py``. The CUDA kernels are
``plumekit_torch/csrc/fused_conv.cu`` and ``csrc/fused_double_conv.cu`` over
the device code of ``csrc/conv_tiles.cuh``: one launch per call, convs on
the tensor cores (``mma.sync`` bf16 → fp32), in the double conv the bf16
conv1 output kept in shared memory. On an H100 the wide layers are compute
bound; the source notes give the tiling and what the halo recompute costs.

Layouts follow the JAX package: activations NHWC, conv weights HWIO,
scales and shifts per output channel. Each entry runs its plain version for
a tensor on the CPU and its CUDA kernel for a tensor on the card; it never
falls back from the kernel. The TPU entry of K5 falls back to XLA unless
the channel counts are multiples of 128, a lane rule of that chip: here
every shape takes the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: launches of the double-conv kernel (K6) since import (or since a caller
#: reset it)
LAUNCHES = 0
#: launches of the single-conv kernel (K5)
SINGLE_LAUNCHES = 0

_CH_MULTIPLE = 32   # the kernel's channel chunk; padded channels are zero


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """(scale, shift) such that ``scale * x + shift`` equals inference-mode
    BatchNorm with the given parameters and running statistics."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def conv3x3_bn_relu_ref(x, w, scale, shift, out_dtype=None):
    """SAME 3×3 conv (NHWC, HWIO) in fp32, then ``*scale + shift``, then
    ReLU, cast to ``out_dtype`` (``x.dtype`` if not given) —
    ``conv3x3_bn_relu_xla`` of the JAX package. The conv runs in fp32 on
    ``x``'s values, so bf16 inputs give the kernel's fp32-accumulated result
    up to summation order."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    y = y * scale.float()[:, None, None] + shift.float()[:, None, None]
    return torch.relu(y).to(out_dtype or x.dtype).permute(0, 2, 3, 1) \
        .contiguous()


def double_conv3x3_bn_relu_ref(x, w1, scale1, shift1, w2, scale2, shift2):
    """Plain version of the kernel: two chained :func:`conv3x3_bn_relu_ref`.
    The second conv's zero padding is the kernel's zeroed ring."""
    y = conv3x3_bn_relu_ref(x, w1, scale1, shift1)
    return conv3x3_bn_relu_ref(y, w2, scale2, shift2)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pack_weight(w, cin_p: int, cout_p: int):
    """HWIO (3, 3, Cin, Cout) → (Cout_p, 9, Cin_p) bf16, zero padded."""
    kh, kw, cin, cout = w.shape
    packed = w.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin)
    return F.pad(packed.to(torch.bfloat16),
                 (0, cin_p - cin, 0, 0, 0, cout_p - cout)).contiguous()


def _pack_vector(v, n_p: int):
    return F.pad(v.to(torch.bfloat16), (0, n_p - v.shape[0])).contiguous()


def _library(source: str, entry: str, argtypes):
    from plumekit_torch.cuda_build import load_entry

    return load_entry(source, entry, argtypes)


def _check_input(x, tensors):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous (B, H, W, C) bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError("weights and input lie on different devices")


def fused_conv3x3_bn_relu(x, w, scale, shift):
    """One SAME 3×3 conv + scale/shift + ReLU (K5).

    x: (B, H, W, Cin); w: (3, 3, Cin, Cout); scale, shift: (Cout,). Returns
    (B, H, W, Cout) in ``x.dtype``. On the card ``x`` must be bf16 and
    contiguous; the weight, scale and shift are used at bf16.
    """
    if x.device.type == "cpu":
        return conv3x3_bn_relu_ref(x, w, scale, shift)
    _check_input(x, (w, scale, shift))
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if (tuple(w.shape) != (3, 3, cin, cout) or scale.shape != (cout,)
            or shift.shape != (cout,)):
        raise ValueError(f"weight {tuple(w.shape)}, scale {tuple(scale.shape)}"
                         f" and shift {tuple(shift.shape)} do not fit an "
                         f"input of {cin} channels")
    cin_p = _round_up(cin, _CH_MULTIPLE)
    cout_p = _round_up(cout, _CH_MULTIPLE)
    args = (x, _pack_weight(w, cin_p, cout_p), _pack_vector(scale, cout_p),
            _pack_vector(shift, cout_p))
    out = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    lib = _library("fused_conv.cu", "pk_fused_conv3x3_bn_relu",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    global SINGLE_LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_fused_conv3x3_bn_relu(
            *[t.data_ptr() for t in args], out.data_ptr(),
            b, h, wd, cin, cin_p, cout, cout_p, stream)
    if err != 0:
        raise RuntimeError("fused conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    SINGLE_LAUNCHES += 1
    return out


def fused_double_conv3x3_bn_relu(x, w1, scale1, shift1, w2, scale2, shift2):
    """One U-Net double-conv block, (conv3×3 + scale/shift + ReLU) × 2 (K6).

    x: (B, H, W, Cin); w1: (3, 3, Cin, Cmid); w2: (3, 3, Cmid, Cout);
    scales and shifts: (Cmid,) and (Cout,). Returns (B, H, W, Cout) in
    ``x.dtype``. On the card ``x`` must be bf16 and contiguous; weights,
    scales and shifts are used at bf16, as the JAX forward casts them.
    """
    if x.device.type == "cpu":
        return double_conv3x3_bn_relu_ref(x, w1, scale1, shift1,
                                          w2, scale2, shift2)
    _check_input(x, (w1, scale1, shift1, w2, scale2, shift2))
    b, h, w, cin = x.shape
    cmid, cout = w1.shape[-1], w2.shape[-1]
    if (tuple(w1.shape) != (3, 3, cin, cmid)
            or tuple(w2.shape) != (3, 3, cmid, cout)
            or scale1.shape != (cmid,) or shift1.shape != (cmid,)
            or scale2.shape != (cout,) or shift2.shape != (cout,)):
        raise ValueError("weight shapes do not chain: w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    cin_p = _round_up(cin, _CH_MULTIPLE)
    cmid_p = _round_up(cmid, _CH_MULTIPLE)
    cout_p = _round_up(cout, _CH_MULTIPLE)
    args = (x,
            _pack_weight(w1, cin_p, cmid_p), _pack_vector(scale1, cmid_p),
            _pack_vector(shift1, cmid_p),
            _pack_weight(w2, cmid_p, cout_p), _pack_vector(scale2, cout_p),
            _pack_vector(shift2, cout_p))
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=x.device)
    lib = _library("fused_double_conv.cu", "pk_fused_double_conv3x3_bn_relu",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    global LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_fused_double_conv3x3_bn_relu(
            *[t.data_ptr() for t in args], out.data_ptr(),
            b, h, w, cin, cin_p, cmid_p, cout, cout_p, stream)
    if err != 0:
        raise RuntimeError("fused double-conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    LAUNCHES += 1
    return out
