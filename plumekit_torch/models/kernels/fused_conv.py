"""Fused 3×3 conv + folded BatchNorm + ReLU, twice: the U-Net double-conv
block (K6).

Replaces the Pallas TPU kernel ``fused_double_conv3x3_bn_relu`` of
``plumekit/models/pallas/fused_conv.py`` (:180). The CUDA kernel is
``plumekit_torch/csrc/fused_double_conv.cu``: one launch per block, the bf16
conv1 output kept in shared memory, both convs on the tensor cores
(``mma.sync`` bf16 → fp32). On an H100 it is compute bound; the source note
there gives the tiling and what the halo recompute costs.

Layouts follow the JAX package: activations NHWC, conv weights HWIO,
scales and shifts per output channel. :func:`fused_double_conv3x3_bn_relu`
runs the plain version for a tensor on the CPU and the CUDA kernel for a
tensor on the card; it never falls back from the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

_CH_MULTIPLE = 32   # the kernel's channel chunk; padded channels are zero


def fold_batchnorm(gamma, beta, mean, var, eps: float = 1e-5):
    """(scale, shift) such that ``scale * x + shift`` equals inference-mode
    BatchNorm with the given parameters and running statistics."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def conv3x3_bn_relu_ref(x, w, scale, shift):
    """SAME 3×3 conv (NHWC, HWIO) in fp32, then ``*scale + shift``, then
    ReLU, cast back to ``x.dtype`` — ``conv3x3_bn_relu_xla`` of the JAX
    package. The conv runs in fp32 on ``x``'s values, so bf16 inputs give
    the kernel's fp32-accumulated result up to summation order."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    y = y * scale.float()[:, None, None] + shift.float()[:, None, None]
    return torch.relu(y).to(x.dtype).permute(0, 2, 3, 1).contiguous()


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


def _library():
    from plumekit_torch.cuda_build import load_library

    lib = load_library("fused_double_conv.cu")
    fn = lib.pk_fused_double_conv3x3_bn_relu
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pk_error_string.argtypes = [ctypes.c_int]
        lib.pk_error_string.restype = ctypes.c_char_p
    return lib


def fused_double_conv3x3_bn_relu(x, w1, scale1, shift1, w2, scale2, shift2):
    """One U-Net double-conv block, (conv3×3 + scale/shift + ReLU) × 2.

    x: (B, H, W, Cin); w1: (3, 3, Cin, Cmid); w2: (3, 3, Cmid, Cout);
    scales and shifts: (Cmid,) and (Cout,). Returns (B, H, W, Cout) in
    ``x.dtype``. On the card ``x`` must be bf16 and contiguous; weights,
    scales and shifts are used at bf16, as the JAX forward casts them.
    """
    if x.device.type == "cpu":
        return double_conv3x3_bn_relu_ref(x, w1, scale1, shift1,
                                          w2, scale2, shift2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous (B, H, W, C) bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, h, w, cin = x.shape
    cmid, cout = w1.shape[-1], w2.shape[-1]
    if (tuple(w1.shape) != (3, 3, cin, cmid)
            or tuple(w2.shape) != (3, 3, cmid, cout)
            or scale1.shape != (cmid,) or shift1.shape != (cmid,)
            or scale2.shape != (cout,) or shift2.shape != (cout,)):
        raise ValueError("weight shapes do not chain: w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    for t in (w1, scale1, shift1, w2, scale2, shift2):
        if t.device != x.device:
            raise ValueError("weights and input lie on different devices")
    cin_p = _round_up(cin, _CH_MULTIPLE)
    cmid_p = _round_up(cmid, _CH_MULTIPLE)
    cout_p = _round_up(cout, _CH_MULTIPLE)
    args = (x,
            _pack_weight(w1, cin_p, cmid_p), _pack_vector(scale1, cmid_p),
            _pack_vector(shift1, cmid_p),
            _pack_weight(w2, cmid_p, cout_p), _pack_vector(scale2, cout_p),
            _pack_vector(shift2, cout_p))
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=x.device)
    lib = _library()
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
