"""Fused 3×3 conv + folded BatchNorm + ReLU: once (K5) and twice, the U-Net
double-conv block (K6).

Replaces the Pallas TPU kernels ``fused_conv3x3_bn_relu`` (:259) and
``fused_double_conv3x3_bn_relu`` (:180) of
``plumekit/models/pallas/fused_conv.py``. The CUDA kernels are
``plumekit_torch/csrc/fused_conv.cu`` and ``csrc/fused_double_conv.cu`` over
the device code of ``csrc/conv_tiles.cuh``: one launch per call, convs on
the tensor cores (bf16 → fp32: ``wgmma`` above 64 output or mid channels,
``mma.sync`` below), in the double conv the bf16 conv1 output kept in shared
memory. On an H100 the wide layers are compute bound; the source notes give
the design. The path, the tile and the images per block come from
:mod:`plumekit_torch.models.kernels.conv_tiles`, and so does the packing:
the raw-weight entries pack on every call, the ``*_packed`` entries take
weights packed once (the fused forward caches them per model).

Layouts follow the JAX package: activations NHWC, conv weights HWIO,
scales and shifts per output channel. Each entry runs its plain version for
a tensor on the CPU and its CUDA kernel for a tensor on the card; it never
falls back from the kernel. The TPU entry of K5 falls back to XLA unless
the channel counts are multiples of 128, a lane rule of that chip: here
every shape takes the kernel.

Both kernels are ``torch.library`` custom ops, ``plumekit::fused_conv3x3``
(K5) and ``plumekit::fused_double_conv3x3`` (K6), so that ``torch.export``
and graph tools see them: the CPU implementation is the plain version on
the folded weights, the CUDA one the kernel's launch on weights packed for
it (the op's weight arguments are the weights as its device's
implementation reads them), the fake one the output's shape from ``x`` and
the int arguments. Registration runs at import; ``nvcc`` runs at the first
launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from plumekit_torch.cuda_build import LAUNCH_LOCK
from plumekit_torch.models.kernels import conv_tiles

#: launches of the double-conv kernel (K6) since import (or since a caller
#: reset it)
LAUNCHES = 0
#: launches of the single-conv kernel (K5)
SINGLE_LAUNCHES = 0


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


def tensor_version(t) -> int:
    """How often ``t`` was written in place (0 for an inference tensor,
    which keeps no count)."""
    try:
        return t._version
    except RuntimeError:
        return 0


def state_key(model, device):
    """Changes whenever a parameter or buffer of ``model`` is replaced or
    written in place, so that weights are folded and packed once per model
    and device and again only after the model changed."""
    return (str(device),) + tuple(
        (t.data_ptr(), tensor_version(t))
        for t in model.state_dict(keep_vars=True).values())


@dataclass
class PackedConv:
    """One conv's weight, scale and shift as its kernel path reads them
    (:func:`conv_tiles.pack_conv`), on one device."""

    path: str
    cin: int
    cout: int
    tensors: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

    @property
    def padded(self) -> Tuple[int, int]:
        return conv_tiles.padded_channels(self.path, self.cin, self.cout)


@dataclass
class PackedDoubleConv:
    """A double conv packed for K6; both convs take the path of the mid
    channels."""

    first: PackedConv
    second: PackedConv


def pack_single_conv(w, scale, shift) -> PackedConv:
    """Pack one conv (HWIO weight, per-channel scale and shift) for K5."""
    cin, cout = w.shape[2:]
    if (tuple(w.shape) != (3, 3, cin, cout) or scale.shape != (cout,)
            or shift.shape != (cout,)):
        raise ValueError(f"weight {tuple(w.shape)}, scale {tuple(scale.shape)}"
                         f" and shift {tuple(shift.shape)} do not fit")
    path = conv_tiles.path_for(cout)
    return PackedConv(path, cin, cout,
                      conv_tiles.pack_conv(path, w, scale, shift))


def pack_double_conv(w1, scale1, shift1, w2, scale2, shift2
                     ) -> PackedDoubleConv:
    """Pack one double-conv block for K6. The second conv's depth is the
    first's padded width."""
    cin, cmid = w1.shape[2:]
    cout = w2.shape[-1]
    if (tuple(w1.shape) != (3, 3, cin, cmid)
            or tuple(w2.shape) != (3, 3, cmid, cout)
            or scale1.shape != (cmid,) or shift1.shape != (cmid,)
            or scale2.shape != (cout,) or shift2.shape != (cout,)):
        raise ValueError("weight shapes do not chain: w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    path = conv_tiles.path_for(cmid)
    first = PackedConv(path, cin, cmid,
                       conv_tiles.pack_conv(path, w1, scale1, shift1))
    cmid_p = first.padded[1]
    w2 = F.pad(w2, (0, 0, 0, cmid_p - cmid))
    second = PackedConv(path, cmid_p, cout,
                        conv_tiles.pack_conv(path, w2, scale2, shift2))
    return PackedDoubleConv(first, second)


def _library(source: str, entry: str, argtypes):
    from plumekit_torch.cuda_build import load_entry

    return load_entry(source, entry, argtypes)


def _check_input(x, tensors, cin: int):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous (B, H, W, C) bf16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[-1] != cin:
        raise ValueError(f"the weights do not fit an input of {x.shape[-1]} "
                         f"channels: they were packed for {cin}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError("weights and input lie on different devices")


def _check_packed(conv: PackedConv):
    """The packed weight's shape is the one its path gives ``conv``'s
    channels (an op's CUDA implementation rebuilds ``conv`` from the
    tensors and ints it was given)."""
    cin_p, cout_p = conv.padded
    w = conv.tensors[0]
    want = ((cout_p // conv_tiles.PASS_N, cin_p // conv_tiles.CHUNK_K,
             9, conv_tiles.CHUNK_K // 8, conv_tiles.PASS_N, 8)
            if conv.path == "wgmma" else (cout_p, 9, cin_p))
    if tuple(w.shape) != want or w.dtype != torch.bfloat16:
        raise ValueError(f"a weight packed as {tuple(w.shape)} {w.dtype} "
                         f"does not fit {conv.cin} -> {conv.cout} channels "
                         f"on the {conv.path} path")


def _launch_single(x, packed: PackedConv):
    """One launch of K5: every launch of it comes through here."""
    _check_input(x, packed.tensors, packed.cin)
    _check_packed(packed)
    b, h, wd, cin = x.shape
    cin_p, cout_p = packed.padded
    tile = conv_tiles.single_conv_tile(h, wd, cin, packed.cout)
    out = torch.empty((b, h, wd, packed.cout), dtype=torch.bfloat16,
                      device=x.device)
    lib = _library("fused_conv.cu", "pk_fused_conv3x3_bn_relu",
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    global SINGLE_LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_fused_conv3x3_bn_relu(
            x.data_ptr(), *[t.data_ptr() for t in packed.tensors],
            out.data_ptr(), b, h, wd, cin, cin_p, packed.cout, cout_p,
            tile.path_id, tile.th, tile.tw, tile.images, stream)
    if err != 0:
        raise RuntimeError("fused conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    with LAUNCH_LOCK:
        SINGLE_LAUNCHES += 1
    return out


def _launch_double(x, packed: PackedDoubleConv):
    """One launch of K6: every launch of it comes through here."""
    first, second = packed.first, packed.second
    _check_input(x, first.tensors + second.tensors, first.cin)
    _check_packed(first)
    _check_packed(second)
    b, h, w, cin = x.shape
    cin_p, cmid_p = first.padded
    cout_p = second.padded[1]
    tile = conv_tiles.double_conv_tile(h, w, cin, first.cout, second.cout)
    out = torch.empty((b, h, w, second.cout), dtype=torch.bfloat16,
                      device=x.device)
    lib = _library("fused_double_conv.cu", "pk_fused_double_conv3x3_bn_relu",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    global LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_fused_double_conv3x3_bn_relu(
            x.data_ptr(),
            *[t.data_ptr() for t in first.tensors + second.tensors],
            out.data_ptr(), b, h, w, cin, cin_p, cmid_p, second.cout, cout_p,
            tile.path_id, tile.th, tile.tw, tile.images, stream)
    if err != 0:
        raise RuntimeError("fused double-conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out


# ------------------------------------------------------------ custom ops

@torch.library.custom_op("plumekit::fused_conv3x3", mutates_args=(),
                         device_types="cpu")
def fused_conv3x3_op(x: Tensor, w: Tensor, scale: Tensor, shift: Tensor,
                     cout: int) -> Tensor:
    """K5 as an op. CPU: :func:`conv3x3_bn_relu_ref` on the HWIO weight;
    CUDA: the kernel on the weight, scale and shift that
    :func:`pack_single_conv` packed for ``cout`` output channels."""
    return conv3x3_bn_relu_ref(x, w, scale, shift)


@fused_conv3x3_op.register_kernel("cuda")
def _fused_conv3x3_cuda(x, w, scale, shift, cout):
    return _launch_single(x, PackedConv(conv_tiles.path_for(cout),
                                        x.shape[-1], cout, (w, scale, shift)))


@fused_conv3x3_op.register_fake
def _fused_conv3x3_fake(x, w, scale, shift, cout):
    return x.new_empty((*x.shape[:3], cout))


@torch.library.custom_op("plumekit::fused_double_conv3x3", mutates_args=(),
                         device_types="cpu")
def fused_double_conv3x3_op(x: Tensor, w1: Tensor, scale1: Tensor,
                            shift1: Tensor, w2: Tensor, scale2: Tensor,
                            shift2: Tensor, cmid: int, cout: int) -> Tensor:
    """K6 as an op. CPU: :func:`double_conv3x3_bn_relu_ref` on the folded
    HWIO weights; CUDA: the kernel on the block that
    :func:`pack_double_conv` packed for ``cmid`` and ``cout`` channels."""
    return double_conv3x3_bn_relu_ref(x, w1, scale1, shift1, w2, scale2,
                                      shift2)


@fused_double_conv3x3_op.register_kernel("cuda")
def _fused_double_conv3x3_cuda(x, w1, scale1, shift1, w2, scale2, shift2,
                               cmid, cout):
    path = conv_tiles.path_for(cmid)
    first = PackedConv(path, x.shape[-1], cmid, (w1, scale1, shift1))
    second = PackedConv(path, first.padded[1], cout, (w2, scale2, shift2))
    return _launch_double(x, PackedDoubleConv(first, second))


@fused_double_conv3x3_op.register_fake
def _fused_double_conv3x3_fake(x, w1, scale1, shift1, w2, scale2, shift2,
                               cmid, cout):
    return x.new_empty((*x.shape[:3], cout))


# ------------------------------------------------------------- entries

def fused_conv3x3_bn_relu_packed(x, packed: PackedConv):
    """K5 on weights packed by :func:`pack_single_conv`: one launch."""
    _check_input(x, packed.tensors, packed.cin)
    return fused_conv3x3_op(x, *packed.tensors, packed.cout)


def fused_conv3x3_bn_relu(x, w, scale, shift):
    """One SAME 3×3 conv + scale/shift + ReLU (K5).

    x: (B, H, W, Cin); w: (3, 3, Cin, Cout); scale, shift: (Cout,). Returns
    (B, H, W, Cout) in ``x.dtype``. On the card ``x`` must be bf16 and
    contiguous; the weight, scale and shift are used at bf16 and packed on
    every call (:func:`fused_conv3x3_bn_relu_packed` takes them packed).
    """
    if x.device.type == "cpu":
        return fused_conv3x3_op(x, w, scale, shift, w.shape[-1])
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w.dim() != 4 or w.shape[2] != x.shape[-1]:
        raise ValueError(f"weight {tuple(w.shape)}, scale {tuple(scale.shape)}"
                         f" and shift {tuple(shift.shape)} do not fit an "
                         f"input of {x.shape[-1]} channels")
    return fused_conv3x3_bn_relu_packed(x, pack_single_conv(w, scale, shift))


def fused_double_conv3x3_bn_relu_packed(x, packed: PackedDoubleConv):
    """K6 on weights packed by :func:`pack_double_conv`: one launch."""
    first, second = packed.first, packed.second
    _check_input(x, first.tensors + second.tensors, first.cin)
    return fused_double_conv3x3_op(x, *first.tensors, *second.tensors,
                                   first.cout, second.cout)


def fused_double_conv3x3_bn_relu(x, w1, scale1, shift1, w2, scale2, shift2):
    """One U-Net double-conv block, (conv3×3 + scale/shift + ReLU) × 2 (K6).

    x: (B, H, W, Cin); w1: (3, 3, Cin, Cmid); w2: (3, 3, Cmid, Cout);
    scales and shifts: (Cmid,) and (Cout,). Returns (B, H, W, Cout) in
    ``x.dtype``. On the card ``x`` must be bf16 and contiguous; weights,
    scales and shifts are used at bf16, as the JAX forward casts them, and
    packed on every call (:func:`fused_double_conv3x3_bn_relu_packed` takes
    them packed, as the fused forward does).
    """
    if x.device.type == "cpu":
        return fused_double_conv3x3_op(x, w1, scale1, shift1, w2, scale2,
                                       shift2, w1.shape[-1], w2.shape[-1])
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w1.dim() != 4 or w1.shape[2] != x.shape[-1]:
        raise ValueError("weight shapes do not chain: w1 "
                         f"{tuple(w1.shape)} on {x.shape[-1]} channels")
    return fused_double_conv3x3_bn_relu_packed(
        x, pack_double_conv(w1, scale1, shift1, w2, scale2, shift2))
