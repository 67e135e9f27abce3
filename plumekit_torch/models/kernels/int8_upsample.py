"""Q2: the int8 forward's 2×2 stride-2 transposed conv with its requant,
one kernel.

Replaces no Pallas kernel: the JAX package computes it as one s8 einsum
with its dequant, pixel shuffle and requant (``_upsample_q`` and
``_quant_act``, ``plumekit/models/quantized_forward.py:145-154`` and
``:116-118``, applied at ``:370-372``), which XLA fuses. The plain version
here is the port's eager path: ``torch._int_mm`` writes the int32 product
and eight more passes cast, scale, shift, shuffle, divide, round, clamp and
narrow it. The card runs the hand-written kernel
``plumekit_torch/csrc/int8_conv.cu`` (``pk_int8_upsample2x2``, the point
mode of Q1's ``wgmma`` kernel: a GEMM of M = B·h·w pixels, K = Cin and N =
4·Cout columns ``(2·di + dj)·Cout + o``, the requant and the shuffle in its
epilogue, so the int32 product never reaches device memory), one launch per
upsample.

``kq`` is (2, 2, Cin, Cout) int8, pre-flipped as the JAX package keeps it;
``sw`` and ``bias`` (Cout,) fp32; the output scale a 0-d fp32 tensor on the
input's device. The entry runs the plain version for a tensor on the CPU and
the kernel for a tensor on the card; it never falls back from the kernel.
Weights are packed once per weight tensor and device and again only after
the tensor changed in place.

Q2 is the ``torch.library`` custom op ``plumekit::int8_upsample2x2``: its
CPU implementation is the plain version on ``kq``, ``sw`` and ``bias``, its
CUDA one the kernel's launch on them as :func:`pack_upsample` packs them,
its fake one the output's shape.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils.weak import WeakIdKeyDictionary

from plumekit_torch.cuda_build import LAUNCH_LOCK
from plumekit_torch.models.kernels import int8_conv
from plumekit_torch.models.kernels.fused_conv import tensor_version
from plumekit_torch.models.kernels.int8_conv import KC, Shape, round_up

#: launches of Q2 since import (or since a caller reset it)
LAUNCHES = 0

_PACKED = WeakIdKeyDictionary()


def upsample_columns(kq):
    """(Cin, 4·Cout) int8: column ``(2·di + dj)·Cout + o`` is
    ``kq[di, dj, :, o]``, the order of the product's columns."""
    cin, cout = kq.shape[2:]
    return kq.permute(2, 0, 1, 3).reshape(cin, 4 * cout)


def upsample_dequant_ref(xq, kq, sw, bias):
    """The transposed conv in fp32 before its requant (``_upsample_q`` of
    the JAX package): one s8 product over (B·h·w, Cin) × (Cin, 4·Cout)
    through :func:`int8_conv.int_mm`, ``acc·sw + bias`` (two roundings),
    and the pixel shuffle."""
    b, h, w, cin = xq.shape
    cout = kq.shape[-1]
    acc = int8_conv.int_mm(xq.reshape(-1, cin), upsample_columns(kq)) \
        .reshape(b, h, w, 2, 2, cout)
    y = acc.float() * sw + bias
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)


def int8_upsample2x2_ref(xq, kq, sw, bias, out_scale):
    """Plain version of Q2: ``clamp(rint(y / out_scale), -127, 127)`` of
    :func:`upsample_dequant_ref`, each step rounding once as the kernel's
    epilogue does."""
    return int8_conv.quant_act(upsample_dequant_ref(xq, kq, sw, bias),
                               out_scale)


def upsample_shape(cout: int) -> Shape:
    """The rule, from timing the four upsamples of the int8 forward at
    128 × 288² at every candidate shape (PERF.md §6): blocks of 256
    packed columns over 128 pixels from 512 columns on, else of 64 columns
    over 256 pixels (32 over 512 for the narrowest)."""
    n = round_up(4 * cout, KC)
    if n <= 32:
        return Shape(32, 4)
    if n < 512:
        return Shape(64, 2)
    return Shape(256, 1)


def upsample_candidates(cout: int):
    """The unfolded shapes whose blocks are no wider than the padded
    columns and at least an eighth of them (of 256)."""
    n = round_up(4 * cout, KC)
    return [s for s in int8_conv.SHAPES
            if not s.fold and s.nb <= n and 8 * s.nb >= min(n, 256)]


@dataclass
class PackedUpsample:
    """One transposed conv as Q2 reads it at ``shape``: weights
    [Np / nb][Kp / 32][1][2][nb][16] int8, ``a`` (sw) and ``b`` (bias)
    per packed column, (Np,) fp32, zero padded."""

    wt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    cin: int
    cout: int
    shape: Shape

    @property
    def kp(self) -> int:
        return self.wt.shape[1] * KC

    @property
    def np_(self) -> int:
        return self.wt.shape[0] * self.shape.nb


def pack_upsample_weights(kq, shape: Shape):
    """``kq`` → Q2's layout at ``shape``: per pass of ``nb`` columns, per
    32-channel chunk of the input, its two groups of 16 channels, each
    ``nb`` rows of 16 bytes (the K-major core matrices of the wgmma B
    operand)."""
    cin, cout = kq.shape[2:]
    np_ = round_up(4 * cout, shape.nb)
    kp = round_up(cin, KC)
    flat = torch.zeros((np_, kp), dtype=torch.int8, device=kq.device)
    flat[:4 * cout, :cin] = upsample_columns(kq).t()
    return flat.reshape(np_ // shape.nb, shape.nb, 1, kp // KC, 2, 16) \
        .permute(0, 3, 2, 4, 1, 5).contiguous()


def pack_upsample(kq, sw, bias, shape: Optional[Shape] = None
                  ) -> PackedUpsample:
    """``kq``, ``sw`` and ``bias`` packed for Q2 at ``shape`` (the rule's
    by default), cached per weight tensor and shape and refreshed when any
    is another tensor or was written in place."""
    cin, cout = kq.shape[2:]
    if (tuple(kq.shape) != (2, 2, cin, cout) or kq.dtype != torch.int8
            or sw.shape != (cout,) or bias.shape != (cout,)):
        raise ValueError(f"kernel {tuple(kq.shape)} {kq.dtype}, sw "
                         f"{tuple(sw.shape)} and bias {tuple(bias.shape)} "
                         "do not fit")
    shape = upsample_shape(cout) if shape is None else shape
    if shape.fold:
        raise ValueError("a transposed conv has no folded shape")
    key = (shape, tensor_version(kq), tensor_version(sw),
           tensor_version(bias))
    cache = _PACKED.setdefault(kq, {})
    hit = cache.get(shape)
    if hit is not None and hit[0] == key and hit[1] is sw and hit[2] is bias:
        return hit[3]
    np_ = round_up(4 * cout, shape.nb)
    with torch.no_grad():
        packed = PackedUpsample(
            pack_upsample_weights(kq, shape),
            F.pad(sw.float().repeat(4), (0, np_ - 4 * cout)).contiguous(),
            F.pad(bias.float().repeat(4), (0, np_ - 4 * cout)).contiguous(),
            cin, cout, shape)
    cache[shape] = (key, sw, bias, packed)
    return packed


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("int8_conv.cu", "pk_int8_upsample2x2",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])


def _launch(xq, packed: PackedUpsample, out_scale):
    """One launch of Q2: every launch of it comes through here."""
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    if xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous():
        raise ValueError(f"Q2 takes a contiguous (B, h, w, C) int8 plane; "
                         f"x is {tuple(xq.shape)} {xq.dtype}")
    if xq.shape[-1] % 16 == 0 and xq.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")
    if xq.shape[-1] != packed.cin:
        raise ValueError(f"a plane of {xq.shape[-1]} channels does not fit "
                         f"weights packed for {packed.cin}")
    if packed.kp != round_up(packed.cin, KC):
        raise ValueError(f"weights packed for {packed.kp} input channels do "
                         f"not fit a plane of {packed.cin}")
    for t in (packed.wt, packed.a, packed.b):
        if t.device != xq.device:
            raise ValueError("weights and input lie on different devices")
    bsz, h, w, _ = xq.shape
    scale = int8_conv.scale_tensor(out_scale, xq).reshape(1).contiguous()
    out = torch.empty((bsz, 2 * h, 2 * w, packed.cout), dtype=torch.int8,
                      device=xq.device)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_int8_upsample2x2(
            xq.data_ptr(), packed.wt.data_ptr(), packed.a.data_ptr(),
            packed.b.data_ptr(), scale.data_ptr(), out.data_ptr(), bsz, h, w,
            packed.cin, packed.kp, packed.cout, packed.np_, packed.shape.nb,
            packed.shape.mt, stream)
    if err != 0:
        raise RuntimeError("int8 upsample kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out


@torch.library.custom_op("plumekit::int8_upsample2x2", mutates_args=(),
                         device_types="cpu")
def int8_upsample2x2_op(xq: Tensor, w: Tensor, a: Tensor, b: Tensor,
                        out_scale: Tensor, cout: int) -> Tensor:
    """Q2 as an op: (B, h, w, Cin) int8 → (B, 2h, 2w, ``cout``) int8. CPU:
    :func:`int8_upsample2x2_ref` on ``kq``, ``sw``, ``bias``; CUDA: one
    launch on them as :func:`pack_upsample` packs them."""
    return int8_upsample2x2_ref(xq, w, a, b, out_scale)


@int8_upsample2x2_op.register_kernel("cuda")
def _int8_upsample2x2_cuda(xq, w, a, b, out_scale, cout):
    return _launch(xq, PackedUpsample(w, a, b, xq.shape[-1], cout,
                                      int8_conv.packed_shape(w, False)),
                   out_scale)


@int8_upsample2x2_op.register_fake
def _int8_upsample2x2_fake(xq, w, a, b, out_scale, cout):
    return xq.new_empty((xq.shape[0], 2 * xq.shape[1], 2 * xq.shape[2],
                         cout))


def upsample_op(xq, w, a, b, out_scale, cout: int):
    """Q2's op on weights as the device's implementation reads them (raw
    on the CPU, packed on the card), on a contiguous plane."""
    return int8_upsample2x2_op(xq.contiguous(), w, a, b,
                               int8_conv.scale_tensor(out_scale, xq), cout)


def int8_upsample2x2_packed(xq, packed: PackedUpsample, out_scale):
    """Q2 on weights packed by :func:`pack_upsample`: one launch."""
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    if xq.shape[-1] != packed.cin:
        raise ValueError(f"a plane of {xq.shape[-1]} channels does not fit "
                         f"weights packed for {packed.cin}")
    return int8_upsample2x2_op(xq, packed.wt, packed.a, packed.b,
                               int8_conv.scale_tensor(out_scale, xq),
                               packed.cout)


def int8_upsample2x2(xq, kq, sw, bias, out_scale):
    """One 2×2 stride-2 transposed conv in int8 with its requant (Q2).

    xq: (B, h, w, Cin) int8; kq: (2, 2, Cin, Cout) int8, pre-flipped; sw,
    bias: (Cout,) fp32; out_scale: the output's scale. Returns (B, 2h, 2w,
    Cout) int8. A CPU tensor takes :func:`int8_upsample2x2_ref`, a CUDA
    tensor the kernel."""
    if xq.device.type == "cpu":
        return upsample_op(xq, kq, sw, bias, out_scale, kq.shape[-1])
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    return int8_upsample2x2_packed(xq, pack_upsample(kq, sw, bias),
                                   out_scale)
