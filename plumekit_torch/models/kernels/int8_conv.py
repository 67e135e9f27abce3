"""Q1: the int8 forward's 3×3 conv, s8×s8→s32 with the fused dequant,
BatchNorm, ReLU and requant epilogue.

Replaces no Pallas kernel: the JAX package leaves this conv to XLA
(``_qconv``, ``plumekit/models/quantized_forward.py:133``), which the TPU
runs on its native int8 path. PyTorch has no int8 convolution on CUDA, so
the card runs the hand-written kernel ``plumekit_torch/csrc/int8_conv.cu``
(``mma.sync`` m16n8k32 s8; the source notes give the design), one launch
per conv, and every other device the plain version here, nine shifted views
of the padded input through ``torch._int_mm``.

Layouts follow the JAX package: activations NHWC int8, weights HWIO int8,
the epilogue's multiplier ``a`` and shift ``b`` per output channel in fp32,
the output scale one fp32 number. A decoder block's first conv reads the
concat ``[skip, x]``: pass ``skip`` and the kernel reads both planes, so the
concat is never written. The entry runs the plain version for a tensor on
the CPU and the kernel for a tensor on the card; it never falls back from
the kernel. Weights are packed once per weight tensor and device and again
only after the tensor changed in place.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from plumekit_torch.models.kernels.conv_tiles import round_up
from plumekit_torch.models.kernels.fused_conv import tensor_version

#: launches of Q1 since import (or since a caller reset it)
LAUNCHES = 0

#: input channels per k step of the kernel (m16n8k32): each source's
#: channels are padded to a multiple of this, and output channels to blocks
#: of as many
KC = 32

_PACKED = WeakIdKeyDictionary()


def scale_tensor(scale, like):
    """``scale`` as a float32 tensor on ``like``'s device, for a division:
    a CPU scalar would take PyTorch's CUDA division by a scalar, which
    multiplies by the reciprocal and is not the IEEE quotient the kernel
    and the JAX package compute."""
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def quant_act(x, scale):
    """fp → symmetric int8 at per-tensor ``scale``: ``clamp(round(x /
    scale), -127, 127)``, half to even (``_quant_act`` of the JAX
    package)."""
    return torch.clamp(torch.round(x / scale_tensor(scale, x)), -127, 127) \
        .to(torch.int8)


def int_mm(a, b):
    """``a @ b`` of int8 matrices with exact int32 sums, through
    ``torch._int_mm``. Its CUDA form (cuBLASLt) takes more than 16 rows and
    multiples of 8 for the depth and the width, so zero rows and columns pad
    up to those and are cut off again; and ``b`` goes in column-major order,
    since on an H100 cuBLASLt refused a row-major ``b`` for most shapes
    (CUBLAS_STATUS_NOT_SUPPORTED) and took a column-major one for all."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), round_up(k, 8), round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_conv3x3_acc_ref(xq, wq, skip=None):
    """The s32 accumulators of the SAME 3×3 conv of ``concat([skip, xq])``
    (or ``xq``) with HWIO ``wq``: nine shifted views of the zero-padded
    input, each an exact ``torch._int_mm`` (:func:`int_mm` pads the input
    channels with zeros: the input conv has 2)."""
    x = xq if skip is None else torch.cat([skip, xq], dim=-1)
    b, h, w, cin = x.shape
    if tuple(wq.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weight {tuple(wq.shape)} does not fit an input of "
                         f"{cin} channels")
    cout = wq.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = int_mm(xp[:, dy:dy + h, dx:dx + w].reshape(-1, cin),
                         wq[dy, dx])
            acc = tap if acc is None else acc.add_(tap)
    return acc.reshape(b, h, w, cout)


def int8_conv3x3_ref(xq, wq, a, b, out_scale=None, skip=None):
    """Plain version of Q1: ``y = relu(acc.float() * a + b)`` over the
    exact accumulators of :func:`int8_conv3x3_acc_ref`; with ``out_scale``
    the int8 ``clamp(round(y / out_scale), -127, 127)``, else fp32 ``y``
    (the last decoder block's second conv, which feeds the fp32 head). Each
    step rounds once, as the kernel's epilogue does."""
    acc = int8_conv3x3_acc_ref(xq, wq, skip)
    y = torch.relu(acc.float() * a + b)
    return y if out_scale is None else quant_act(y, out_scale)


@dataclass
class PackedInt8Conv:
    """One conv as Q1 reads it: weights (Np, 9, Kp) int8, the first
    source's ``c0`` channels at k < ``c0p``, the second source's ``c1``
    from ``c0p`` on, zero in every padding; ``a`` and ``b`` (Np,) fp32."""

    wt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c0: int
    c1: int
    cout: int

    @property
    def c0p(self) -> int:
        return round_up(self.c0, KC)


def pack_int8_weights(wq, c0: int):
    """HWIO int8 ``wq`` → Q1's (Np, 9, Kp) layout; input channels below
    ``c0`` are the first source's."""
    cin, cout = wq.shape[2:]
    c1 = cin - c0
    c0p = round_up(c0, KC)
    kp = c0p + round_up(c1, KC)
    packed = torch.zeros((round_up(cout, KC), 9, kp), dtype=torch.int8,
                         device=wq.device)
    taps = wq.reshape(9, cin, cout).permute(2, 0, 1)        # (cout, 9, cin)
    packed[:cout, :, :c0] = taps[:, :, :c0]
    packed[:cout, :, c0p:c0p + c1] = taps[:, :, c0:]
    return packed


def pack_conv(wq, a, b, c0: Optional[int] = None) -> PackedInt8Conv:
    """``wq``, ``a`` and ``b`` packed for Q1, cached per weight tensor and
    refreshed when ``wq``, ``a`` or ``b`` is another tensor or was written
    in place. ``c0``: the first source's channels (all by default)."""
    cin, cout = wq.shape[2:]
    c0 = cin if c0 is None else c0
    if (tuple(wq.shape) != (3, 3, cin, cout) or wq.dtype != torch.int8
            or a.shape != (cout,) or b.shape != (cout,) or not 0 < c0 <= cin):
        raise ValueError(f"weight {tuple(wq.shape)} {wq.dtype}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} and a first "
                         f"source of {c0} channels do not fit")
    key = (c0, tensor_version(wq), tensor_version(a), tensor_version(b))
    hit = _PACKED.get(wq)
    if hit is not None and hit[0] == key and hit[1] is a and hit[2] is b:
        return hit[3]
    np_ = round_up(cout, KC)
    with torch.no_grad():
        packed = PackedInt8Conv(
            pack_int8_weights(wq, c0),
            F.pad(a.float(), (0, np_ - cout)).contiguous(),
            F.pad(b.float(), (0, np_ - cout)).contiguous(), c0, cin - c0,
            cout)
    _PACKED[wq] = (key, a, b, packed)
    return packed


def conv_tile(h: int, w: int) -> int:
    """Q1's output tile side: 16, or 8 where 16 would cover more than 1.5
    times the pixels 8 covers (the 18² bottleneck of 288² tiles)."""
    def covered(t):
        return -(-h // t) * -(-w // t) * t * t

    return 8 if covered(16) > 1.5 * covered(8) else 16


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("int8_conv.cu", "pk_int8_conv3x3",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                      + [ctypes.c_void_p])


def _check_plane(x, name):
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"Q1 takes contiguous (B, H, W, C) int8 planes; "
                         f"{name} is {tuple(x.shape)} {x.dtype}")
    if x.shape[-1] % 16 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def int8_conv3x3_packed(xq, packed: PackedInt8Conv, out_scale=None,
                        skip=None, tile: Optional[int] = None):
    """Q1 on weights packed by :func:`pack_conv`: one launch. ``tile``: the
    output tile side, 16 or 8 (:func:`conv_tile` by default)."""
    x0, x1 = (xq, None) if skip is None else (skip, xq)
    for name, t in (("x", xq), ("skip", skip)):
        if t is not None:
            if t.device.type != "cuda":
                raise ValueError(f"no kernel for device {t.device}")
            _check_plane(t, name)
    if x0.shape[-1] != packed.c0 or (0 if x1 is None else x1.shape[-1]) \
            != packed.c1 or (x1 is not None and x1.shape[:3] != x0.shape[:3]):
        raise ValueError(f"planes {tuple(x0.shape)} and "
                         f"{None if x1 is None else tuple(x1.shape)} do not "
                         f"fit weights packed for {packed.c0} + {packed.c1} "
                         "channels")
    for t in (packed.wt, packed.a, packed.b):
        if t.device != xq.device:
            raise ValueError("weights and input lie on different devices")
    bsz, h, w, _ = x0.shape
    tile = conv_tile(h, w) if tile is None else tile
    if tile not in (8, 16):
        raise ValueError(f"Q1 has no tile of side {tile}")
    if out_scale is not None:
        scale = scale_tensor(out_scale, xq).reshape(1).contiguous()
        out = torch.empty((bsz, h, w, packed.cout), dtype=torch.int8,
                          device=xq.device)
    else:
        scale = None
        out = torch.empty((bsz, h, w, packed.cout), dtype=torch.float32,
                          device=xq.device)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_int8_conv3x3(
            x0.data_ptr(), None if x1 is None else x1.data_ptr(),
            packed.wt.data_ptr(), packed.a.data_ptr(), packed.b.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            bsz, h, w, packed.c0, packed.c0p, packed.c1, packed.wt.shape[2],
            packed.cout, packed.wt.shape[0], tile, stream)
    if err != 0:
        raise RuntimeError("int8 conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    LAUNCHES += 1
    return out


def int8_conv3x3(xq, wq, a, b, out_scale=None, skip=None):
    """One SAME 3×3 int8 conv with the fused epilogue (Q1).

    xq: (B, H, W, C1) int8; wq: (3, 3, C0 + C1, Cout) int8 (HWIO), the
    first C0 input channels those of ``skip`` (B, H, W, C0) when given; a,
    b: (Cout,) fp32; out_scale: the output's scale (int8 out) or None (fp32
    out). A CPU tensor takes :func:`int8_conv3x3_ref`, a CUDA tensor the
    kernel."""
    if xq.device.type == "cpu":
        return int8_conv3x3_ref(xq, wq, a, b, out_scale, skip)
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    c0 = None if skip is None else skip.shape[-1]
    return int8_conv3x3_packed(xq, pack_conv(wq, a, b, c0), out_scale, skip)
