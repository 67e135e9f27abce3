"""Q2: the int8 forward's 2×2 stride-2 transposed conv with its requant,
one kernel.

Replaces no Pallas kernel: the JAX package computes it as one s8 einsum
with its dequant, pixel shuffle and requant (``_upsample_q`` and
``_quant_act``, ``plumekit/models/quantized_forward.py:145-154`` and
``:116-118``, applied at ``:370-372``), which XLA fuses. The plain version
here is the port's eager path: ``torch._int_mm`` writes the int32 product
and eight more passes cast, scale, shift, shuffle, divide, round, clamp and
narrow it. The card runs the hand-written kernel
``plumekit_torch/csrc/int8_upsample.cu`` (``pk_int8_upsample2x2``: a GEMM of
M = B·h·w pixels, K = Cin and the 4·Cout columns on ``wgmma``, the input by
TMA into a ring of stages, the requant and the pixel shuffle in its
epilogue and TMA stores out of a swizzled tile, so the int32 product never
reaches device memory; the source notes give the design), one launch per
upsample.

Packed columns run ``di·Cp + dj·Cout + o`` (``Cp``: 2·Cout padded to its
chunk width, :func:`packed_columns`), so that one ``di`` of a pixel is the
2·Cout bytes of two neighbouring output pixels. The launch shape
(:class:`UpsampleShape`: columns a pass, slices of the weights) comes from
the rule here, decided by timing every candidate
(``experiments/int8_conv_times.py --tiles``), and each launch's items from
:func:`item_block`. A packed weight carries its own layout
(:func:`packed_shape`).

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
import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor
from torch.utils.weak import WeakIdKeyDictionary

from plumekit_torch.cuda_build import LAUNCH_LOCK
from plumekit_torch.models.kernels import int8_conv
from plumekit_torch.models.kernels.fused_conv import tensor_version
from plumekit_torch.models.kernels.int8_conv import round_up

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


#: the largest slice of weights one block keeps in shared memory
MAX_SLICE_BYTES = 128 * 1024
#: a slice of columns near the smallest cost counts as a tie, and the
#: longer runs win it (``item_block``)
ITEM_SLACK = 1.03


def chunk_width(nbytes: int) -> int:
    """The swizzle width of rows of ``nbytes``: 32, 64 or 128 bytes (a
    wider row is cut into chunks of 128)."""
    return 32 if nbytes <= 32 else 64 if nbytes <= 64 else 128


def packed_columns(cout: int):
    """(cb, n_cc, Np): a quadrant row's 2·Cout bytes in ``n_cc`` chunks of
    ``cb`` bytes, and the packed columns, ``2·n_cc·cb``: column
    ``di·n_cc·cb + dj·Cout + o``."""
    cb = chunk_width(2 * cout)
    n_cc = -(-2 * cout // cb)
    return cb, n_cc, 2 * n_cc * cb


def packed_column_index(cout: int):
    """(4·Cout,) int64: the packed column of product column
    ``(2·di + dj)·Cout + o`` (the order of :func:`upsample_columns`)."""
    cb, n_cc, _ = packed_columns(cout)
    idx = torch.arange(4 * cout)
    quad, o = idx // cout, idx % cout
    return (quad // 2) * (n_cc * cb) + (quad % 2) * cout + o


#: the pass widths the kernel is built for, and the m64 tiles an item
#: takes at each (``dispatch`` in the source)
MT_OF = {64: (2,), 128: (1, 2), 256: (1,)}
PASS_WIDTHS = tuple(MT_OF)
#: the m64 tiles a launch on a packed weight takes (the op reads the
#: weight's layout, which holds the pass width and not this)
DEFAULT_MT = {64: 2, 128: 1, 256: 1}


@dataclass(frozen=True)
class UpsampleShape:
    """One launch shape of Q2: ``nb`` packed columns a pass (one wgmma
    m64``nb``k32 per m64 tile and k step), ``slices``: the columns cut into
    that many slices, one per block, each held in shared memory for the
    whole launch (these two are the packed weight's layout), and ``mt`` m64
    tiles an item (``DEFAULT_MT`` by default). The accumulators take
    nb·mt/2 registers a thread; at most 64 leave room for three consumer
    warpgroups, else two."""

    nb: int
    slices: int = 1
    mt: int = 0

    def __post_init__(self):
        if not self.mt:
            object.__setattr__(self, "mt", DEFAULT_MT.get(self.nb, 1))

    @property
    def rows(self) -> int:
        """GEMM rows of an item: 64·mt."""
        return 64 * self.mt

    @property
    def consumers(self) -> int:
        return 3 if self.nb * self.mt <= 128 else 2


#: input stages a launch holds at most (``kMaxStages`` in the source)
MAX_STAGES = 12


def smem_stages(cin: int, cout: int, shape: UpsampleShape) -> int:
    """The input stages a launch at ``shape`` holds with one output buffer
    a consumer (``launch`` in the source), or 0 where a slice of several
    passes cannot hold all of an item's n_k chunks: such a shape does not
    fit a block's shared memory."""
    kb = chunk_width(cin)
    n_k = -(-cin // kb)
    s_cols = packed_columns(cout)[2] // shape.slices
    fixed = (1024 + round_up(n_k * s_cols * kb, 1024) + shape.consumers
             * shape.rows * shape.nb + round_up(8 * s_cols + 8, 128)
             + 8 * (2 * MAX_STAGES + 1 + shape.consumers))
    stages = min(MAX_STAGES, max(0, int8_conv.SMEM_LIMIT - fixed)
                 // (shape.rows * kb))
    return stages if stages >= (n_k if s_cols > shape.nb else 1) else 0


def upsample_candidates(cin: int, cout: int):
    """The shapes an upsample may take: a pass width that holds whole
    output chunks and divides the packed columns, over the fewest slices
    whose weights fit a block (at most 128 KB) and over twice as many, at
    each item height built for it, where the block's shared memory holds
    them."""
    kb = chunk_width(cin)
    kp = round_up(cin, kb)
    cb, _, np_ = packed_columns(cout)
    out = []
    for nb in PASS_WIDTHS:
        if nb % cb or np_ % nb:
            continue
        fits = [s for s in (1, 2, 4, 8, 16)
                if np_ % (s * nb) == 0
                and np_ // s * kp <= MAX_SLICE_BYTES]
        out += [UpsampleShape(nb, s, mt) for s in fits[:2]
                for mt in MT_OF[nb]
                if smem_stages(cin, cout, UpsampleShape(nb, s, mt))]
    return out


#: a slice the rule prefers: at most this many bytes of weights
RULE_SLICE_BYTES = 64 * 1024


@functools.lru_cache(maxsize=None)
def upsample_shape(cin: int, cout: int) -> UpsampleShape:
    """The rule, from timing every candidate at 128 tiles of 288², 256²,
    384² and 512² (PERF.md §6): passes of 128 packed columns, or of 64
    where there are 128 columns in all; over the fewest slices of at most
    64 KB of weights (Cin 512: 8, Cin 256: 2), else the fewest that fit;
    items of one m64 tile (three consumer warpgroups), of two at 64
    columns a pass and where an item takes four chunks or more (Cin 512:
    the larger item amortises its longer wgmma phase)."""
    np_ = packed_columns(cout)[2]
    kb = chunk_width(cin)
    kp = round_up(cin, kb)
    nb = 64 if np_ <= 128 else 128
    mt = 2 if nb == 64 or kp // kb >= 4 else 1
    cands = upsample_candidates(cin, cout)
    pick = ([s for s in cands if (s.nb, s.mt) == (nb, mt)]
            or [s for s in cands if s.mt == DEFAULT_MT[s.nb]])
    small = [s for s in pick
             if np_ // s.slices * kp <= RULE_SLICE_BYTES]
    return min(small or pick, key=lambda s: s.slices)


def launch_mt(cin: int, cout: int, layout: UpsampleShape) -> int:
    """The m64 tiles an item of a launch on weights packed at ``layout``
    (columns a pass and slices: all a packed weight says) takes: the
    rule's where the layout is the rule's, else ``DEFAULT_MT``."""
    rule = upsample_shape(cin, cout)
    if (rule.nb, rule.slices) == (layout.nb, layout.slices):
        return rule.mt
    return DEFAULT_MT[layout.nb]


#: item widths: k rows of n pixels fill the 64·mt GEMM rows exactly, and
#: the network's widths (9, 3 or 1 times a power of two) waste none
ITEM_WIDTHS = (1, 2, 4, 8, 16)


@functools.lru_cache(maxsize=None)
def item_block(w: int, rows: int, rm: int):
    """(n, k): an item is k rows by n columns of a plane of ``rows`` rows
    of ``w`` pixels, n one of ``ITEM_WIDTHS`` and k·n = ``rm`` GEMM rows
    (fewer on a plane of fewer rows). The fewest items (rows computed in
    all), and among those within ``ITEM_SLACK`` of the fewest the widest n
    (longer runs of the output)."""
    costs = []
    for n in ITEM_WIDTHS:
        if n > w:
            break
        k = min(rm // n, rows)
        costs.append((-(-w // n) * -(-rows // k), n, k))
    least = min(c for c, _, _ in costs)
    return max((n, k) for c, n, k in costs if c <= ITEM_SLACK * least)


@dataclass
class PackedUpsample:
    """One transposed conv as Q2 reads it: weights [slices][Kp / kb]
    [passes][nb][kb] int8 (:func:`pack_upsample_weights`), ``a`` (sw) and
    ``b`` (bias) per packed column, (Np,) fp32, zero padded. The layout
    reads off ``wt``."""

    wt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    cin: int
    cout: int
    #: m64 tiles an item; 0: :func:`launch_mt`'s
    mt: int = 0

    @property
    def shape(self) -> UpsampleShape:
        layout = packed_shape(self.wt)
        return UpsampleShape(layout.nb, layout.slices, self.mt or launch_mt(
            self.cin, self.cout, layout))

    @property
    def kb(self) -> int:
        return self.wt.shape[4]

    @property
    def kp(self) -> int:
        return self.wt.shape[1] * self.kb

    @property
    def slice_columns(self) -> int:
        return self.wt.shape[2] * self.wt.shape[3]

    @property
    def np_(self) -> int:
        return self.wt.shape[0] * self.slice_columns


def swizzle_positions(rows: int, width: int):
    """(rows, width) int64: where byte c of row r of a tile of ``width``-
    byte rows lies in shared memory, from the tile's start: its 16-byte
    chunk XOR bits 7.. of the row's offset (TMA's and the wgmma
    descriptor's 32, 64 and 128-byte swizzles)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(width)[None, :]
    off = r * width + c
    return off ^ (((off >> 7) & (width // 16 - 1)) << 4)


def pack_upsample_weights(kq, shape: UpsampleShape):
    """``kq`` → Q2's layout at ``shape``: per slice, per chunk of ``kb``
    input channels, the slice's columns as rows of ``kb`` bytes, each row
    swizzled as the kernel's shared memory holds it (the K-major B operand
    of its wgmmas), so that a slice arrives by plain bulk copies."""
    cin, cout = kq.shape[2:]
    kb = chunk_width(cin)
    kp = round_up(cin, kb)
    np_ = packed_columns(cout)[2]
    per = np_ // shape.slices
    flat = torch.zeros((np_, kp), dtype=torch.int8, device=kq.device)
    flat[packed_column_index(cout).to(kq.device), :cin] = \
        upsample_columns(kq).t()
    tiles = flat.reshape(shape.slices, per, kp // kb, kb).permute(0, 2, 1, 3)
    pos = swizzle_positions(per, kb).reshape(-1).to(kq.device)
    out = torch.empty_like(tiles).reshape(shape.slices, kp // kb, -1)
    out[:, :, pos] = tiles.reshape(shape.slices, kp // kb, -1)
    return out.reshape(shape.slices, kp // kb, per // shape.nb, shape.nb, kb)


def packed_shape(wt) -> UpsampleShape:
    """The shape a weight packed by :func:`pack_upsample_weights` was laid
    out for: a weight of any other layout (Q1's among them) is refused."""
    if (wt.dim() != 5 or wt.dtype != torch.int8
            or wt.shape[3] not in PASS_WIDTHS
            or wt.shape[4] not in (32, 64, 128)):
        raise ValueError(f"{tuple(wt.shape)} {wt.dtype} is no weight packed "
                         "for Q2")
    return UpsampleShape(wt.shape[3], wt.shape[0])


def pack_upsample(kq, sw, bias, shape: Optional[UpsampleShape] = None
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
    shape = upsample_shape(cin, cout) if shape is None else shape
    if shape not in upsample_candidates(cin, cout):
        raise ValueError(f"{shape} is no shape of a {cin} -> {cout} "
                         "transposed conv")
    key = (shape, tensor_version(kq), tensor_version(sw),
           tensor_version(bias))
    cache = _PACKED.setdefault(kq, {})
    hit = cache.get(shape)
    if hit is not None and hit[0] == key and hit[1] is sw and hit[2] is bias:
        return hit[3]
    np_ = packed_columns(cout)[2]
    idx = packed_column_index(cout).to(kq.device)
    with torch.no_grad():
        a = torch.zeros(np_, dtype=torch.float32, device=kq.device)
        b = torch.zeros(np_, dtype=torch.float32, device=kq.device)
        a[idx] = sw.float().repeat(4)
        b[idx] = bias.float().repeat(4)
        packed = PackedUpsample(pack_upsample_weights(kq, shape), a, b, cin,
                                cout, shape.mt)
    cache[shape] = (key, sw, bias, packed)
    return packed


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("int8_upsample.cu", "pk_int8_upsample2x2",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                      + [ctypes.c_void_p] * 2)


#: passes a consumer of block 0 stamps, and the clocks of each
STAMP_PASSES, STAMP_POINTS = 64, 7


def _launch(xq, packed: PackedUpsample, out_scale, stamps=None):
    """One launch of Q2: every launch of it comes through here. ``stamps``:
    None, or a (3, STAMP_PASSES, STAMP_POINTS) int64 tensor on the card
    that block 0's consumers fill with the clocks of their first passes
    (start, turn come, first chunk landed, wgmmas done, output buffer
    free, epilogue done, stores issued), for
    ``experiments/int8_conv_times.py``."""
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
    shape = packed.shape
    if shape.mt not in MT_OF[shape.nb]:
        raise ValueError(f"no kernel takes {shape}")
    if (packed.kb != chunk_width(packed.cin)
            or packed.kp != round_up(packed.cin, packed.kb)
            or packed.np_ != packed_columns(packed.cout)[2]
            or packed.a.shape != (packed.np_,)
            or packed.b.shape != (packed.np_,)):
        raise ValueError(f"weights packed as {tuple(packed.wt.shape)} do "
                         f"not fit a {packed.cin} -> {packed.cout} "
                         "transposed conv")
    for t in (packed.wt, packed.a, packed.b):
        if t.device != xq.device:
            raise ValueError("weights and input lie on different devices")
    bsz, h, w, _ = xq.shape
    n, k = item_block(w, bsz * h, shape.rows)
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
            packed.cin, packed.cout, shape.slices, packed.slice_columns,
            packed.kb, shape.nb, shape.mt, n, k,
            None if stamps is None else stamps.data_ptr(), stream)
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
    # the layout reads off w, which must be packed for Q2
    packed_shape(w)
    return _launch(xq, PackedUpsample(w, a, b, xq.shape[-1], cout),
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
