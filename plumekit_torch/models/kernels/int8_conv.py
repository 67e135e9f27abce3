"""Q1: the int8 forward's 3×3 conv, s8×s8→s32 with the fused dequant,
BatchNorm, ReLU and requant epilogue.

Replaces no Pallas kernel: the JAX package leaves this conv to XLA
(``_qconv``, ``plumekit/models/quantized_forward.py:133``), which the TPU
runs on its native int8 path. PyTorch has no int8 convolution on CUDA, so
the card runs the hand-written kernel ``plumekit_torch/csrc/int8_conv.cu``
(``wgmma`` m64nNk32 s8 over the padded raster of the staged input patch;
the source notes give the design), one launch per conv, and every other
device the plain version here, nine shifted views of the padded input
through ``torch._int_mm``.

The kernel's shape per conv (:class:`Shape`: output channels per block,
rows per block, the input conv's tap fold) and its tile (:func:`conv_tile`)
come from the rule here, which timing each conv at each shape decided
(``experiments/int8_conv_times.py --tiles``).

Layouts follow the JAX package: activations NHWC int8, weights HWIO int8,
the epilogue's multiplier ``a`` and shift ``b`` per output channel in fp32,
the output scale one fp32 number. A decoder block's first conv reads the
concat ``[skip, x]``: pass ``skip`` and the kernel reads both planes, so the
concat is never written. The entry runs the plain version for a tensor on
the CPU and the kernel for a tensor on the card; it never falls back from
the kernel. Weights are packed once per weight tensor and device and again
only after the tensor changed in place.

Q1 is the ``torch.library`` custom op ``plumekit::int8_conv3x3``, so that
``torch.export`` and graph tools see it: its CPU implementation is the
plain version on the HWIO weight, its CUDA one the kernel's launch on the
weight, ``a`` and ``b`` packed by :func:`pack_conv` (the kernel's shape is
read off the packed weight's layout), its fake one the output's shape and
dtype.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils.weak import WeakIdKeyDictionary

from plumekit_torch.cuda_build import LAUNCH_LOCK
from plumekit_torch.models.kernels.conv_tiles import round_up
from plumekit_torch.models.kernels.fused_conv import tensor_version

#: launches of Q1 since import (or since a caller reset it)
LAUNCHES = 0

#: input channels per k step of the kernel (m64nNk32): each source's
#: channels are padded to a multiple of this
KC = 32
#: shared memory one block may opt in to on an H100 (227 KB)
SMEM_LIMIT = 232_448

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


@dataclass(frozen=True)
class Shape:
    """One instantiation of the kernel: ``nb`` output channels per block
    (one wgmma m64n``nb``k32 per m64 tile, tap and chunk), ``mt`` m64 tiles
    per warpgroup (``128·mt`` GEMM rows per block: the accumulators take
    ``nb·mt/2`` registers a thread), and ``fold``: the 9 taps × at most 3
    input channels of a pixel as its one k32 row (the network's input
    conv), the rows then the tile's pixels, not a padded raster."""

    nb: int
    mt: int
    fold: bool = False

    @property
    def rows(self) -> int:
        return 128 * self.mt

    @property
    def taps(self) -> int:
        return 1 if self.fold else 9


#: the shapes the kernel is built for (``dispatch`` in the source)
SHAPES = (Shape(32, 4), Shape(32, 4, True), Shape(64, 2), Shape(128, 2),
          Shape(256, 1))


def can_fold(c0: int, c1: int) -> bool:
    """Whether a conv's 9 taps × input channels fit one k32 row."""
    return c1 == 0 and 9 * c0 <= KC


def shape_candidates(c0: int, c1: int, cout: int):
    """The shapes a conv may take: the fold where it fits, and every
    unfolded shape whose blocks are no wider than the padded output and
    at least an eighth of it."""
    cout_p = round_up(cout, KC)
    return [s for s in SHAPES
            if (not s.fold or can_fold(c0, c1))
            and s.nb <= cout_p and 8 * s.nb >= min(cout_p, 256)]


def conv_shape(c0: int, c1: int, cout: int) -> Shape:
    """The rule, from timing every conv of the int8 forward at 128 × 288²
    at every candidate shape (PERF.md §6): the fold for the input
    conv; 32 and 64 channels all in one block of 512 and 256 rows; up to
    256 in blocks of 128 over 256 rows (at 128 channels 64 over 256 ran
    2-5% faster, but staged the input twice); 512 in blocks of 256 over
    128 rows (20-30% ahead of 128 there)."""
    if can_fold(c0, c1):
        return Shape(32, 4, True)
    if cout <= 32:
        return Shape(32, 4)
    if cout <= 64:
        return Shape(64, 2)
    if cout <= 256:
        return Shape(128, 2)
    return Shape(256, 1)


@dataclass(frozen=True)
class Q1Tile:
    """What the C entry takes besides the planes: the shape, a th × tw
    output tile of ``images`` images per block."""

    shape: Shape
    th: int
    tw: int
    images: int


def raster_rows(th: int, tw: int, images: int) -> int:
    """GEMM rows of a raster block: the padded raster of ``images``
    patches of (th + 2) × (tw + 2) pixels, less the rows past the last
    kept one."""
    return images * (th + 2) * (tw + 2) - 2 * (tw + 2) - 2


def a_pitch(tile: Q1Tile) -> int:
    """Pixels per 16-channel group of a staged input chunk (the C entry's
    ``pitch``): every row an m64 tile reaches through a tap, +2 to spread
    the two groups over the banks."""
    rows = tile.shape.rows
    if tile.shape.fold:
        return rows + 2
    pw = tile.tw + 2
    patch = tile.images * (tile.th + 2) * pw
    return round_up(max(patch, rows + 2 * pw + 2), 8) + 2


def smem_bytes(tile: Q1Tile, c0: int = 0) -> int:
    """Shared memory of a block with its weights streamed: two step
    buffers, each a staged input chunk and its weights (the fold: and the
    raw input rows of the patch, ``c0`` bytes a pixel, from up to 3 bytes
    into a word), and the int8 stash of an item's results, each 128-byte
    aligned. (The kernel keeps a block's pass of weights resident instead
    where that fits too.)"""
    s = tile.shape
    step = 2 * a_pitch(tile) * 16 + s.taps * s.nb * 32
    if s.fold:
        step += tile.images * (tile.th + 2) * round_up((tile.tw + 2) * c0
                                                       + 3, 4)
    return 2 * round_up(step, 128) + round_up(s.rows * (s.nb + 16), 128)


@functools.lru_cache(maxsize=None)
def conv_tile(h: int, w: int, batch: int, shape: Shape) -> Q1Tile:
    """The tile of a conv over (batch, h, w) planes at ``shape``: the
    fewest blocks, each block's rows within ``shape.rows`` (every block
    costs its full rows), and among those the smallest staged patch. Tiles
    are balanced (``ceil(h / n)`` for n tile rows); a plane that fits
    whole puts several images into a block."""
    rows = shape.rows
    best = None
    for th in sorted({-(-h // n) for n in range(1, h + 1)}):
        tw_max = rows // th if shape.fold else (rows + 2) // th - 2
        if tw_max < 1:
            break
        tw = -(-w // -(-w // min(w, tw_max)))
        n_y, n_x = -(-h // th), -(-w // tw)
        images = 1
        if n_y == 1 and n_x == 1:      # whole planes: as many as fit
            while images < batch and (
                    (images + 1) * th * tw <= rows if shape.fold
                    else raster_rows(th, tw, images + 1) <= rows):
                images += 1
        blocks = -(-batch // images) * n_y * n_x
        patch = images * (th * tw if shape.fold else (th + 2) * (tw + 2))
        key = (blocks, patch)
        if best is None or key < best[0]:
            best = (key, Q1Tile(shape, th, tw, images))
    if best is None:
        raise ValueError(f"no tile of a {h}x{w} plane fits {rows} rows")
    return best[1]


@dataclass
class PackedInt8Conv:
    """One conv as Q1 reads it at ``shape``: weights [Np / nb][Kp / 32]
    [taps][2][nb][16] int8 (:func:`pack_int8_weights`), ``a`` and ``b``
    (Np,) fp32, zero padded."""

    wt: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c0: int
    c1: int
    cout: int
    shape: Shape

    @property
    def c0p(self) -> int:
        return KC if self.shape.fold else round_up(self.c0, KC)

    @property
    def kp(self) -> int:
        return self.wt.shape[1] * KC

    @property
    def np_(self) -> int:
        return self.wt.shape[0] * self.shape.nb


def pack_int8_weights(wq, c0: int, shape: Shape):
    """HWIO int8 ``wq`` → Q1's layout at ``shape``: per pass of ``nb``
    output channels, per 32-channel chunk, per tap, the chunk's two groups
    of 16 channels, each ``nb`` rows of 16 bytes (the K-major core matrices
    of the wgmma B operand, read front to back). Input channels below
    ``c0`` are the first source's, padded to 32, the rest the second's.
    The fold has one chunk and one tap: byte ``tap·c0 + c``."""
    cin, cout = wq.shape[2:]
    np_ = round_up(cout, shape.nb)
    taps = wq.reshape(9, cin, cout).permute(2, 0, 1)        # (cout, 9, cin)
    if shape.fold:
        if not can_fold(cin, 0) or c0 != cin:
            raise ValueError(f"a conv of {cin} input channels does not fold")
        flat = torch.zeros((np_, 1, KC), dtype=torch.int8, device=wq.device)
        flat[:cout, 0, :9 * cin] = taps.reshape(cout, 9 * cin)
    else:
        c1 = cin - c0
        c0p = round_up(c0, KC)
        flat = torch.zeros((np_, 9, c0p + round_up(c1, KC)),
                           dtype=torch.int8, device=wq.device)
        flat[:cout, :, :c0] = taps[:, :, :c0]
        flat[:cout, :, c0p:c0p + c1] = taps[:, :, c0:]
    n_tap, kp = flat.shape[1:]
    return flat.reshape(np_ // shape.nb, shape.nb, n_tap, kp // KC, 2, 16) \
        .permute(0, 3, 2, 4, 1, 5).contiguous()


def pack_conv(wq, a, b, c0: Optional[int] = None,
              shape: Optional[Shape] = None) -> PackedInt8Conv:
    """``wq``, ``a`` and ``b`` packed for Q1 at ``shape`` (the rule's by
    default), cached per weight tensor and shape and refreshed when ``wq``,
    ``a`` or ``b`` is another tensor or was written in place. ``c0``: the
    first source's channels (all by default)."""
    cin, cout = wq.shape[2:]
    c0 = cin if c0 is None else c0
    if (tuple(wq.shape) != (3, 3, cin, cout) or wq.dtype != torch.int8
            or a.shape != (cout,) or b.shape != (cout,) or not 0 < c0 <= cin):
        raise ValueError(f"weight {tuple(wq.shape)} {wq.dtype}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} and a first "
                         f"source of {c0} channels do not fit")
    shape = conv_shape(c0, cin - c0, cout) if shape is None else shape
    key = (c0, shape, tensor_version(wq), tensor_version(a),
           tensor_version(b))
    cache = _PACKED.setdefault(wq, {})
    hit = cache.get((c0, shape))
    if hit is not None and hit[0] == key and hit[1] is a and hit[2] is b:
        return hit[3]
    np_ = round_up(cout, shape.nb)
    with torch.no_grad():
        packed = PackedInt8Conv(
            pack_int8_weights(wq, c0, shape),
            F.pad(a.float(), (0, np_ - cout)).contiguous(),
            F.pad(b.float(), (0, np_ - cout)).contiguous(), c0, cin - c0,
            cout, shape)
    cache[(c0, shape)] = (key, a, b, packed)
    return packed


def _library():
    from plumekit_torch.cuda_build import load_entry

    return load_entry("int8_conv.cu", "pk_int8_conv3x3",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                      + [ctypes.c_void_p])


def _check_plane(x, name):
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"Q1 takes contiguous (B, H, W, C) int8 planes; "
                         f"{name} is {tuple(x.shape)} {x.dtype}")
    if x.shape[-1] % 16 == 0 and x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_fit(xq, skip, packed: PackedInt8Conv):
    x0, x1 = (xq, None) if skip is None else (skip, xq)
    if x0.shape[-1] != packed.c0 or (0 if x1 is None else x1.shape[-1]) \
            != packed.c1 or (x1 is not None and x1.shape[:3] != x0.shape[:3]):
        raise ValueError(f"planes {tuple(x0.shape)} and "
                         f"{None if x1 is None else tuple(x1.shape)} do not "
                         f"fit weights packed for {packed.c0} + {packed.c1} "
                         "channels")


def _launch(xq, packed: PackedInt8Conv, out_scale=None, skip=None,
            tile: Optional[Q1Tile] = None):
    """One launch of Q1: every launch of it comes through here."""
    x0, x1 = (xq, None) if skip is None else (skip, xq)
    for name, t in (("x", xq), ("skip", skip)):
        if t is not None:
            if t.device.type != "cuda":
                raise ValueError(f"no kernel for device {t.device}")
            _check_plane(t, name)
    _check_fit(xq, skip, packed)
    if packed.kp != (KC if packed.shape.fold else
                     round_up(packed.c0, KC) + round_up(packed.c1, KC)):
        raise ValueError(f"weights packed for {packed.kp} input channels do "
                         f"not fit {packed.c0} + {packed.c1}")
    for t in (packed.wt, packed.a, packed.b):
        if t.device != xq.device:
            raise ValueError("weights and input lie on different devices")
    bsz, h, w, _ = x0.shape
    tile = conv_tile(h, w, bsz, packed.shape) if tile is None else tile
    if tile.shape != packed.shape:
        raise ValueError(f"a tile of shape {tile.shape} for weights packed "
                         f"at {packed.shape}")
    rows = (tile.images * tile.th * tile.tw if tile.shape.fold
            else raster_rows(tile.th, tile.tw, tile.images))
    if rows > tile.shape.rows or smem_bytes(tile, packed.c0) > SMEM_LIMIT:
        raise ValueError(f"{tile} does not fit a block")
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
            bsz, h, w, packed.c0, packed.c0p, packed.c1, packed.kp,
            packed.cout, packed.np_, tile.shape.nb, tile.shape.mt,
            int(tile.shape.fold), tile.th, tile.tw, tile.images, stream)
    if err != 0:
        raise RuntimeError("int8 conv kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out


def packed_shape(wt, fold: bool) -> Shape:
    """The kernel shape a weight packed by :func:`pack_int8_weights` was
    laid out for: ``nb`` rows of 16 bytes per group."""
    if wt.dim() != 6 or wt.dtype != torch.int8 or wt.shape[3:] != (
            2, wt.shape[4], 16):
        raise ValueError(f"{tuple(wt.shape)} {wt.dtype} is no packed int8 "
                         "weight")
    for s in SHAPES:
        if s.nb == wt.shape[4] and s.fold == fold:
            return s
    raise ValueError(f"no kernel shape packs {tuple(wt.shape)}")


@torch.library.custom_op("plumekit::int8_conv3x3", mutates_args=(),
                         device_types="cpu")
def int8_conv3x3_op(xq: Tensor, w: Tensor, a: Tensor, b: Tensor,
                    out_scale: Optional[Tensor], skip: Optional[Tensor],
                    cout: int) -> Tensor:
    """Q1 as an op: ``cout`` output channels, int8 with ``out_scale``, else
    fp32. CPU: :func:`int8_conv3x3_ref` on the HWIO ``w``; CUDA: one
    launch on ``w``, ``a`` and ``b`` as :func:`pack_conv` packs them."""
    return int8_conv3x3_ref(xq, w, a, b, out_scale, skip)


@int8_conv3x3_op.register_kernel("cuda")
def _int8_conv3x3_cuda(xq, w, a, b, out_scale, skip, cout):
    c0, c1 = ((xq.shape[-1], 0) if skip is None
              else (skip.shape[-1], xq.shape[-1]))
    # the fold is the one layout with a single tap: the 9 taps in one row
    return _launch(xq, PackedInt8Conv(w, a, b, c0, c1, cout,
                                      packed_shape(w, w.shape[2] == 1)),
                   out_scale, skip)


@int8_conv3x3_op.register_fake
def _int8_conv3x3_fake(xq, w, a, b, out_scale, skip, cout):
    return xq.new_empty((*xq.shape[:3], cout), dtype=(
        torch.float32 if out_scale is None else torch.int8))


def conv_op(xq, w, a, b, out_scale, skip, cout: int):
    """Q1's op on weights as the device's implementation reads them (raw
    on the CPU, packed on the card), on planes made contiguous."""
    return int8_conv3x3_op(
        xq.contiguous(), w, a, b,
        None if out_scale is None else scale_tensor(out_scale, xq),
        None if skip is None else skip.contiguous(), cout)


def int8_conv3x3_packed(xq, packed: PackedInt8Conv, out_scale=None,
                        skip=None, tile: Optional[Q1Tile] = None):
    """Q1 on weights packed by :func:`pack_conv`: one launch. ``tile``: a
    tile at ``packed.shape`` (:func:`conv_tile`, the op's rule, by
    default)."""
    if tile is not None:
        return _launch(xq, packed, out_scale, skip, tile)
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    _check_fit(xq, skip, packed)
    return int8_conv3x3_op(
        xq, packed.wt, packed.a, packed.b,
        None if out_scale is None else scale_tensor(out_scale, xq), skip,
        packed.cout)


def int8_conv3x3(xq, wq, a, b, out_scale=None, skip=None):
    """One SAME 3×3 int8 conv with the fused epilogue (Q1).

    xq: (B, H, W, C1) int8; wq: (3, 3, C0 + C1, Cout) int8 (HWIO), the
    first C0 input channels those of ``skip`` (B, H, W, C0) when given; a,
    b: (Cout,) fp32; out_scale: the output's scale (int8 out) or None (fp32
    out). A CPU tensor takes :func:`int8_conv3x3_ref`, a CUDA tensor the
    kernel."""
    if xq.device.type == "cpu":
        return conv_op(xq, wq, a, b, out_scale, skip, wq.shape[-1])
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    c0 = None if skip is None else skip.shape[-1]
    return int8_conv3x3_packed(xq, pack_conv(wq, a, b, c0), out_scale, skip)
