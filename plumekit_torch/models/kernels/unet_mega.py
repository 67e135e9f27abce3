"""The whole U-Net inference forward as one kernel launch (K7).

Replaces the Pallas TPU megakernel ``mega_forward`` of
``plumekit/models/pallas/unet_mega.py`` (:364): every level of the batch-norm
U-Net (double convs, 2×2 max pools, 2×2 stride-2 transposed convs with bias,
concat-free skip joins, the 1×1 fp32 head) in one launch. The CUDA kernel is
``plumekit_torch/csrc/unet_mega.cu``, a persistent cooperative kernel with one
stage per double conv and a grid-wide barrier between stages; its source note
gives the design. Weights stream from L2 and the activation pyramid lives in
one device-memory scratch buffer per forward (planes whose readers are done
give their room to later ones); nothing between the stages is computed by a
PyTorch operator.

Numerics, mirrored exactly by the plain version :func:`mega_forward_ref`:
activations in the compute dtype, fp32 accumulation; every conv's result is
scaled, shifted and ReLU'd in fp32 and then rounded to the compute dtype,
except the last decoder block's, which stays fp32 into the fp32 head (the
per-block fused forward rounds it first); folded scales and shifts are
rounded to the compute dtype before use; the transposed conv rounds each
tap's product to the compute dtype and adds the bias in that dtype.

``compute_dtype="bfloat16"`` runs the kernel's tensor-core body;
``"float32"`` its fp32 body (FFMA on the CUDA cores, no rounding at all),
one launch as well, as the JAX megakernel admits both. A CPU tensor takes
the plain version; any other device launches the kernel or raises.

The forward is the ``torch.library`` custom op ``plumekit::unet_mega``, so
that ``torch.export`` and graph tools see it: its CPU implementation is the
plain version on the folded weights (:func:`folded_list`), its CUDA one the
kernel's launch on the packed blob, whose stage table comes as ints
(:func:`stage_ints`: it depends on the architecture only, not on the
weights' values), its fake one the logits' shape. The plan for a batch is
computed from the stage table and the shapes, and the activation scratch
comes from PyTorch's caching allocator on each call: nothing is keyed on a
tensor's address.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import Tensor

from plumekit_torch.cuda_build import LAUNCH_LOCK
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
_PLAN_FIELDS = 34    # kPlanFields of csrc/unet_mega.cu
_UP_ROW = conv_tiles.PASS_N + 8   # kUpRow: bf16 per staged upsample row
_F32_FIELDS = 24     # kF32Fields: the fp32 body's plan
F32_GROUP = 8        # kF32Group: output channels per thread of the fp32 body
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
    refused; its device-memory scratch (about 7.5 bytes per input pixel and
    base feature at depth 4 in bf16: 290 MB for 128 tiles of 96² at base 32,
    twice that in fp32) comes from the caching allocator on each forward,
    and a batch that does not fit raises torch's out-of-memory error."""
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

    @functools.cached_property
    def ints(self) -> Tuple[int, ...]:
        """:attr:`stages` as the op takes them (:func:`stage_ints`)."""
        return stage_ints(self.stages)


def folded_list(folded: dict) -> List[torch.Tensor]:
    """:func:`fold_weights`' output as one list: per block w1, s1, b1, w2,
    s2, b2; per transposed conv w, b; the head's weight and bias."""
    flat = [blk[k] for blk in folded["blocks"]
            for k in ("w1", "s1", "b1", "w2", "s2", "b2")]
    flat += [up[k] for up in folded["ups"] for k in ("w", "b")]
    return flat + [folded["head_w"], folded["head_b"]]


def folded_of(flat: List[torch.Tensor]) -> dict:
    """The inverse of :func:`folded_list` (depth d: 14·d + 8 tensors)."""
    depth = (len(flat) - 8) // 14
    n = 6 * (2 * depth + 1)
    blocks = [dict(zip(("w1", "s1", "b1", "w2", "s2", "b2"), flat[i:i + 6]))
              for i in range(0, n, 6)]
    ups = [{"w": flat[n + 2 * u], "b": flat[n + 2 * u + 1]}
           for u in range(depth)]
    return {"blocks": blocks, "ups": ups, "head_w": flat[-2],
            "head_b": flat[-1]}


#: the fields of a packed stage (:func:`_pack`, :func:`_pack_f32`), in the
#: order of :func:`stage_ints`; a field a stage lacks is 0
_STAGE_KEYS = ("kind", "path", "cin", "cmid", "cmid_p", "cout", "cout_p",
               "c0", "c0p", "c1", "cin_p", "w1t", "w1", "s1", "b1", "w2t",
               "w2", "s2", "b2", "up_cout", "up_cout_p", "up_kp", "upw",
               "upb", "n_out", "head_w", "head_b")
_PATHS = ("mma", "wgmma")


def stage_ints(stages: List[dict]) -> Tuple[int, ...]:
    """The stage table as a flat tuple of ints, ``len(_STAGE_KEYS)`` per
    stage (the path by its index in ``_PATHS``)."""
    return tuple(
        _PATHS.index(st["path"]) if k == "path" and k in st
        else int(st.get(k, 0)) for st in stages for k in _STAGE_KEYS)


@functools.lru_cache(maxsize=16)
def stages_of(ints: Tuple[int, ...]) -> List[dict]:
    """The inverse of :func:`stage_ints`."""
    n = len(_STAGE_KEYS)
    stages = []
    for i in range(0, len(ints), n):
        st = dict(zip(_STAGE_KEYS, ints[i:i + n]))
        st["path"] = _PATHS[st["path"]]
        stages.append(st)
    return stages


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
    blob = _Blob()
    add = blob.add
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
    return blob.tensor(device), stages


class _Blob:
    """Tensors laid end to end as bytes, each at an ``_ALIGN``-byte
    offset."""

    def __init__(self):
        self.pieces: List[torch.Tensor] = []
        self.size = 0

    def add(self, t: torch.Tensor) -> int:
        raw = t.contiguous().view(torch.uint8).reshape(-1)
        offset = self.size
        pad = round_up(raw.numel(), _ALIGN) - raw.numel()
        self.pieces.append(torch.nn.functional.pad(raw, (0, pad)))
        self.size += raw.numel() + pad
        return offset

    def tensor(self, device) -> torch.Tensor:
        return torch.cat(self.pieces).to(device)


def _pack_f32(folded: dict, device) -> Tuple[torch.Tensor, List[dict]]:
    """Lay the folded fp32 weights out for the kernel's fp32 body: per conv
    the (9, Cin, Cn8) weight (Cn8: the output channels rounded up to
    ``F32_GROUP``, zero padded; a decoder's Cin is the skip's channels,
    then the upsampled ones), its scale and shift (Cn8,); per upsampling
    stage the transposed conv as (Cout, 4, Cup8), column ``2·dy + dx``, and
    its bias (Cup8,); the head (Cout, 8) and its bias (8,)."""
    blocks, ups = folded["blocks"], folded["ups"]
    depth = len(ups)
    blob = _Blob()
    pad = torch.nn.functional.pad

    def conv(w, n):
        taps = w.reshape(9, w.shape[2], w.shape[3]).float()
        return blob.add(pad(taps, (0, round_up(n, F32_GROUP) - n)))

    def vec(v, n):
        return blob.add(pad(v.float(), (0, round_up(n, F32_GROUP) - n)))

    stages = []
    for i, blk in enumerate(blocks):
        cin, cmid = blk["w1"].shape[2:]
        cout = blk["w2"].shape[3]
        c0, c1 = (cin, 0) if i <= depth else (cin // 2, cin // 2)
        st = {"cin": cin, "cmid": cmid, "cout": cout, "c0": c0, "c1": c1,
              "w1": conv(blk["w1"], cmid), "s1": vec(blk["s1"], cmid),
              "b1": vec(blk["b1"], cmid), "w2": conv(blk["w2"], cout),
              "s2": vec(blk["s2"], cout), "b2": vec(blk["b2"], cout)}
        if i < depth:
            st["kind"] = _POOL
        elif i < 2 * depth:
            up = ups[i - depth]
            cup = up["w"].shape[1]
            k = up["w"].float().permute(0, 2, 3, 1).reshape(cout, 4, cup)
            st.update(kind=_UP, up_cout=cup,
                      upw=blob.add(pad(k, (0, round_up(cup, F32_GROUP) - cup))),
                      upb=vec(up["b"], cup))
        else:
            hw = folded["head_w"]
            n_out = hw.shape[1]
            st.update(kind=_HEAD, n_out=n_out,
                      head_w=blob.add(pad(hw.float(), (0, _HEAD_OUT - n_out))),
                      head_b=blob.add(pad(folded["head_b"].float(),
                                          (0, _HEAD_OUT - n_out))))
        stages.append(st)
    return blob.tensor(device), stages


def _chain(stages: List[dict], b: int, h: int, w: int, f32: bool):
    """The planes of a (b, h, w) batch: per stage the keys of the planes it
    reads (src0, src1) and writes (out, aux; fp32: mid, one plane every
    stage's first conv takes), and per key [elements, the stage that writes
    it, the last stage that reads it]. An encoder block's ``out`` is its
    level's skip (read again by the decoder block of its level), ``aux``
    the pooled plane the next block reads; an upsampling block's ``out`` is
    read by its own upsample, ``aux`` the upsampled plane."""
    depth = (len(stages) - 1) // 2
    last = len(stages) - 1
    planes: Dict[tuple, list] = {}
    rows = []
    skips = {}
    feed = None                               # the plane the next block reads
    levels = [i if i <= depth else 2 * depth - i for i in range(len(stages))]
    if f32:
        planes["mid"] = [max(b * (h >> lv) * (w >> lv) * st["cmid"]
                             for lv, st in zip(levels, stages)), 0, last]
    for i, st in enumerate(stages):
        level = levels[i]
        px = b * (h >> level) * (w >> level)
        src0, src1 = (skips[level], feed) if i > depth else (feed, None)
        for key in (src0, src1):
            if key is not None:
                planes[key][2] = i
        out = aux = None
        if st["kind"] == _POOL:
            out = skips[level] = ("skip", level)
            planes[out] = [px * st["cout"], i, i]
            aux = feed = ("pooled", level + 1)
            planes[aux] = [px // 4 * st["cout"], i, i]
        elif st["kind"] == _UP or f32:
            out = ("out", i)
            planes[out] = [px * st["cout"], i, i]
            if st["kind"] == _UP:
                aux = feed = ("up", level - 1)
                planes[aux] = [4 * px * st["up_cout"], i, i]
        rows.append((src0, src1, out, aux))
    return rows, planes


def _place(planes: Dict[tuple, list], align: int, reuse: bool):
    """Offsets for the planes, each a multiple of ``align`` elements, and
    the scratch size. With ``reuse`` a plane may take the room of one whose
    last reader ran in an earlier stage than the one that writes it (the
    stages are apart by a grid-wide barrier); else every plane has its own
    room."""
    placed = []                                # (offset, size, first, last)
    offsets = {}
    for key, (elems, first, last) in sorted(
            planes.items(), key=lambda kv: (kv[1][1], -kv[1][0])):
        n = round_up(elems, align)
        busy = sorted((o, m) for o, m, f, l in placed
                      if not reuse or not (l < first or last < f))
        off = 0
        for o, m in busy:
            if off + n <= o:
                break
            off = max(off, o + m)
        offsets[key] = off
        placed.append((off, n, first, last))
    return offsets, max((o + m for o, m, _f, _l in placed), default=0)


def _plan_f32(stages: List[dict], b: int, h: int, w: int,
              reuse: bool = True):
    """The fp32 body's stage table for a (b, h, w) batch as a (stages,
    _F32_FIELDS) int64 array, and the scratch size in floats. Fields: kind,
    H, W, src0, c0, src1, c1, Cmid, Cout, w1, s1, b1, w2, s2, b2, mid, out,
    aux, upw, upb, up_cout, head_w, head_b, n_out. Plane offsets in floats
    (-1: the network input, or no plane), weight offsets in bytes. The
    head stage's ``out`` is its fp32 result, which the head reads."""
    depth = (len(stages) - 1) // 2
    rows, planes = _chain(stages, b, h, w, f32=True)
    offsets, size = _place(planes, _ALIGN // 4, reuse)

    def at(key):
        return -1 if key is None else offsets[key]

    plan = np.zeros((len(stages), _F32_FIELDS), np.int64)
    for i, (st, (src0, src1, out, aux)) in enumerate(zip(stages, rows)):
        level = i if i <= depth else 2 * depth - i
        plan[i] = [
            st["kind"], h >> level, w >> level, at(src0), st["c0"], at(src1),
            st["c1"], st["cmid"], st["cout"], st["w1"], st["s1"], st["b1"],
            st["w2"], st["s2"], st["b2"], offsets["mid"], at(out), at(aux),
            st.get("upw", 0), st.get("upb", 0), st.get("up_cout", 0),
            st.get("head_w", 0), st.get("head_b", 0), st.get("n_out", 0)]
    return plan, size


def stage_tile(st: dict, h: int, w: int) -> conv_tiles.Tile:
    """The tile of one stage over its (h, w) plane: the fused double conv's
    rule; a stage that pools its own tiles starts them at even pixels."""
    return conv_tiles.double_conv_tile(
        h, w, st["cin"], st["cmid"], st["cout"], even=st["kind"] == _POOL,
        head=st["kind"] == _HEAD)


def up_rows_smem(st: dict, tile: conv_tiles.Tile) -> int:
    """Shared memory of a stage's upsample when its A operand lies in
    shared memory (``up_rows_smem`` of the kernel): the barriers and the
    weight ring, on the mma.sync path the ring tile before the kept tile,
    the tile's input channels, one staged pass of 128 columns."""
    rows = tile.images * tile.th * tile.tw
    pitch = conv_tiles.round_up(max(rows, conv_tiles.round_up(rows, 64)),
                                8) + 2
    ring = 0
    if tile.path == "mma":
        ring = 2 * (conv_tiles.round_up(
            (conv_tiles.MMA_TILE + 2) ** 2, 16) * (st["cmid_p"] + 8))
    return (conv_tiles.BAR_BYTES + conv_tiles.STAGES * conv_tiles.STAGE_BYTES
            + ring + st["up_kp"] // 8 * pitch * 16 + rows * _UP_ROW * 2)


def stage_split(st: dict, tile: conv_tiles.Tile, items: int,
                blocks: int | None) -> int:
    """2 when each item of a stage goes to two blocks (each the whole first
    conv and half of the second conv's 128-channel passes, then half of the
    pool's channels or of the upsample's columns): a wgmma stage with fewer
    than half as many items as the grid has blocks, and two passes or more
    to share. All its half-items then run at once, in the grid's first
    round, which a split upsample needs: its halves wait for each other.
    ``blocks``: the grid's size (the card's SMs at one block per SM);
    None: no split."""
    if (blocks is None or tile.path != "wgmma" or st["kind"] == _HEAD
            or st["cout_p"] // conv_tiles.PASS_N < 2 or 2 * items > blocks):
        return 1
    if st["kind"] == _UP and (
            up_rows_smem(st, tile) > conv_tiles.SMEM_LIMIT
            or 4 * st["up_cout_p"] // conv_tiles.PASS_N < 2):
        return 1
    return 2


def _plan(stages: List[dict], b: int, h: int, w: int, reuse: bool = True,
          blocks: int | None = None):
    """The kernel's stage table for a (b, h, w) batch as a
    (stages, _PLAN_FIELDS) int64 array, and the scratch size in bf16
    elements. Fields: kind, H, W, src0, c0, c0p, src1, c1, Cin_p, Cmid_p,
    Cout, Cout_p, w1t, s1, b1, w2t, s2, b2, out, aux, upw, upb, up_cout,
    up_cout_p, head_w, head_b, n_out, path, th, tw, images, up_kp, split,
    flags. Plane offsets are in scratch elements (-1: the network input,
    or no plane), weight offsets in bytes of the blob. A block's ``out``
    plane is its result (the skip of an encoder level), ``aux`` the pooled
    or the upsampled plane that the next block reads (:func:`_chain`); with
    ``reuse`` a plane takes the room of planes whose readers are done
    (:func:`_place`). path, th, tw and images are :func:`stage_tile`'s
    choice for the stage's plane, split :func:`stage_split`'s for a grid
    of ``blocks``; a split upsampling stage has one int32 counter per item
    at ``flags``, which the kernel zeroes first."""
    depth = (len(stages) - 1) // 2
    rows, planes = _chain(stages, b, h, w, f32=False)
    tiles, splits = [], []
    for i, st in enumerate(stages):
        level = i if i <= depth else 2 * depth - i
        tile = stage_tile(st, h >> level, w >> level)
        items = (-(-b // tile.images) * -(-(h >> level) // tile.th)
                 * -(-(w >> level) // tile.tw))
        tiles.append(tile)
        splits.append(stage_split(st, tile, items, blocks))
        if splits[-1] == 2 and st["kind"] == _UP:
            # zeroed when the kernel starts: live from stage 0 on
            planes[("flags", i)] = [2 * items, 0, i]
    offsets, size = _place(planes, _ALIGN // 2, reuse)

    def at(key):
        return offsets.get(key, -1) if key is not None else -1

    plan = np.zeros((len(stages), _PLAN_FIELDS), np.int64)
    for i, (st, (src0, src1, out, aux)) in enumerate(zip(stages, rows)):
        level = i if i <= depth else 2 * depth - i
        tile = tiles[i]
        plan[i] = [
            st["kind"], h >> level, w >> level, at(src0), st["c0"], st["c0p"],
            at(src1), st["c1"], st["cin_p"], st["cmid_p"], st["cout"],
            st["cout_p"], st["w1t"], st["s1"], st["b1"], st["w2t"], st["s2"],
            st["b2"], at(out), at(aux), st.get("upw", 0), st.get("upb", 0),
            st.get("up_cout", 0), st.get("up_cout_p", 0),
            st.get("head_w", 0), st.get("head_b", 0), st.get("n_out", 0),
            tile.path_id, tile.th, tile.tw, tile.images, st.get("up_kp", 0),
            splits[i], at(("flags", i))]
    return plan, size


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def weights_of(model, dtype, device) -> MegaWeights:
    """The model's folded (and, on a card, packed) weights, cached on the
    model: not once per forward. ``cuda`` and ``cuda:<current>`` are one
    device here, so that both find the same weights."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = state_key(model, device) + (dtype,)
    cached = _CACHE.get(model)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            folded = fold_weights(model, dtype)
            weights = MegaWeights(folded)
            if device.type == "cuda":
                pack = _pack if dtype == torch.bfloat16 else _pack_f32
                weights.blob, weights.stages = pack(folded, device)
        cached = _CACHE[model] = (key, weights)
    return cached[1]


def _library():
    from plumekit_torch.cuda_build import load_entry

    lib = load_entry("unet_mega.cu", "pk_unet_mega",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p])
    if lib.pk_unet_mega_f32.argtypes is None:
        lib.pk_unet_mega_f32.argtypes = lib.pk_unet_mega.argtypes
        lib.pk_unet_mega_f32.restype = ctypes.c_int
    if lib.pk_unet_mega_stamps.argtypes is None:
        lib.pk_unet_mega_stamps.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        lib.pk_unet_mega_stamps.restype = ctypes.c_int
    return lib


def _check(weights: MegaWeights, x):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dtype = weights.folded["blocks"][0]["w1"].dtype
    if x.dtype != dtype or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous (B, h, w, C) {dtype} "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if weights.blob is None or weights.blob.device != x.device:
        raise ValueError("weights and input lie on different devices")
    if x.shape[3] != weights.stages[0]["c0"]:
        raise ValueError(f"input has {x.shape[3]} channels, the packed "
                         f"weights {weights.stages[0]['c0']}")


def mega_forward(weights: MegaWeights, x) -> torch.Tensor:
    """One launch of the kernel: x (B, h, w, Cin) in the weights' compute
    dtype (bf16, or fp32 for the fp32 body) on the card, weights packed for
    that card → fp32 logits (B, h, w, out)."""
    _check(weights, x)
    return unet_mega_op(x, [weights.blob], list(weights.ints),
                        weights.stages[-1]["n_out"])


def mega_forward_debug(weights: MegaWeights, x):
    """The forward with every plane in a room of its own (no plane reused)
    in a scratch buffer of its own: returns the logits, the scratch and the
    plan (one row per stage; plane offsets in scratch elements, field
    order of :func:`_plan` or :func:`_plan_f32`), so that each stage's
    input and output planes can be read back (:func:`stage_errors`)."""
    _check(weights, x)
    logits, _blocks, scratch, plan = _launch(weights.blob, weights.ints, x,
                                             None, None, whole=True)
    return logits, scratch, plan


# ------------------------------------------------------------- the op

@torch.library.custom_op("plumekit::unet_mega", mutates_args=(),
                         device_types="cpu")
def unet_mega_op(x: Tensor, weights: List[Tensor], stages: List[int],
                 n_out: int) -> Tensor:
    """K7 as an op: x (B, h, w, Cin) → fp32 logits (B, h, w, ``n_out``).
    CPU: :func:`mega_forward_ref` on ``weights`` = :func:`folded_list`
    (``stages`` unused); CUDA: one launch on ``weights`` = [the packed
    blob] and its stage table ``stages`` (:func:`stage_ints`)."""
    return mega_forward_ref(folded_of(weights), x)


@unet_mega_op.register_kernel("cuda")
def _unet_mega_cuda(x, weights, stages, n_out):
    if len(weights) != 1 or weights[0].dtype != torch.uint8:
        raise ValueError("the kernel takes one packed uint8 blob")
    table = stages_of(tuple(stages))
    if x.shape[3] != table[0]["c0"] or table[-1]["n_out"] != n_out:
        raise ValueError(f"input {tuple(x.shape)} and {n_out} outputs do not "
                         "fit the stage table")
    # the bf16 body's table pads every input (cin_p), the fp32 body's not
    dtype = torch.float32 if table[0]["cin_p"] == 0 else torch.bfloat16
    if x.dtype != dtype:
        raise ValueError(f"the blob was packed for {dtype} input, got "
                         f"{x.dtype}")
    if not x.is_contiguous() or x.dim() != 4:
        raise ValueError(f"the kernel takes a contiguous (B, h, w, C) tensor, "
                         f"got {tuple(x.shape)}")
    return _launch(weights[0], tuple(stages), x, None, None, whole=False)[0]


@unet_mega_op.register_fake
def _unet_mega_fake(x, weights, stages, n_out):
    return x.new_empty((*x.shape[:3], n_out), dtype=torch.float32)


def mega_tree(model, dtype, device):
    """``(tree, stage ints)`` of the whole-forward op on ``device``: the
    tree ``{"weights": [...]}`` holds :func:`folded_list` on the CPU and
    the packed blob on a card (:func:`weights_of`, once per model and
    device), the ints the blob's stage table (empty on the CPU)."""
    weights = weights_of(model, dtype, device)
    if torch.device(device).type == "cpu":
        return {"weights": folded_list(weights.folded)}, ()
    return {"weights": [weights.blob]}, weights.ints


def make_mega_tree_apply(cfg: UNetConfig, ints: Tuple[int, ...] = ()):
    """Returns ``apply(tree, x) -> logits``, the whole forward as one op on
    a :func:`mega_tree` whose stage ints are ``ints``; x is NHWC at a shape
    :func:`mega_eligible` takes."""
    from plumekit_torch.models.unet import DTYPES

    dtype = DTYPES[cfg.compute_dtype]

    def apply(tree, x):
        if not mega_eligible(cfg, x.shape[1], x.shape[2]) or \
                x.shape[3] != cfg.in_channels:
            raise ValueError(f"megakernel ineligible for input "
                             f"{tuple(x.shape)} / config (see mega_eligible)")
        return unet_mega_op(x.to(dtype).contiguous(), tree["weights"],
                            list(ints), cfg.out_channels)

    return apply


#: the per-stage gate: K6's, |got - ref| <= 2^-6 + 2^-6 |ref| (two bf16
#: steps: both round from fp32 sums taken in another order)
STAGE_ATOL = STAGE_RTOL = 2.0 ** -6


def stage_errors(weights: MegaWeights, x, logits, scratch, plan) -> list:
    """Each bf16 stage of a :func:`mega_forward_debug` run against the plain
    version of that stage alone, fed the kernel's own input planes for it,
    so that errors do not pile up from stage to stage: the double conv's
    output plane against :func:`double_conv_ref` (the head stage: the
    logits against the fp32 block times the head), the pooled plane
    against :func:`max_pool_ref` and the upsampled one against
    :func:`conv_transpose_ref` of the kernel's own output plane. Per stage
    the worst ``|got - ref| / (STAGE_ATOL + STAGE_RTOL |ref|)`` of each
    plane (at most 1 passes) and its largest ``|got - ref|``."""
    blocks, ups = weights.folded["blocks"], weights.folded["ups"]
    depth = len(ups)
    b = x.shape[0]

    def plane(off, h, w, c):
        return scratch[off:off + b * h * w * c].view(b, h, w, c)

    def worst(got, ref):
        err = (got.float() - ref.float()).abs()
        return {"ratio": float((err / (STAGE_ATOL + STAGE_RTOL
                                       * ref.float().abs())).max()),
                "max_abs": float(err.max())}

    rows = []
    for i, row in enumerate(plan):
        kind, h, w, src0, c0, src1, c1, cout, out, aux, cup = (
            int(row[j]) for j in (0, 1, 2, 3, 4, 6, 7, 10, 18, 19, 22))
        inp = x if src0 < 0 else plane(src0, h, w, c0)
        if src1 >= 0:
            inp = torch.cat([inp, plane(src1, h, w, c1)], dim=-1)
        ref = double_conv_ref(inp, blocks[i], out_f32=kind == _HEAD)
        entry = {"stage": i, "kind": ("pool", "up", "head")[kind], "h": h}
        if kind == _HEAD:
            entry["logits"] = worst(logits, ref.float() @ weights.folded[
                "head_w"] + weights.folded["head_b"])
        else:
            got = plane(out, h, w, cout)
            entry["out"] = worst(got, ref)
            entry["aux"] = worst(
                plane(aux, h // 2, w // 2, cout), max_pool_ref(got)) \
                if kind == _POOL else worst(
                    plane(aux, 2 * h, 2 * w, cup),
                    conv_transpose_ref(got, ups[i - depth]))
        rows.append(entry)
        del inp, ref
    return rows


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_stages(weights: MegaWeights, x, n_stages: int | None = None,
                  stamps: torch.Tensor | None = None):
    """Launch the kernel on the first ``n_stages`` stages (all by default)
    of a checked input; returns the logits (written only by the head stage)
    and, when ``stamps`` asks for per-block stamps (``pk_unet_mega_stamps``,
    bf16 only: uint64 (stages, blocks, 5) at most), the grid's block count,
    else None. The per-stage timing experiment calls it directly; the
    forwards go through :func:`unet_mega_op`."""
    logits, blocks, _scratch, _plan_rows = _launch(
        weights.blob, weights.ints, x, n_stages, stamps, whole=False)
    return logits, blocks


@functools.lru_cache(maxsize=64)
def _plan_of(ints: Tuple[int, ...], b: int, h: int, w: int, whole: bool,
             f32: bool, blocks: int):
    """(ctypes plan array, scratch elements, the plan as an array) of a
    (b, h, w) batch on the stage table ``ints``, by value."""
    stages = stages_of(ints)
    if f32:
        plan, elems = _plan_f32(stages, b, h, w, reuse=not whole)
    else:
        plan, elems = _plan(stages, b, h, w, reuse=not whole, blocks=blocks)
    return ((ctypes.c_longlong * plan.size)(*plan.ravel().tolist()), elems,
            plan)


def _launch(blob, ints, x, n_stages, stamps, whole: bool):
    """One launch of the kernel: every launch of it comes through here and
    adds one to :data:`LAUNCHES`. The scratch is a fresh buffer of the
    plan's size from the caching allocator."""
    b, h, w, _cin = x.shape
    f32 = x.dtype == torch.float32
    if stamps is not None and f32:
        raise ValueError("per-block stamps are for the bf16 kernel")
    plan_arr, elems, plan = _plan_of(tuple(ints), b, h, w, whole, f32,
                                     _sms(x.device.index or 0))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = torch.empty(elems, dtype=x.dtype, device=x.device)
    stages = stages_of(tuple(ints))
    n_out = stages[-1]["n_out"]
    logits = torch.empty((b, h, w, n_out), dtype=torch.float32,
                         device=x.device)
    lib = _library()
    n = len(stages) if n_stages is None else n_stages
    n_blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        if stamps is not None:
            err = lib.pk_unet_mega_stamps(
                x.data_ptr(), blob.data_ptr(), scratch.data_ptr(),
                logits.data_ptr(), ctypes.addressof(plan_arr), n, b,
                stamps.data_ptr(), ctypes.addressof(n_blocks), stream)
        else:
            entry = lib.pk_unet_mega_f32 if f32 else lib.pk_unet_mega
            err = entry(x.data_ptr(), blob.data_ptr(),
                        scratch.data_ptr(), logits.data_ptr(),
                        ctypes.addressof(plan_arr), n, b, stream)
    if err != 0:
        raise RuntimeError("whole-forward kernel launch failed: "
                           + lib.pk_error_string(err).decode())
    global LAUNCHES
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return (logits, n_blocks.value if stamps is not None else None, scratch,
            plan)


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
            return unet_mega_op(
                x, folded_list(weights_of(model, dtype, x.device).folded),
                [], cfg.out_channels)
        return mega_forward(weights_of(model, dtype, x.device),
                            x.to(dtype).contiguous())

    return apply
