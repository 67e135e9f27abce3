"""Host side of the conv tile code ``plumekit_torch/csrc/conv_tiles.cuh``: which
path a conv takes, the tile and the images per block, and the weight packing.

The single conv (K5), the fused double conv (K6) and the whole-forward kernel
(K7) all take their geometry from here and hand it to the C entry points, so
one rule serves the three and the CPU tests can hold it.

Two paths (the header's note gives the why). A conv of more than 64 output
channels (for a double conv: mid channels) takes the ``wgmma`` path: passes
of 128 output channels over up to 256 rows of the *padded raster* of the
staged input patch of ``images`` images, ``th × tw`` output pixels each. A
narrower one takes the ``mma`` path on fixed 16 × 16 tiles of one image.

The wgmma geometry, mirrored from ``WgGeom`` of the header: a conv's input
patch is ``ph × pw`` per image (the tile plus a 1-px halo per conv that
follows); raster row ``q = (img·ph + r)·pw + c`` holds the conv's output at
patch pixel ``(r + 1, c + 1)`` and reads rows ``q + dy·pw + dx``. Rows with
``c >= pw − 2`` or ``r >= ph − 2`` wrap and are dropped.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

#: shared memory one block may opt in to on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the constants of the wgmma path (kWg* of the header)
PASS_N = 128          # output channels per pass
CHUNK_K = 32          # input channels per staged chunk
STAGE_BYTES = PASS_N * CHUNK_K * 2
STAGES = 4
BAR_BYTES = 128
MAX_ROWS = 256
HEAD_STRIDE = 33
#: the mma path's tile and channel padding
MMA_TILE = 16
MMA_PAD = 32
#: above this many output (mid) channels a conv takes the wgmma path
MMA_MAX_CHANNELS = 64

# the cost model's rates, in clocks of one SM of an H100: an m64n128k16
# wgmma takes 64 clocks at the tensor cores' peak; L2 feeds one SM about 20
# bytes a clock when all 132 ask at once; a pass ends in an epilogue and a
# chunk of a staged operand in two block barriers
_WGMMA_CLK = 64
_L2_BYTES_PER_CLK = 20
_EPILOGUE_CLK = 1500
_CHUNK_CLK = 300
_ITEM_CLK = 3000


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def path_for(channels: int) -> str:
    """The path of a conv by its output channels (a double conv: by its mid
    channels, which are the first conv's output and the second's depth)."""
    return "wgmma" if channels > MMA_MAX_CHANNELS else "mma"


@dataclass(frozen=True)
class WgGeom:
    """Shapes of one wgmma item: ``ring`` = 1 for a double conv (the first
    conv also covers the 1-px ring of the tile), 0 for a single conv."""

    th: int
    tw: int
    images: int
    ring: int
    cmid_p: int = 0

    @property
    def ph(self) -> int:
        return self.th + 2 * self.ring + 2

    @property
    def pw(self) -> int:
        return self.tw + 2 * self.ring + 2

    @property
    def rh(self) -> int:
        return self.th + 2

    @property
    def rw(self) -> int:
        return self.tw + 2

    @property
    def m1(self) -> int:
        """Raster rows of the first (or only) conv."""
        return self.images * self.ph * self.pw - 2 * self.pw - 2

    @property
    def m2(self) -> int:
        """Raster rows of a double conv's second conv."""
        return self.images * self.rh * self.rw - 2 * self.rw - 2

    @property
    def a_pitch(self) -> int:
        reach = round_up(self.m1, 64) + 2 * self.pw + 2
        return round_up(max(self.images * self.ph * self.pw, reach), 8) + 2

    @property
    def ring_pixels(self) -> int:
        return self.images * self.rh * self.rw

    def smem_bytes(self, head: bool = False) -> int:
        inter = (self.cmid_p // 8) * self.ring_pixels * 16 if self.ring else 0
        tail = 2 * (CHUNK_K // 8) * self.a_pitch * 16
        tail = max(tail, (round_up(self.m2, 64) + 2 * self.rw + 2) * 16)
        if head:
            tail = max(tail, round_up(self.m2, 64) * HEAD_STRIDE * 4)
        return BAR_BYTES + STAGES * STAGE_BYTES + inter + tail

    def fits(self, head: bool = False) -> bool:
        return (self.m1 <= MAX_ROWS and self.m2 <= MAX_ROWS
                and self.smem_bytes(head) <= SMEM_LIMIT)


@dataclass(frozen=True)
class Tile:
    """What the rule returns and the C entry points take."""

    path: str          # "wgmma" or "mma"
    th: int
    tw: int
    images: int        # images per block
    smem: int          # bytes of shared memory per block
    fill: float        # plane pixels over the pixels of the tiles covering it

    @property
    def path_id(self) -> int:
        return 1 if self.path == "wgmma" else 0


def plane_fill(h: int, w: int, th: int, tw: int) -> float:
    return (h * w) / (round_up(h, th) * round_up(w, tw))


def fixed_tile_side(cmid: int) -> int:
    """The side of the fixed square tiles the rule took the place of:
    16 × 16 up to 128 (padded) mid channels, 8 × 8 above. The rule never
    fills a plane worse than they did."""
    return 16 if round_up(cmid, MMA_PAD) <= 128 else 8


def mma_double_conv_smem(cmid: int) -> int:
    """Shared memory of the mma path's double conv: the bf16 ring tile of a
    16 × 16 tile (21 m16 tiles of rows, Cmid_p + 8 wide) and two buffers
    each of the 20 × 20 input patch and of 32 × 9 weight rows, 40 wide."""
    cmid_p = round_up(cmid, MMA_PAD)
    rows = round_up((MMA_TILE + 2) ** 2, 16)
    return 2 * (rows * (cmid_p + 8) + 2 * (MMA_TILE + 4) ** 2 * 40
                + 2 * 32 * 9 * 40)


def _mma_tile(h: int, w: int, smem: int) -> Tile:
    return Tile("mma", MMA_TILE, MMA_TILE, 1, smem,
                plane_fill(h, w, MMA_TILE, MMA_TILE))


def _conv_clocks(rows: int, k_p: int, n_p: int, staged: bool) -> float:
    """Clocks of one conv of one item: per stage (one tap of one 32-channel
    chunk of one pass) the larger of its wgmmas and its 8 KB from L2."""
    stage = max(-(-rows // 64) * (CHUNK_K // 16) * _WGMMA_CLK,
                STAGE_BYTES / _L2_BYTES_PER_CLK)
    chunks = k_p // CHUNK_K
    return (n_p // PASS_N) * (chunks * (9 * stage + _CHUNK_CLK * staged)
                              + _EPILOGUE_CLK)


def _candidates(h: int, w: int, even: bool):
    step = 2 if even else 1
    for th in range(step, min(h, 64) + 1, step):
        for tw in range(step, min(w, 64) + 1, step):
            if (th + 2) * (tw + 2) - 2 * (tw + 2) - 2 > MAX_ROWS:
                break
            yield th, tw, 1
            if th == h and tw == w:
                for g in range(2, 9):
                    yield th, tw, g


@functools.lru_cache(maxsize=None)
def single_conv_tile(h: int, w: int, cin: int, cout: int) -> Tile:
    """The tile of one 3×3 conv (K5) over (h, w) planes."""
    if path_for(cout) == "mma":
        return _mma_tile(h, w, 2 * (2 * 18 * 18 * 40 + 2 * 32 * 9 * 40))
    cin_p, cout_p = round_up(cin, CHUNK_K), round_up(cout, PASS_N)
    floor = plane_fill(h, w, MMA_TILE, MMA_TILE)
    best = None
    for th, tw, g in _candidates(h, w, False):
        gm = WgGeom(th, tw, g, 0)
        fill = plane_fill(h, w, th, tw)
        if not gm.fits() or fill < floor - 1e-12:
            continue
        items = (round_up(h, th) // th) * (round_up(w, tw) // tw) / g
        cost = items * (_conv_clocks(gm.m1, cin_p, cout_p, True) + _ITEM_CLK)
        key = (cost, -fill, th + tw, th)
        if best is None or key < best[0]:
            best = (key, Tile("wgmma", th, tw, g, gm.smem_bytes(), fill))
    return best[1]


@functools.lru_cache(maxsize=None)
def double_conv_tile(h: int, w: int, cin: int, cmid: int, cout: int,
                     even: bool = False, head: bool = False) -> Tile:
    """The tile of one double conv (K6; a stage of K7) over (h, w) planes.
    ``even``: tiles start at even pixels (a stage of K7 that max-pools its
    own tile); ``head``: the stage that ends in K7's 1×1 head."""
    if path_for(cmid) == "mma":
        return _mma_tile(h, w, mma_double_conv_smem(cmid))
    cin_p = round_up(cin, CHUNK_K)
    cmid_p, cout_p = round_up(cmid, PASS_N), round_up(cout, PASS_N)
    side = fixed_tile_side(cmid)
    floor = plane_fill(h, w, side, side)
    best = None
    for th, tw, g in _candidates(h, w, even):
        gm = WgGeom(th, tw, g, 1, cmid_p)
        fill = plane_fill(h, w, th, tw)
        if not gm.fits(head) or fill < floor - 1e-12:
            continue
        items = (round_up(h, th) // th) * (round_up(w, tw) // tw) / g
        cost = items * (_conv_clocks(gm.m1, cin_p, cmid_p, True)
                        + _conv_clocks(gm.m2, cmid_p, cout_p, False)
                        + _ITEM_CLK)
        key = (cost, -fill, th + tw, th)
        if best is None or key < best[0]:
            best = (key, Tile("wgmma", th, tw, g, gm.smem_bytes(head), fill))
    if best is None:
        raise ValueError(f"no double-conv tile of {cmid} mid channels fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best[1]


# ------------------------------------------------------------------ packing

def pack_weight_mma(w, cin_p: int, cout_p: int):
    """HWIO (3, 3, Cin, Cout) → (Cout_p, 9, Cin_p) bf16, zero padded: the
    mma path's layout."""
    kh, kw, cin, cout = w.shape
    packed = w.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin)
    return F.pad(packed.to(torch.bfloat16),
                 (0, cin_p - cin, 0, 0, 0, cout_p - cout)).contiguous()


def pack_weight_stream(w, cin_p: int, cout_p: int):
    """(taps, Cin, Cout) or HWIO (3, 3, Cin, Cout) → the wgmma path's weight
    stream, bf16, zero padded: ``[pass][chunk][tap][group][n][8]`` with
    ``stream[p, c, t, g, n, e] = w[t, 32·c + 8·g + e, 128·p + n]``. A stage
    ``[p, c, t]`` (8 KB) is the B operand of one tap of one 32-channel chunk
    of one 128-channel pass as shared memory holds it: per 8-channel group
    128 rows of 16 bytes (the descriptor's no-swizzle K-major layout), so
    the kernel copies stage after stage, each with one bulk copy."""
    if w.dim() == 4:
        w = w.reshape(w.shape[0] * w.shape[1], w.shape[2], w.shape[3])
    taps, cin, cout = w.shape
    if cin_p % CHUNK_K or cout_p % PASS_N:
        raise ValueError("padded channels must be multiples of 32 and 128")
    w = F.pad(w.to(torch.bfloat16), (0, cout_p - cout, 0, cin_p - cin))
    w = w.reshape(taps, cin_p // CHUNK_K, CHUNK_K // 8, 8,
                  cout_p // PASS_N, PASS_N)
    return w.permute(4, 1, 0, 2, 5, 3).contiguous()


def pack_vector(v, n_p: int):
    return F.pad(v.to(torch.bfloat16), (0, n_p - v.shape[0])).contiguous()


def padded_channels(path: str, cin: int, cout: int) -> Tuple[int, int]:
    """(Cin_p, Cout_p) of one conv on ``path``."""
    return (round_up(cin, CHUNK_K),
            round_up(cout, PASS_N if path == "wgmma" else MMA_PAD))


def pack_conv(path: str, w, scale, shift):
    """One conv's (weight, scale, shift) packed for ``path``."""
    cin_p, cout_p = padded_channels(path, w.shape[2], w.shape[3])
    pack = pack_weight_stream if path == "wgmma" else pack_weight_mma
    return (pack(w, cin_p, cout_p), pack_vector(scale, cout_p),
            pack_vector(shift, cout_p))
