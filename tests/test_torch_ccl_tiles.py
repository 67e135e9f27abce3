"""The index scheme of the CCL sweep kernel (``plumekit_torch/csrc/ccl_sweep.cu``)
emulated in plain Python, one thread at a time, against the port's plain
version: bit-packed 64 × 64 tiles, the opening by word operations, runs as
union-find nodes united once per stretch of touching pixels, tile edges
and roots written by the local pass, the border pass's seam pairs with
their skip rule, and the finalize pass's labels. The CUDA kernel runs only
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py); this holds
the arithmetic of its design to the contract on the CPU, on the shared
cases and on planes of several tiles. Labels are integers: compared bit
for bit."""

import os
import sys

import numpy as np
import pytest
import torch

from plumekit_torch.ops.kernels import ccl_sweep

sys.path.insert(0, os.path.dirname(__file__))
from torch_ccl_cases import CASES, MASK_CASES  # noqa: E402

WK, TH = 2, 64                  # words per tile row, tile height
TWP = 32 * WK                   # tile width in pixels
FULL = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(bits):
    """(rows, 32·k) bool → (rows, k) words as Python ints, bit b of word x
    = column 32x + b."""
    rows, cols = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return packed.view("<u4").reshape(rows, cols // 32).astype(object)


def _inside(r, cb, h, w):
    if r < 0 or r >= h or cb < 0 or cb >= w:
        return 0
    return FULL if w - cb >= 32 else (1 << (w - cb)) - 1


def opened_words(aod, thr, r0, c0):
    """``opened_words``: threshold the haloed tile (outside reads +inf),
    erode with carries (an arbitrary carry of 1 at the halo words' far
    ends, and noise in the halo bits the kernel does not vote), dilate,
    mask to the image."""
    h, w = aod.shape
    pad = np.full((h + 4 + TH, w + 64 + TWP), np.inf, np.float32)
    pad[2:h + 2, 32:w + 32] = aod
    win = pad[r0:r0 + TH + 4, c0:c0 + TWP + 64]
    with np.errstate(invalid="ignore"):
        m = _pack(win > thr)
    # the kernel votes only the two bits of each halo word next to the
    # tile: the others may hold anything
    noise = np.random.default_rng(r0 * 7 + c0).integers(0, FULL, (TH + 4, 2))
    for y in range(TH + 4):
        m[y, 0] = (m[y, 0] & 0xC0000000) | (int(noise[y, 0]) & 0x3FFFFFFF)
        m[y, -1] = (m[y, -1] & 0x3) | (int(noise[y, 1]) & 0xFFFFFFFC)
    mw = WK + 2
    e = np.zeros((TH + 2, mw), object)
    for y in range(TH + 2):
        my = y + 1
        for x in range(mw):
            c = m[my, x]
            lft = ((c << 1) & FULL) | (m[my, x - 1] >> 31 if x > 0 else 1)
            rgt = (c >> 1) | (((m[my, x + 1] << 31) & FULL) if x < mw - 1
                              else 0x80000000)
            e[y, x] = c & lft & rgt & m[my - 1, x] & m[my + 1, x] \
                & _inside(r0 - 1 + y, c0 + 32 * (x - 1), h, w)
    d = np.zeros((TH, WK), object)
    for y in range(TH):
        for x in range(WK):
            ey, ex = y + 1, x + 1
            c = e[ey, ex]
            lft = ((c << 1) & FULL) | (e[ey, ex - 1] >> 31)
            rgt = (c >> 1) | ((e[ey, ex + 1] << 31) & FULL)
            d[y, x] = (c | lft | rgt | e[ey - 1, ex] | e[ey + 1, ex]) \
                & _inside(r0 + y, c0 + 32 * x, h, w)
    return d


def mask_words(mask, r0, c0):
    h, w = mask.shape
    pad = np.zeros((h + TH, w + TWP), bool)
    pad[:h, :w] = mask
    return _pack(pad[r0:r0 + TH, c0:c0 + TWP])


def _bit(d, y, c):
    return (d[y, c >> 5] >> (c & 31)) & 1


def run_head(d, y, c):
    x = c >> 5
    z = ~d[y, x] & FULL & ((1 << (c & 31)) - 1)
    while z == 0 and x > 0:
        x -= 1
        z = ~d[y, x] & FULL
    return y * TWP + (x * 32 + z.bit_length() if z else 0)


def above(d, y, x, k):
    wd = d[y - 1, x]
    if k == 0:
        return wd
    if k > 0:
        return (wd >> 1) | (((d[y - 1, x + 1] << 31) & FULL)
                            if x + 1 < WK else 0)
    return ((wd << 1) & FULL) | (d[y - 1, x - 1] >> 31 if x > 0 else 0)


def heads_of(d, y, x):
    wd = d[y, x]
    return wd & ~(((wd << 1) & FULL) | (d[y, x - 1] >> 31 if x > 0 else 0)) \
        & FULL


def _bits(word):
    while word:
        yield (word & -word).bit_length() - 1
        word &= word - 1


def _find(par, a):
    while par[a] != a:
        a = par[a]
    return a


def label_tile(d, conn8):
    """``label_tile``: par[h] = the tile root of each run head h."""
    par = {}
    for y in range(TH):
        for x in range(WK):
            for b in _bits(heads_of(d, y, x)):
                par[y * TWP + x * 32 + b] = y * TWP + x * 32 + b
    for y in range(1, TH):
        for x in range(WK):
            for k in ((-1, 0, 1) if conn8 else (0,)):
                pairs = d[y, x] & above(d, y, x, k)
                carry = (d[y, x - 1] & above(d, y, x - 1, k)) >> 31 \
                    if x > 0 else 0
                for b in _bits(pairs & ~(((pairs << 1) & FULL) | carry)):
                    c = x * 32 + b
                    a, o = _find(par, run_head(d, y, c)), \
                        _find(par, run_head(d, y - 1, c + k))
                    par[max(a, o)] = min(a, o)
    return {h: _find(par, h) for h in par}


def _tiles(h, w):
    for r0 in range(0, h, TH):
        for c0 in range(0, w, TWP):
            yield r0, c0


def _edge():
    """A tile's first and last row and column, as (row, column) in it."""
    return [(0, c) for c in range(TWP)] + [(TH - 1, c) for c in range(TWP)] \
        + [(y, 0) for y in range(TH)] + [(y, TWP - 1) for y in range(TH)]


def _find_global(plane, a):
    while plane[a] - 1 != a:
        p = plane[a] - 1
        g = plane[p] - 1
        if g == p:
            return p
        plane[a] = min(plane[a], g + 1)     # path halving
        a = g
    return a


def _seam_pair(plane, p, q, shift):
    lp, lq = plane[p], plane[q]
    if lp == 0 or lq == 0:
        return 0
    if shift and plane[p - shift] == lp and plane[q - shift] == lq:
        return 0
    a, b = _find_global(plane, lp - 1), _find_global(plane, lq - 1)
    if a != b:
        plane[max(a, b)] = min(a, b) + 1
    return 1


def emulate(words_of, h, w, conn8):
    """The three passes on one level; ``words_of(r0, c0)`` gives a tile's
    foreground words. Returns the labels and the border pass's unions."""
    plane = np.full(h * w, -7, np.int64)        # torch.empty: anything
    tiles = {(r0, c0): label_tile(words_of(r0, c0), conn8)
             for r0, c0 in _tiles(h, w)}
    words = {key: words_of(*key) for key in tiles}
    for (r0, c0), par in tiles.items():          # pass 1
        d = words[(r0, c0)]
        for hd, root in par.items():
            if hd == root:
                g = (r0 + hd // TWP) * w + c0 + hd % TWP
                plane[g] = g + 1
        for y, c in _edge():
            if r0 + y >= h or c0 + c >= w:
                continue
            v = 0
            if _bit(d, y, c):
                root = par[run_head(d, y, c)]
                v = (r0 + root // TWP) * w + c0 + root % TWP + 1
            plane[(r0 + y) * w + c0 + c] = v
    unions = 0                                    # pass 2
    n_rows, n_cols = -(-h // TH), -(-w // TWP)
    for s in range(1, n_rows):
        r = s * TH
        for c in range(w):
            p = r * w + c
            for k in ((-1, 0, 1) if conn8 else (0,)):
                if 0 <= c + k < w:
                    unions += _seam_pair(plane, p, p - w + k,
                                         1 if c > 0 and c + k > 0 else 0)
    for s in range(1, n_cols):
        c = s * TWP
        for r in range(h):
            b = r * w + c
            a = b - 1
            unions += _seam_pair(plane, b, a, w if r >= 1 else 0)
            if conn8 and r >= 1:
                unions += _seam_pair(plane, b, a - w, w if r >= 2 else 0)
                unions += _seam_pair(plane, a, b - w, w if r >= 2 else 0)
    out = np.zeros(h * w, np.int64)               # pass 3
    for (r0, c0), par in tiles.items():
        d = words[(r0, c0)]
        final = {}
        for hd, root in par.items():
            if hd == root:
                g = (r0 + hd // TWP) * w + c0 + hd % TWP
                while plane[g] - 1 != g:
                    g = plane[g] - 1
                final[hd] = g + 1
        for y in range(min(TH, h - r0)):
            for c in range(min(TWP, w - c0)):
                if _bit(d, y, c):
                    out[(r0 + y) * w + c0 + c] = final[par[run_head(d, y, c)]]
    return out.reshape(h, w).astype(np.int32), unions


def emulate_sweep(field, ths, connectivity=2):
    return np.stack([emulate(lambda r0, c0, t=t: opened_words(field, t, r0,
                                                                c0),
                             *field.shape, connectivity == 2)[0]
                     for t in ths])


def emulate_masks(stack, connectivity=2):
    return np.stack([emulate(lambda r0, c0, m=m: mask_words(m, r0, c0),
                             *m.shape, connectivity == 2)[0] for m in stack])


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_scheme_sweep_equals_plain_version(case, connectivity):
    field, ths = CASES[case]()
    want = ccl_sweep.multi_threshold_ccl_ref(
        torch.from_numpy(field), torch.from_numpy(ths), connectivity).numpy()
    np.testing.assert_array_equal(emulate_sweep(field, ths, connectivity),
                                  want)


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_tile_scheme_masks_equals_plain_version(case, connectivity):
    stack, _ = MASK_CASES[case]()
    want = ccl_sweep.multi_threshold_ccl_masks_ref(
        torch.from_numpy(stack), connectivity).numpy()
    np.testing.assert_array_equal(emulate_masks(stack, connectivity), want)


@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 0.55), (2, 0.7)])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_tile_scheme_random_masks_across_many_tiles(seed, density,
                                                    connectivity):
    """Three tiles down, three across (the last ragged), at densities below,
    near and above percolation."""
    rng = np.random.default_rng(seed)
    stack = rng.random((1, 150, 170)) < density
    want = ccl_sweep.multi_threshold_ccl_masks_ref(
        torch.from_numpy(stack), connectivity).numpy()
    np.testing.assert_array_equal(emulate_masks(stack, connectivity), want)


def test_straight_contact_costs_one_union():
    """A full plane of 2 × 2 tiles: a straight contact along a seam costs
    one union per tile it borders, plus one after the tile root that sits
    on the seam (the root's entry changes when it is linked, so the next
    pair no longer matches it), not one per pixel (512 here)."""
    h = w = 2 * TH
    mask = np.ones((h, w), bool)
    out, unions = emulate(lambda r0, c0: mask_words(mask, r0, c0), h, w,
                          False)
    assert (out == 1).all()
    assert unions == 2 * (2 + 2)     # (row seam, column seam) x 2 tiles
