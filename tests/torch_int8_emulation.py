"""A plain numpy emulation of the int8 kernels, item by item as persistent
blocks walk them, by each kernel's own index scheme.

Q1, the 3×3 conv (``plumekit_torch/csrc/int8_conv.cu``): the items' decode,
the staged input chunk in shared memory (the padded raster of the patch or
the folded taps of the input conv), the weight chunk as packed on the host,
the K-major no-swizzle wgmma descriptors (a core matrix is 8 rows of 16
bytes; the leading byte offset steps between the two 16-byte halves of a
k32 row), the m64nNk32 s32 accumulator fragments of each thread, the
epilogue's int8 stash in shared memory and the 16-byte runs that leave it
(an fp32 output leaves from the fragments).

Q2, the transposed conv (``plumekit_torch/csrc/int8_upsample.cu``,
:func:`run_q2`): the items (k × n blocks of the low-resolution plane) and
the slices of columns as the blocks walk them, each chunk of the input as a
TMA box lands in its swizzled stage, the slice's weights as packed on the
host, the K-major swizzled wgmma descriptors, each consumer warpgroup's
fragments, the epilogue's writes into the swizzled output tile and the TMA store
boxes that leave it, clipped at the plane's edges.

Shared memory starts as random bytes, so a row the kernel computes and
drops may hold anything, as on the card. Used by
tests/test_torch_int8_conv.py and tests/test_torch_int8_upsample.py.
"""

import numpy as np

THREADS = 256
KC = 32


def desc_rows(buf, start, lbo, rows):
    """The rows × 32 int8 operand a K-major no-swizzle descriptor at byte
    ``start`` reads: row r, byte k at start + (r // 8)·128 + (r % 8)·16 +
    (k // 16)·lbo + k % 16 (core matrices of 8 rows of 16 bytes, 128 bytes
    from one 8-row group to the next)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    addr = start + (r // 8) * 128 + (r % 8) * 16 + (k // 16) * lbo + k % 16
    return buf[addr].view(np.int8).astype(np.int64)


def fragments(d, mt, nb):
    """The accumulators of each thread after m64n``nb``k32 wgmmas: thread
    t of warpgroup t >> 7 holds, for its m64 tile i (rows (wg + 2i)·64 on),
    d[4j + 2h + e] = D[row0 + 8h, 8j + col0 + e] with row0 = 16·warp +
    lane // 4 and col0 = 2·(lane % 4). Returns (threads, mt, nb / 2)."""
    t = np.arange(THREADS)
    wg, warp, lane = t >> 7, (t >> 5) & 3, t & 31
    row0, col0 = warp * 16 + (lane >> 2), 2 * (lane & 3)
    regs = np.zeros((THREADS, mt, nb // 2), np.int64)
    for i in range(mt):
        for j in range(nb // 8):
            for h in range(2):
                for e in range(2):
                    regs[:, i, 4 * j + 2 * h + e] = d[
                        (wg + 2 * i) * 64 + row0 + 8 * h, 8 * j + col0 + e]
    return regs


def epilogue(acc, a, b, relu, scale):
    """The epilogue's arithmetic, one rounding per step: float(acc)·a + b,
    ReLU, and with ``scale`` clamp(rint(y / scale), ±127) as int8."""
    y = acc.astype(np.float32) * np.float32(a)
    y = (y + np.float32(b)).astype(np.float32)
    if relu:
        y = np.maximum(y, np.float32(0))
    if scale is None:
        return y
    q = np.rint((y / np.float32(scale)).astype(np.float32))
    return np.clip(q, -127, 127).astype(np.int8)


def _lanes():
    t = np.arange(THREADS)
    wg, warp, lane = t >> 7, (t >> 5) & 3, t & 31
    return wg, warp * 16 + (lane >> 2), 2 * (lane & 3)


def stash(regs, mt, nb, a, b, relu, scale, pass_):
    """stash_tile: each thread's accumulators through the epilogue,
    quantized, into shared memory, row q at q·(nb + 16), column n at n."""
    sb = nb + 16
    out = np.zeros(128 * mt * sb, np.uint8)
    wg, row0, col0 = _lanes()
    for j in range(nb // 8):
        for e in range(2):
            n = 8 * j + col0 + e
            gn = pass_ * nb + n
            for i in range(mt):
                for h in range(2):
                    q = (wg + 2 * i) * 64 + row0 + 8 * h
                    v = epilogue(regs[:, i, 4 * j + 2 * h + e], a[gn], b[gn],
                                 relu, scale)
                    out[q * sb + n] = v.view(np.uint8)
    return out


def store_f32(blk, mode, regs, pass_, b0, ty0, tx0, out, written):
    """store_f32: each thread's column pair of a row, through the
    epilogue, straight to ``out`` (flat float32)."""
    wg, row0, col0 = _lanes()
    for i in range(blk.mt):
        for h in range(2):
            for t in range(THREADS):
                q = (wg[t] + 2 * i) * 64 + row0[t] + 8 * h
                pix = q1_pixel(blk, mode, q, b0, ty0, tx0)
                if pix < 0:
                    continue
                for j in range(blk.nb // 8):
                    for e in range(2):
                        n = pass_ * blk.nb + 8 * j + col0[t] + e
                        if n < blk.cout:
                            out[pix + n] = epilogue(
                                regs[t, i, 4 * j + 2 * h + e], blk.a[n],
                                blk.b[n], True, None)
                            written[pix + n] += 1


class Block:
    """One launch's arguments, as the C entry sets them."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def stage_raster(blk, b0, y0, x0, k0, rng):
    """load_a_raster: padded channels [k0, k0 + 32) of the (th + 2) ×
    (tw + 2) patch at (y0, x0) of images b0 .. into [group][pitch][16]."""
    buf = rng.integers(0, 256, 2 * blk.pitch * 16, dtype=np.uint8)
    second = k0 >= blk.c0p
    plane = blk.x1 if second else blk.x0
    c = blk.c1 if second else blk.c0
    kb = k0 - blk.c0p if second else k0
    ph, pw = blk.th + 2, blk.tw + 2
    for pix in range(blk.g * ph * pw):
        img, rem = divmod(pix, ph * pw)
        r, col = divmod(rem, pw)
        b, gy, gx = b0 + img, y0 + r, x0 + col
        for part in range(2):
            ch = kb + 16 * part
            vals = np.zeros(16, np.uint8)
            if (b < blk.B and 0 <= gy < blk.H and 0 <= gx < blk.W
                    and ch < c):
                got = plane[b, gy, gx, ch:min(ch + 16, c)].view(np.uint8)
                vals[:len(got)] = got
            d = (part * blk.pitch + pix) * 16
            buf[d:d + 16] = vals
    return buf


def stage_fold(blk, b0, y0, x0, rng):
    """load_raw_fold then build_fold: the (th + 2) raw rows of the patch
    at (y0, x0) fetched as 4-byte words from the word holding each row's
    first byte (zero past the plane), then row q, pixel q of the tile, as
    the bytes tap·C + c of its neighbourhood read from the raw rows."""
    rows = 128 * blk.mt
    c = blk.c0
    ph = blk.th + 2
    rs = -(-((blk.tw + 2) * c + 3) // 4) * 4
    flat = blk.x0.reshape(-1).view(np.uint8)
    raw = rng.integers(0, 256, blk.g * ph * rs, dtype=np.uint8)
    for row in range(blk.g * ph):
        img, r = divmod(row, ph)
        b, gy = b0 + img, y0 + r
        if b >= blk.B or not 0 <= gy < blk.H:
            continue
        start = ((b * blk.H + gy) * blk.W + x0) * c
        for w in range(rs // 4):
            at = (start & ~3) + 4 * w
            word = np.zeros(4, np.uint8)
            if at >= 0:
                got = flat[at:at + 4]
                word[:len(got)] = got
            raw[row * rs + 4 * w:row * rs + 4 * w + 4] = word
    buf = rng.integers(0, 256, 2 * blk.pitch * 16, dtype=np.uint8)
    for q in range(rows):
        img, rem = divmod(q, blk.th * blk.tw)
        r, col = divmod(rem, blk.tw)
        b = b0 + img
        row = np.zeros(32, np.uint8)
        if (img < blk.g and b < blk.B and y0 + 1 + r < blk.H
                and x0 + 1 + col < blk.W):
            for tap in range(9):
                y, x = r + tap // 3, col + tap % 3
                gy, gx = y0 + y, x0 + x
                if not (0 <= gy < blk.H and 0 <= gx < blk.W):
                    continue
                start = ((b * blk.H + gy) * blk.W + x0) * c
                p = (img * ph + y) * rs + (start & 3) + x * c
                row[tap * c:tap * c + c] = raw[p:p + c]
        buf[q * 16:q * 16 + 16] = row[:16]
        buf[(blk.pitch + q) * 16:(blk.pitch + q) * 16 + 16] = row[16:]
    return buf


def run_block(blk, mode, pass_, b0, ty0, tx0, rng):
    """One block's D (rows × nb) by its wgmmas over the staged chunks."""
    taps = 9 if mode == "raster" else 1
    rows = 128 * blk.mt
    nb = blk.nb
    w_bytes = taps * nb * 32
    wt = blk.wt.reshape(-1).view(np.uint8)
    d = np.zeros((rows, nb), np.int64)
    for kc in range(blk.n_k):
        if mode == "raster":
            abuf = stage_raster(blk, b0, ty0 - 1, tx0 - 1, kc * KC, rng)
        else:
            abuf = stage_fold(blk, b0, ty0 - 1, tx0 - 1, rng)
        w0 = (pass_ * blk.n_k + kc) * w_bytes
        wbuf = wt[w0:w0 + w_bytes]
        for tap in range(taps):
            shift = (tap // 3) * (blk.tw + 2) + tap % 3 if taps == 9 else 0
            bmat = desc_rows(wbuf, tap * nb * 32, nb * 16, nb)
            for wg in range(2):
                for i in range(blk.mt):
                    r0 = (wg + 2 * i) * 64
                    amat = desc_rows(abuf, (r0 + shift) * 16,
                                     blk.pitch * 16, 64)
                    d[r0:r0 + 64] += amat @ bmat.T
    return d


def q1_pixel(blk, mode, q, b0, ty0, tx0):
    rw = blk.tw + 2 if mode == "raster" else blk.tw
    per = (blk.th + 2 if mode == "raster" else blk.th) * rw
    img, rem = divmod(q, per)
    r, c = divmod(rem, rw)
    b, gy, gx = b0 + img, ty0 + r, tx0 + c
    if (img >= blk.g or r >= blk.th or c >= blk.tw or b >= blk.B
            or gy >= blk.H or gx >= blk.W):
        return -1
    return ((b * blk.H + gy) * blk.W + gx) * blk.cout


def store(blk, mode, st, pass_, b0, ty0, tx0, out, written):
    """store_tile: 16-byte runs of the int8 stash to ``out`` (flat);
    ``written`` counts each output's writes."""
    upr = blk.nb // 16
    sb = blk.nb + 16
    runs = blk.cout % 16 == 0
    for u in range(128 * blk.mt * upr):
        q, part = divmod(u, upr)
        n = pass_ * blk.nb + part * 16
        src = st[q * sb + part * 16:q * sb + part * 16 + 16]
        if n >= blk.cout:
            continue
        pix = q1_pixel(blk, mode, q, b0, ty0, tx0)
        if pix < 0:
            continue
        count = 16 if runs else min(16, blk.cout - n)
        out[pix + n:pix + n + count] = src[:count]
        written[pix + n:pix + n + count] += 1


def decode(blk, mode, item):
    """An item's (pass, b0, ty0, tx0), as the kernel decodes it: the pass
    fastest, then the tile column, the tile row and the image group."""
    pass_, t = item % blk.n_pass, item // blk.n_pass
    tiles_x, tiles_y = -(-blk.W // blk.tw), -(-blk.H // blk.th)
    tx, t = t % tiles_x, t // tiles_x
    ty, grp = t % tiles_y, t // tiles_y
    return pass_, grp * blk.g, ty * blk.th, tx * blk.tw


def run_grid(blk, mode, out_shape, out_dtype, blocks=3, seed=0):
    """Every item of the launch, as ``blocks`` persistent blocks walk them
    (block b takes items b, b + blocks, ...): the output as the kernel
    leaves it, and how often each output was written."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(np.prod(out_shape)), out_dtype)
    written = np.zeros(out.shape, np.int32)
    n_items = -(-blk.B // blk.g) * -(-blk.H // blk.th) \
        * -(-blk.W // blk.tw) * blk.n_pass
    for block in range(blocks):
        for item in range(block, n_items, blocks):
            pass_, b0, ty0, tx0 = decode(blk, mode, item)
            d = run_block(blk, mode, pass_, b0, ty0, tx0, rng)
            regs = fragments(d, blk.mt, blk.nb)
            if blk.scale is None:
                store_f32(blk, mode, regs, pass_, b0, ty0, tx0, out, written)
            else:
                st = stash(regs, blk.mt, blk.nb, blk.a, blk.b, True,
                           blk.scale, pass_)
                store(blk, mode, st, pass_, b0, ty0, tx0,
                      out.view(np.uint8), written)
    return out.reshape(out_shape), written.reshape(out_shape)


# ------------------------------------------------------------------ Q2

def swz(off, width):
    """The kernel's swizzle of byte offsets ``off`` (from a 1024-byte
    boundary) in a tile of ``width``-byte rows: the 16-byte chunk XOR bits
    7.. of the offset."""
    return off ^ (((off >> 7) & (width // 16 - 1)) << 4)


def desc_rows_sw(buf, start, width, rows):
    """The rows × 32 int8 operand a K-major ``width``-byte-swizzled
    descriptor at byte ``start`` reads (8-row groups ``8·width`` apart):
    row r, byte k at swz(start + r·width + k)."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return buf[swz(start + r * width + k, width)].view(np.int8) \
        .astype(np.int64)


def wg_fragments(d, mt, nb):
    """The accumulators of each thread of one consumer warpgroup after its
    m64n``nb``k32 wgmmas: thread t holds, for its m64 tile i (rows i·64
    on), d[4j + 2h + e] = D[64i + row0 + 8h, 8j + col0 + e] with row0 =
    16·(t >> 5) + (t % 32) // 4 and col0 = 2·(t % 4). Returns (128, mt,
    nb / 2)."""
    t = np.arange(128)
    row0, col0 = (t >> 5) * 16 + ((t & 31) >> 2), 2 * (t & 3)
    regs = np.zeros((128, mt, nb // 2), np.int64)
    for i in range(mt):
        for j in range(nb // 8):
            for h in range(2):
                for e in range(2):
                    regs[:, i, 4 * j + 2 * h + e] = d[
                        64 * i + row0 + 8 * h, 8 * j + col0 + e]
    return regs


def stage_box(x, r0, j0, c, n, k, kb, rm, rng):
    """A chunk of an item as TMA lands it: box (kb, n, k) of the (Cin, w,
    R) plane at (c·kb, j0, r0), line q = pixel (r0 + q // n, j0 + q % n),
    zero outside the plane and past Cin, each line's kb bytes swizzled;
    the stage's lines past n·k keep what they held."""
    rows, w, cin = x.shape
    buf = rng.integers(0, 256, rm * kb, dtype=np.uint8)
    for q in range(n * k):
        r, j = r0 + q // n, j0 + q % n
        line = np.zeros(kb, np.uint8)
        if r < rows and j < w:
            got = x[r, j, c * kb:min((c + 1) * kb, cin)].view(np.uint8)
            line[:len(got)] = got
        buf[swz(q * kb + np.arange(kb), kb)] = line
    return buf


def run_q2(x, wt, a, b, scale, cout, nb, mt, slices, n, k, blocks=2,
           seed=0):
    """Q2's output as the kernel leaves it, and how often each output byte
    was written. ``x`` (B, h, w, Cin) int8; ``wt`` the packed weights
    (slices, n_k, passes, nb, kb); ``a``, ``b`` per packed column; ``n``,
    ``k`` the item of ``mt`` m64 tiles; ``blocks`` groups of ``slices`` persistent blocks
    (block g·slices + s takes slice s of items g, g + blocks, ...), each
    with its consumer warpgroups taking its items in turn."""
    bsz, h, w, cin = x.shape
    _, n_k, passes, _, kb = wt.shape
    rm = 64 * mt
    s_cols = passes * nb
    cb = 32 if 2 * cout <= 32 else 64 if 2 * cout <= 64 else 128
    n_cc = -(-2 * cout // cb)
    rows = bsz * h
    plane = x.reshape(rows, w, cin)
    rng = np.random.default_rng(seed)
    out = np.zeros(bsz * 2 * h * 2 * w * cout, np.uint8)
    written = np.zeros(out.shape, np.int32)
    col_blocks = -(-w // n)
    items = -(-rows // k) * col_blocks
    t = np.arange(128)
    row0, col0 = (t >> 5) * 16 + ((t & 31) >> 2), 2 * (t & 3)
    for blk in range(blocks * slices):
        sl, first = blk % slices, blk // slices
        wsm = wt[sl].reshape(-1).view(np.uint8)
        for item in range(first, items, blocks):
            r0, j0 = (item // col_blocks) * k, (item % col_blocks) * n
            stages = [stage_box(plane, r0, j0, c, n, k, kb, rm, rng)
                      for c in range(n_k)]
            for pp in range(passes):
                d = np.zeros((rm, nb), np.int64)
                for c in range(n_k):
                    for s in range(kb // 32):
                        bmat = desc_rows_sw(
                            wsm, (c * s_cols + pp * nb) * kb + 32 * s, kb,
                            nb)
                        for i in range(mt):
                            amat = desc_rows_sw(stages[c],
                                                i * 64 * kb + 32 * s, kb, 64)
                            d[64 * i:64 * i + 64] += amat @ bmat.T
                regs = wg_fragments(d, mt, nb)
                # the epilogue into the output tile: chunk n // cb of the
                # pass, line q at q·cb, swizzled
                tile = rng.integers(0, 256, rm * nb, dtype=np.uint8)
                for j in range(nb // 8):
                    for e in range(2):
                        col = 8 * j + col0 + e
                        gn = sl * s_cols + pp * nb + col
                        for i in range(mt):
                            for hh in range(2):
                                q = 64 * i + row0 + 8 * hh
                                v = epilogue(regs[:, i, 4 * j + 2 * hh + e],
                                             a[gn], b[gn], False, scale)
                                tile[(col // cb) * rm * cb
                                     + swz(q * cb + col % cb, cb)] = \
                                    v.view(np.uint8)
                # the item's store boxes (cb, n, 1, k), one a chunk of the
                # pass, clipped at the plane's edges
                sub0 = (sl * s_cols + pp * nb) // cb
                for st in range(nb // cb):
                    di, cc = divmod(sub0 + st, n_cc)
                    for q in range(n * k):
                        r, jj = r0 + q // n, j0 + q % n
                        if r >= rows or jj >= w:
                            continue
                        byte = np.arange(cb)
                        keep = cc * cb + byte < 2 * cout
                        dst = (((2 * r + di) * w + jj) * 2 * cout + cc * cb
                               + byte[keep])
                        out[dst] = tile[st * rm * cb
                                        + swz(q * cb + byte[keep], cb)]
                        written[dst] += 1
    shape = (bsz, 2 * h, 2 * w, cout)
    return out.view(np.int8).reshape(shape), written.reshape(shape)
