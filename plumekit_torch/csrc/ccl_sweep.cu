// Multi-threshold connected-component labelling: the K1 and K4 kernels of
// the identify sweep (the mask opening built in-kernel) and the K2 kernel
// that labels a stack of ready-made masks.
//
// Replaces the Pallas TPU kernels multi_threshold_ccl_fused
// (plumekit/ops/pallas/ccl_sweep.py:544), multi_threshold_ccl_banded
// (plumekit/ops/pallas/ccl_banded.py:321) and multi_threshold_ccl
// (plumekit/ops/pallas/ccl_sweep.py:468). The first two compute, for an
// (H, W) float32 AOD plane and T thresholds,
//
//   out[t] = 8- (or 4-) connected labels of binary_opening_cross(aod > th[t])
//
// and the third, for a (T, H, W) stack of one-byte masks,
//
//   out[t] = 8- (or 4-) connected labels of masks[t]
//
// with 0 for background and each component labelled by its smallest flat
// pixel id r * W + c, plus one. The TPU kernels keep the label plane in
// VMEM (K1) or stream it through HBM in bands (K4); here the label planes
// live in device memory at every scene size, so one kernel set serves both
// entry points, and all T levels are labelled in one call.
//
// Algorithm: union-find over runs of bit-packed tiles, in three passes.
// A block owns a 64 x 64 tile; a tile row is two 32-bit words, bit b of
// word x holding column 32x + b.
//   1. local:    K1's block loads the tile's AOD with a 2-pixel halo into
//                shared memory once (an outside pixel reads +inf) and then,
//                for each of its levels, takes each word of the threshold
//                mask by one warp vote and opens it with word operations:
//                erosion m & (m<<1 | carry) & (m>>1 | carry) & up & down,
//                where an outside pixel counts as foreground, then dilation
//                by the same terms with ORs over the eroded words, which
//                are 0 outside. K2's block votes its mask bytes into words
//                instead. A run (a stretch of set bits in a tile row) is one
//                union-find node, named by its head pixel; runs of adjacent
//                rows are united once per stretch of touching pixels and
//                neighbour offset (one offset for 4-connectivity, three for
//                8), in shared memory, atomicMin linking the larger root
//                under the smaller. So a tile root is the smallest pixel of
//                its piece. The pass writes only what the border pass reads:
//                each tile root's entry (its own id + 1) and the labels of
//                the tile's first and last row and column.
//   2. border:   one thread per pixel of a seam between tiles unites, in
//                the label plane, the tile roots of the pixel and of each
//                backward neighbour across the seam (a global union-find
//                whose find halves the path with atomicMin, so parents stay
//                smaller than ids and the labels stay canonical in any
//                order of the atomics). A pair is skipped when the pair one
//                step back along the seam has the same labels: that pair
//                joins the same pieces, so a straight contact costs one
//                union.
//   3. finalize: each block labels its tile again as in pass 1 (no plane
//                holds the runs between passes), resolves each tile root to
//                its global root once, and writes every pixel of the tile,
//                once, with 16-byte stores where the width allows.
// A global root is the smallest id of its tree, so the final label of a
// component is its smallest pixel id whatever order the atomics ran in:
// the output is the contract bit for bit. Pass 3's writes replace a tile
// root's parent by its global root, an ancestor, so a concurrent walk in
// another block still ends at the same root.
//
// What bounds it on an H100: the least time is the label stack's bytes, 4
// per pixel and level (5.4 GB at 8192^2, T = 20), which pass 3 writes once;
// the AOD is read twice per tile (passes 1 and 3) for all the block's
// levels, and passes 1 and 2 touch only tile edges and roots. The per-pixel
// work is word operations (a vote per 32 pixels), a few shared-memory
// unions per run and one shared-memory lookup per run of each output
// group: no union and no chain walk per pixel. What the tile passes wait
// on is latency (votes, unions and barriers, some 13 us per tile and level
// on an H100), so the tile's shared memory is kept to 37.5 KB (the AOD's
// halo is two columns, not a word) and its registers to 40, and six blocks
// share an SM. A block takes all levels where the tiles alone make enough
// rounds of resident blocks, else fewer (levels differ in cost), so that
// small scenes still fill the card's SMs and end in a short last round.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WK = 2;               // words per tile row
constexpr int TWP = 32 * WK;        // tile width in pixels
constexpr int TH = 64;              // tile height
constexpr int THREADS = 256;
constexpr int HALO = 2;             // the opening reads a radius-2 cross
constexpr int MR = TH + 2 * HALO;   // mask rows: tile rows -2 .. TH + 1
constexpr int MW = WK + 2;          // mask words: one halo word each side
constexpr int AW = TWP + 2 * HALO;  // AOD columns: tile columns -2 .. TWP + 1
constexpr int ER = TH + 2;          // eroded rows: tile rows -1 .. TH
constexpr int NPIX = TH * TWP;
constexpr unsigned FULL = 0xffffffffu;

struct TileLabels {                 // one level of one tile
    uint32_t d[TH][WK];             // foreground words
    int par[NPIX];                  // union-find over run heads (tile ids)
};

struct TileAod {                    // K1: the tile's AOD, then its masks
    float aod[MR][AW];
    uint32_t m[MR][MW];             // threshold mask
    uint32_t e[ER][MW];             // eroded mask
    TileLabels lab;
};

// -------------------------------------------------------------- masks
__device__ void load_aod(TileAod& s, const float* __restrict__ aod, int r0,
                         int c0, int H, int W) {
    for (int i = threadIdx.x; i < MR * AW; i += THREADS) {
        const int y = i / AW, x = i % AW;
        const int r = r0 - HALO + y, c = c0 - HALO + x;
        s.aod[y][x] = (r >= 0 && r < H && c >= 0 && c < W)
            ? __ldg(aod + (size_t)r * W + c) : INFINITY;
    }
}

// the bits of the word whose bit 0 is column cb, on image row r, that lie
// inside the image (cb is a multiple of 32)
__device__ __forceinline__ uint32_t inside_bits(int r, int cb, int H, int W) {
    if (r < 0 || r >= H || cb < 0 || cb >= W) return 0u;
    return W - cb >= 32 ? FULL : (1u << (W - cb)) - 1u;
}

// threshold (NaN is below every threshold; outside reads +inf, above it),
// then open: erosion with outside as foreground, dilation with outside as
// background, into lab.d
__device__ void opened_words(TileAod& s, float thr, int r0, int c0, int H,
                             int W) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < MR * MW; i += THREADS / 32) {
        const int y = i / MW, x = i % MW;
        // of a halo word only the two bits next to the tile are read: the
        // last two of the left one, the first two of the right one
        float v = 0.0f;
        if (x == 0) {
            if (lane >= 32 - HALO) v = s.aod[y][lane - (32 - HALO)];
        } else if (x == MW - 1) {
            if (lane < HALO) v = s.aod[y][HALO + TWP + lane];
        } else {
            v = s.aod[y][HALO + 32 * (x - 1) + lane];
        }
        const unsigned b = __ballot_sync(FULL, v > thr);
        if (lane == 0) s.m[y][x] = b;
    }
    __syncthreads();
    // e[y][x] is tile row y - 1, as is m[y + 1][x]. Of the halo words only
    // bit 31 of the first and bit 0 of the last are read below, and those
    // need only the two bits of m next to the tile
    for (int i = threadIdx.x; i < ER * MW; i += THREADS) {
        const int y = i / MW, x = i % MW, my = y + 1;
        const uint32_t c = s.m[my][x];
        const uint32_t lft = (c << 1) | (x > 0 ? s.m[my][x - 1] >> 31 : 1u);
        const uint32_t rgt = (c >> 1)
            | (x < MW - 1 ? s.m[my][x + 1] << 31 : 0x80000000u);
        s.e[y][x] = c & lft & rgt & s.m[my - 1][x] & s.m[my + 1][x]
            & inside_bits(r0 - 1 + y, c0 + 32 * (x - 1), H, W);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TH * WK; i += THREADS) {
        const int y = i / WK, x = i % WK, ey = y + 1, ex = x + 1;
        const uint32_t c = s.e[ey][ex];
        const uint32_t lft = (c << 1) | (s.e[ey][ex - 1] >> 31);
        const uint32_t rgt = (c >> 1) | (s.e[ey][ex + 1] << 31);
        s.lab.d[y][x] = (c | lft | rgt | s.e[ey - 1][ex] | s.e[ey + 1][ex])
            & inside_bits(r0 + y, c0 + 32 * x, H, W);
    }
}

// K2: the tile's mask bytes of one level, 32 to a word by one warp vote
__device__ void mask_words(TileLabels& s,
                           const unsigned char* __restrict__ plane, int r0,
                           int c0, int H, int W) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < TH * WK; i += THREADS / 32) {
        const int y = i / WK, x = i % WK;
        const int r = r0 + y, c = c0 + 32 * x + lane;
        const bool fg = r < H && c < W && plane[(size_t)r * W + c] != 0;
        const unsigned b = __ballot_sync(FULL, fg);
        if (lane == 0) s.d[y][x] = b;
    }
}

// ------------------------------------------------------------- tile UF
__device__ __forceinline__ int find_shared(volatile int* par, int a) {
    int p = par[a];
    while (p != a) {
        a = p;
        p = par[a];
    }
    return a;
}

__device__ void unite_shared(int* par, int a, int b) {
    volatile int* vpar = par;
    while (true) {
        a = find_shared(vpar, a);
        b = find_shared(vpar, b);
        if (a == b) return;
        if (a > b) { const int tmp = a; a = b; b = tmp; }
        const int old = atomicMin(par + b, a);
        if (old == b) return;
        b = old;
    }
}

// tile id of the head of the run that holds foreground pixel (y, c)
__device__ __forceinline__ int run_head(const TileLabels& s, int y, int c) {
    int x = c >> 5;
    uint32_t z = ~s.d[y][x] & ((1u << (c & 31)) - 1u);
    while (z == 0u && x > 0) z = ~s.d[y][--x];
    // the run starts after the highest background bit below c, or at 0
    return y * TWP + (z ? x * 32 + 32 - __clz(z) : 0);
}

// word x of tile row y - 1, shifted so that bit b holds column 32x + b + k
__device__ __forceinline__ uint32_t above(const TileLabels& s, int y, int x,
                                          int k) {
    const uint32_t w = s.d[y - 1][x];
    if (k == 0) return w;
    if (k > 0) return (w >> 1) | (x + 1 < WK ? s.d[y - 1][x + 1] << 31 : 0u);
    return (w << 1) | (x > 0 ? s.d[y - 1][x - 1] >> 31 : 0u);
}

__device__ __forceinline__ uint32_t heads_of(const TileLabels& s, int y,
                                             int x) {
    const uint32_t w = s.d[y][x];
    return w & ~((w << 1) | (x > 0 ? s.d[y][x - 1] >> 31 : 0u));
}

__device__ __forceinline__ bool is_set(const TileLabels& s, int y, int c) {
    return (s.d[y][c >> 5] >> (c & 31)) & 1u;
}

// union-find over the runs of lab.d; afterwards par[h] is the tile root of
// every run head h: the smallest tile id, hence the smallest pixel id, of
// the head's piece of the tile
__device__ void label_tile(TileLabels& s, int conn8) {
    const int tid = threadIdx.x;
    const int y = tid / WK, x = tid % WK;
    const bool mine = tid < TH * WK;
    if (mine) {
        for (uint32_t h = heads_of(s, y, x); h; h &= h - 1) {
            const int id = y * TWP + x * 32 + __ffs(h) - 1;
            s.par[id] = id;
        }
    }
    __syncthreads();
    if (mine && y > 0) {
        for (int k = conn8 ? -1 : 0; k <= conn8; ++k) {
            // pixels whose neighbour at offset k in the row above is set;
            // each stretch of them is one pair of runs: unite at its start
            const uint32_t pairs = s.d[y][x] & above(s, y, x, k);
            const uint32_t carry =
                x > 0 ? (s.d[y][x - 1] & above(s, y, x - 1, k)) >> 31 : 0u;
            for (uint32_t st = pairs & ~((pairs << 1) | carry); st;
                 st &= st - 1) {
                const int c = x * 32 + __ffs(st) - 1;
                unite_shared(s.par, run_head(s, y, c),
                             run_head(s, y - 1, c + k));
            }
        }
    }
    __syncthreads();
    if (mine) {
        for (uint32_t h = heads_of(s, y, x); h; h &= h - 1) {
            const int id = y * TWP + x * 32 + __ffs(h) - 1;
            s.par[id] = find_shared(s.par, id);
        }
    }
    __syncthreads();
}

// ----------------------------------------------------------- global UF
// plane[id] holds parent id + 1 for a tile root; parents are smaller ids
__device__ int find_global(int* plane, int a) {
    while (true) {
        const int p = __ldcg(plane + a) - 1;
        if (p == a) return a;
        const int g = __ldcg(plane + p) - 1;
        if (g == p) return p;
        atomicMin(plane + a, g + 1);   // path halving
        a = g;
    }
}

__device__ void unite_global(int* plane, int a, int b) {
    while (true) {
        a = find_global(plane, a);
        b = find_global(plane, b);
        if (a == b) return;
        if (a > b) { const int tmp = a; a = b; b = tmp; }
        const int old = atomicMin(plane + b, a + 1) - 1;
        if (old == b) return;
        b = old;
    }
}

// ------------------------------------------------------- pass outputs
// pass 1: tile roots (own id + 1) and the labels of the tile's edges
__device__ void write_edges(const TileLabels& s, int* plane, int r0, int c0,
                            int H, int W) {
    const int tid = threadIdx.x;
    if (tid < TH * WK) {
        const int y = tid / WK, x = tid % WK;
        for (uint32_t h = heads_of(s, y, x); h; h &= h - 1) {
            const int id = y * TWP + x * 32 + __ffs(h) - 1;
            if (s.par[id] == id) {
                const int g = (r0 + y) * W + c0 + id % TWP;
                plane[g] = g + 1;
            }
        }
    }
    for (int i = tid; i < 2 * (TWP + TH); i += THREADS) {
        int y, c;
        if (i < 2 * TWP) {
            y = i < TWP ? 0 : TH - 1;
            c = i % TWP;
        } else {
            y = (i - 2 * TWP) % TH;
            c = i - 2 * TWP < TH ? 0 : TWP - 1;
        }
        const int r = r0 + y, cc = c0 + c;
        if (r >= H || cc >= W) continue;
        int v = 0;
        if (is_set(s, y, c)) {
            const int root = s.par[run_head(s, y, c)];
            v = (r0 + root / TWP) * W + c0 + root % TWP + 1;
        }
        plane[(size_t)r * W + cc] = v;
    }
}

// pass 3: every pixel's final label, each written once
__device__ void write_final(TileLabels& s, int* plane, int r0, int c0,
                            int H, int W) {
    const int tid = threadIdx.x;
    if (tid < TH * WK) {
        const int y = tid / WK, x = tid % WK;
        for (uint32_t h = heads_of(s, y, x); h; h &= h - 1) {
            const int id = y * TWP + x * 32 + __ffs(h) - 1;
            if (s.par[id] == id) {
                // a tile root now holds its final label, negated
                int g = (r0 + y) * W + c0 + id % TWP;
                for (int p; (p = __ldcg(plane + g) - 1) != g;) g = p;
                s.par[id] = -(g + 1);
            }
        }
    }
    __syncthreads();
    const bool vec = (W & 3) == 0;
    for (int i = tid; i < TH * (TWP / 4); i += THREADS) {
        const int y = i / (TWP / 4), c = 4 * (i % (TWP / 4));
        const int r = r0 + y, cc = c0 + c;
        if (r >= H || cc >= W) continue;
        const uint32_t bits = (s.d[y][c >> 5] >> (c & 31)) & 0xfu;
        int v[4];
        int run = 0;   // the label of the previous pixel's run
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (!((bits >> j) & 1u)) {
                v[j] = run = 0;
                continue;
            }
            if (run == 0) {
                const int p = s.par[run_head(s, y, c + j)];
                run = p < 0 ? -p : -s.par[p];
            }
            v[j] = run;
        }
        int* dst = plane + (size_t)r * W + cc;
        if (vec && cc + 4 <= W) {
            *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (cc + j < W) dst[j] = v[j];
        }
    }
}

// ---------------------------------------------------------- tile passes
// grid (tiles, level groups of lpb levels); FINAL: pass 3, else pass 1
template <bool MASKS, bool FINAL>
__global__ void __launch_bounds__(THREADS)
ccl_tiles(const float* __restrict__ aod, const float* __restrict__ th,
          const unsigned char* __restrict__ masks, int* __restrict__ out,
          int T, int H, int W, int conn8, int lpb) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n_cols = (W + TWP - 1) / TWP;
    const int r0 = (blockIdx.x / n_cols) * TH;
    const int c0 = (blockIdx.x % n_cols) * TWP;
    const int t0 = blockIdx.y * lpb;
    const int t1 = min(T, t0 + lpb);
    TileAod* sa = reinterpret_cast<TileAod*>(smem);
    TileLabels& s = MASKS ? *reinterpret_cast<TileLabels*>(smem) : sa->lab;
    if (!MASKS) load_aod(*sa, aod, r0, c0, H, W);
    for (int t = t0; t < t1; ++t) {
        const size_t plane = (size_t)t * H * W;
        __syncthreads();   // the AOD is loaded; the last level is written
        if (MASKS) {
            mask_words(s, masks + plane, r0, c0, H, W);
        } else {
            opened_words(*sa, th[t], r0, c0, H, W);
        }
        __syncthreads();
        label_tile(s, conn8);
        if (FINAL) {
            write_final(s, out + plane, r0, c0, H, W);
        } else {
            write_edges(s, out + plane, r0, c0, H, W);
        }
    }
}

// ----------------------------------------------------------------- border
// pixels p and q adjacent across a seam: unite their pieces, unless the
// pair `shift` elements back along the seam (0: none) has the same labels.
// That pair has the same relation and joins the same pieces (labels that
// are equal now stay in one set), so this one adds nothing.
__device__ __forceinline__ void seam_pair(int* plane, int p, int q,
                                          int shift) {
    const int lp = __ldcg(plane + p), lq = __ldcg(plane + q);
    if (lp == 0 || lq == 0) return;
    if (shift && __ldcg(plane + p - shift) == lp
        && __ldcg(plane + q - shift) == lq)
        return;
    unite_global(plane, lp - 1, lq - 1);
}

// one thread per seam pixel: the rows r = k * TH (k >= 1) with the row
// above, then the columns c = k * TWP with the column to their left
__global__ void __launch_bounds__(THREADS)
ccl_border(int* __restrict__ out, int H, int W, int conn8) {
    const long long n_rows = (H + TH - 1) / TH, n_cols = (W + TWP - 1) / TWP;
    const long long n_h = (n_rows - 1) * W, n_v = (n_cols - 1) * H;
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_h + n_v) return;
    int* plane = out + (size_t)blockIdx.y * H * W;
    if (i < n_h) {
        const int r = (int)(i / W + 1) * TH, c = (int)(i % W);
        const int p = r * W + c;
        for (int k = conn8 ? -1 : 0; k <= conn8; ++k) {
            if (c + k < 0 || c + k >= W) continue;
            seam_pair(plane, p, p - W + k, c > 0 && c + k > 0 ? 1 : 0);
        }
    } else {
        const int c = (int)((i - n_h) / H + 1) * TWP;
        const int r = (int)((i - n_h) % H);
        const int b = r * W + c, a = b - 1;   // right and left of the seam
        seam_pair(plane, b, a, r >= 1 ? W : 0);
        if (conn8 && r >= 1) {
            seam_pair(plane, b, a - W, r >= 2 ? W : 0);   // up-left
            seam_pair(plane, a, b - W, r >= 2 ? W : 0);   // up-right
        }
    }
}

// levels per block: all of them where the tiles alone make ROUNDS rounds
// of resident blocks (`slots`: SMs x blocks per SM), else fewer, so that
// levels of unequal cost spread over many short blocks and the last round
// is short
constexpr long long ROUNDS = 8;

int levels_per_block(int T, long long tiles, long long slots) {
    long long groups = (ROUNDS * slots + tiles - 1) / tiles;
    if (groups > T) groups = T;
    return (int)((T + groups - 1) / groups);
}

// allow a tile pass `smem` bytes of shared memory. The attribute belongs
// to the current device, and a process may launch on several cards, so it
// is set on every launch, as fused_conv.cu sets its own
template <bool MASKS, bool FINAL>
cudaError_t set_smem(size_t smem) {
    return cudaFuncSetAttribute(ccl_tiles<MASKS, FINAL>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

template <bool MASKS, bool FINAL>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t s,
                         const float* aod, const float* th,
                         const unsigned char* masks, int* out, int T, int H,
                         int W, int conn8, int lpb) {
    const cudaError_t err = set_smem<MASKS, FINAL>(smem);
    if (err != cudaSuccess) return err;
    ccl_tiles<MASKS, FINAL><<<grid, THREADS, smem, s>>>(
        aod, th, masks, out, T, H, W, conn8, lpb);
    return cudaGetLastError();
}

// the first `passes` of the three; MASKS: K2 from `masks`, else K1
template <bool MASKS>
int run_passes(const float* aod, const float* th, const unsigned char* masks,
               int* out, int T, int H, int W, int connectivity, int passes,
               void* stream) {
    if (T < 1 || H < 1 || W < 1 || T > 65535 ||
        (long long)H * W >= 0x7fffffffLL ||
        (connectivity != 1 && connectivity != 2) || passes < 1 || passes > 3)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int conn8 = connectivity == 2;
    const long long n_rows = (H + TH - 1) / TH, n_cols = (W + TWP - 1) / TWP;
    const long long tiles = n_rows * n_cols;
    const size_t smem = MASKS ? sizeof(TileLabels) : sizeof(TileAod);
    int lpb = 1;
    if (!MASKS) {
        int dev = 0, sms = 132, per_sm = 1;
        if (cudaGetDevice(&dev) == cudaSuccess)
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        // the occupancy query reads the raised attribute
        const cudaError_t err = set_smem<MASKS, true>(smem);
        if (err != cudaSuccess) return (int)err;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ccl_tiles<MASKS, true>, THREADS, smem);
        lpb = levels_per_block(T, tiles, (long long)sms * max(per_sm, 1));
    }
    const dim3 grid((unsigned)tiles, (T + lpb - 1) / lpb);
    cudaError_t err = launch_tiles<MASKS, false>(
        grid, smem, s, aod, th, masks, out, T, H, W, conn8, lpb);
    if (err != cudaSuccess || passes < 2) return (int)err;
    const long long seams = (n_rows - 1) * W + (n_cols - 1) * H;
    if (seams > 0) {
        const dim3 bgrid((unsigned)((seams + THREADS - 1) / THREADS), T);
        ccl_border<<<bgrid, THREADS, 0, s>>>(out, H, W, conn8);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (passes < 3) return 0;
    return (int)launch_tiles<MASKS, true>(grid, smem, s, aod, th, masks, out,
                                          T, H, W, conn8, lpb);
}

}  // namespace

extern "C" {

// aod: (H, W) float32; thresholds: (T,) float32; out: (T, H, W) int32, all
// contiguous on the device. connectivity: 2 (8-neighbour) or 1. Launches
// the first `passes` (1-3) of local, border and finalize on `stream`;
// returns a cudaError_t (0 on success). Fewer than three passes leave
// `out` unfinished: only the per-pass timing calls them.
int pk_ccl_sweep_passes(const float* aod, const float* thresholds, int* out,
                        int T, int H, int W, int connectivity, int passes,
                        void* stream) {
    return run_passes<false>(aod, thresholds, nullptr, out, T, H, W,
                             connectivity, passes, stream);
}

int pk_ccl_sweep(const float* aod, const float* thresholds, int* out,
                 int T, int H, int W, int connectivity, void* stream) {
    return pk_ccl_sweep_passes(aod, thresholds, out, T, H, W, connectivity,
                               3, stream);
}

// masks: (T, H, W) one byte per pixel, nonzero = foreground; out: (T, H, W)
// int32, both contiguous on the device. Same checks, passes and return
// value as pk_ccl_sweep_passes.
int pk_ccl_masks_passes(const unsigned char* masks, int* out, int T, int H,
                        int W, int connectivity, int passes, void* stream) {
    return run_passes<true>(nullptr, nullptr, masks, out, T, H, W,
                            connectivity, passes, stream);
}

int pk_ccl_masks(const unsigned char* masks, int* out, int T, int H, int W,
                 int connectivity, void* stream) {
    return pk_ccl_masks_passes(masks, out, T, H, W, connectivity, 3, stream);
}

const char* pk_ccl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
