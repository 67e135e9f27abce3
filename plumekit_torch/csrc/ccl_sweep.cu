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
// VMEM (K1) or stream it through HBM in bands (K4) and propagate labels by
// sweeps with warm starts from level to level. None of that is needed
// here: the label planes live in device memory at every scene size, so one
// kernel set serves both entry points, and the T levels are independent,
// so all of them run at once (blockIdx.z = t).
//
// Algorithm: block-based union-find (Playne & Hawick 2018; Allegretti et
// al.'s BUF). Labels are stored as parent id + 1 (0 = background), so the
// finished forest is the output format itself.
//   1. local:    a block owns a 32 x 16 tile of one level. It thresholds
//                the AOD over the tile plus a 2-pixel halo into shared
//                memory, erodes (a neighbour outside the image counts as
//                foreground) and dilates (outside counts as background),
//                then runs union-find on the tile in shared memory and
//                writes each pixel's tile root (as a global id + 1). The
//                mask-stack front end (K2) reads the tile's foreground
//                from its mask plane instead: no threshold, no opening, no
//                halo, then the same union-find and the same roots.
//   2. border:   pixels on a tile's top row and side columns unite with
//                their neighbours in other tiles, in global memory.
//   3. finalize: every pixel's parent becomes its root.
// A union always links the larger root under the smaller one (atomicMin),
// so a root is the smallest id of its tree and the final root of a
// component is its smallest pixel id, whatever order the atomics ran in:
// the output is the contract bit for bit.
//
// What bounds it on an H100: memory traffic. At 8192^2 and T = 20 the
// label stack is 5.4 GB; the local pass writes it once, the finalize pass
// reads and (where a pixel's parent is not yet its root) rewrites it, and
// the AOD is read once per level (268 MB per level, mostly from L2 for the
// halo). The border pass touches 1/16 + 2/32 of the pixels. The design
// keeps the threshold mask, the opening and the first round of unions in
// shared memory so that no (T, H, W) mask or opened stack is ever written.
// K2 reads one byte and writes four per pixel and level in its local pass
// and shares the other two passes; its callers label one mask (T = 1), so
// its three launches weigh as much as its traffic up to about 2000^2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;   // tile width  (one warp per tile row)
constexpr int TH = 16;   // tile height
constexpr int HALO = 2;  // the opening reads a radius-2 cross neighbourhood

// -------------------------------------------------------------- shared UF
__device__ __forceinline__ int find_shared(volatile int* lab, int a) {
    int p = lab[a];
    while (p != a) {
        a = p;
        p = lab[a];
    }
    return a;
}

__device__ void unite_shared(int* lab, int a, int b) {
    volatile int* vlab = lab;
    while (true) {
        a = find_shared(vlab, a);
        b = find_shared(vlab, b);
        if (a == b) return;
        if (a > b) { int tmp = a; a = b; b = tmp; }
        int old = atomicMin(lab + b, a);
        if (old == b) return;
        b = old;
    }
}

// -------------------------------------------------------------- global UF
// plane[id] holds parent id + 1 for a foreground pixel, 0 for background
__device__ __forceinline__ int find_global(const volatile int* plane, int a) {
    int p = plane[a] - 1;
    while (p != a) {
        a = p;
        p = plane[a] - 1;
    }
    return a;
}

__device__ void unite_global(int* plane, int a, int b) {
    const volatile int* vplane = plane;
    while (true) {
        a = find_global(vplane, a);
        b = find_global(vplane, b);
        if (a == b) return;
        if (a > b) { int tmp = a; a = b; b = tmp; }
        int old = atomicMin(plane + b, a + 1) - 1;
        if (old == b) return;
        b = old;
    }
}

// ------------------------------------------------------------- tile pass
// Union-find over one TW x TH tile in shared memory, given each thread's
// foreground flag; writes each inside pixel's tile root to `plane` as a
// global id + 1 (0 for background). Every thread of the block calls it.
__device__ __forceinline__ void label_tile(int* s_lab, bool fg, bool inside,
                                           int r0, int c0, int r, int c,
                                           int W, int conn8, int* plane) {
    const int lx = threadIdx.x, ly = threadIdx.y;
    const int tid = ly * TW + lx;
    s_lab[tid] = fg ? tid : -1;
    __syncthreads();

    if (fg) {
        if (lx > 0 && s_lab[tid - 1] >= 0) unite_shared(s_lab, tid, tid - 1);
        if (ly > 0) {
            if (s_lab[tid - TW] >= 0) unite_shared(s_lab, tid, tid - TW);
            if (conn8) {
                if (lx > 0 && s_lab[tid - TW - 1] >= 0)
                    unite_shared(s_lab, tid, tid - TW - 1);
                if (lx < TW - 1 && s_lab[tid - TW + 1] >= 0)
                    unite_shared(s_lab, tid, tid - TW + 1);
            }
        }
    }
    __syncthreads();

    if (inside) {
        int v = 0;
        if (fg) {
            // local ids are row-major within the tile, so the smallest
            // local id is also the smallest global id of the tile's piece
            const int root = find_shared(s_lab, tid);
            v = (r0 + root / TW) * W + (c0 + root % TW) + 1;
        }
        plane[(size_t)r * W + c] = v;
    }
}

// ------------------------------------------------------------------ local
__global__ void __launch_bounds__(TW * TH)
ccl_local(const float* __restrict__ aod, const float* __restrict__ th,
          int* __restrict__ out, int H, int W, int conn8) {
    // threshold mask over the tile + halo: 1 above threshold, 0 below,
    // 2 outside the image (foreground for erosion, background for dilation)
    __shared__ unsigned char s_m[TH + 2 * HALO][TW + 2 * HALO];
    __shared__ unsigned char s_e[TH + 2][TW + 2];   // eroded, 1-px ring
    __shared__ int s_lab[TH * TW];

    const int t = blockIdx.z;
    const float thr = th[t];
    const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
    const int lx = threadIdx.x, ly = threadIdx.y;
    const int tid = ly * TW + lx;

    for (int i = tid; i < (TH + 2 * HALO) * (TW + 2 * HALO); i += TW * TH) {
        const int y = i / (TW + 2 * HALO), x = i % (TW + 2 * HALO);
        const int r = r0 + y - HALO, c = c0 + x - HALO;
        unsigned char v = 2;
        if (r >= 0 && r < H && c >= 0 && c < W)
            v = aod[(size_t)r * W + c] > thr ? 1 : 0;   // NaN -> 0
        s_m[y][x] = v;
    }
    __syncthreads();

    for (int i = tid; i < (TH + 2) * (TW + 2); i += TW * TH) {
        const int y = i / (TW + 2) + 1, x = i % (TW + 2) + 1;  // in s_m
        unsigned char v = 0;
        if (s_m[y][x] == 1)
            v = s_m[y - 1][x] != 0 && s_m[y + 1][x] != 0 &&
                s_m[y][x - 1] != 0 && s_m[y][x + 1] != 0;
        s_e[y - 1][x - 1] = v;   // outside pixels (2) erode to 0
    }
    __syncthreads();

    const int r = r0 + ly, c = c0 + lx;
    const bool inside = r < H && c < W;
    const int ey = ly + 1, ex = lx + 1;
    const bool fg = inside &&
        (s_e[ey][ex] | s_e[ey - 1][ex] | s_e[ey + 1][ex] |
         s_e[ey][ex - 1] | s_e[ey][ex + 1]);
    label_tile(s_lab, fg, inside, r0, c0, r, c, W, conn8,
               out + (size_t)t * H * W);
}

// the mask-stack front end (K2): a tile's foreground is its mask bytes
__global__ void __launch_bounds__(TW * TH)
ccl_local_masks(const unsigned char* __restrict__ masks,
                int* __restrict__ out, int H, int W, int conn8) {
    __shared__ int s_lab[TH * TW];
    const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
    const int r = r0 + threadIdx.y, c = c0 + threadIdx.x;
    const bool inside = r < H && c < W;
    const size_t plane = (size_t)blockIdx.z * H * W;
    const bool fg = inside && masks[plane + (size_t)r * W + c] != 0;
    label_tile(s_lab, fg, inside, r0, c0, r, c, W, conn8, out + plane);
}

// ----------------------------------------------------------------- border
__global__ void __launch_bounds__(TW * TH)
ccl_border(int* __restrict__ out, int H, int W, int conn8) {
    const int lx = threadIdx.x, ly = threadIdx.y;
    if (ly != 0 && lx != 0 && lx != TW - 1) return;
    const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
    const int r = r0 + ly, c = c0 + lx;
    if (r >= H || c >= W) return;
    int* plane = out + (size_t)blockIdx.z * H * W;
    const int p = r * W + c;
    if (plane[p] == 0) return;

    // the backward neighbours (left, up, up-left, up-right) that lie in
    // another tile; every cross-tile pair is some pixel's backward pair
    const int nbr[4][2] = {{0, -1}, {-1, 0}, {-1, -1}, {-1, 1}};
    const int n_nbr = conn8 ? 4 : 2;
    for (int k = 0; k < n_nbr; ++k) {
        const int qr = r + nbr[k][0], qc = c + nbr[k][1];
        if (qr < 0 || qc < 0 || qc >= W) continue;
        if (qr >= r0 && qc >= c0 && qc < c0 + TW) continue;   // same tile
        const int q = qr * W + qc;
        if (plane[q] == 0) continue;
        unite_global(plane, p, q);
    }
}

// --------------------------------------------------------------- finalize
__global__ void __launch_bounds__(TW * TH)
ccl_finalize(int* __restrict__ out, int H, int W) {
    const int r = blockIdx.y * TH + threadIdx.y;
    const int c = blockIdx.x * TW + threadIdx.x;
    if (r >= H || c >= W) return;
    int* plane = out + (size_t)blockIdx.z * H * W;
    const int p = r * W + c;
    const int v = plane[p];
    if (v == 0) return;
    const int root = find_global(plane, v - 1);
    if (root + 1 != v) plane[p] = root + 1;
}

}  // namespace

extern "C" {

// aod: (H, W) float32; thresholds: (T,) float32; out: (T, H, W) int32, all
// contiguous on the device. connectivity: 2 (8-neighbour) or 1. Launches
// on `stream`; returns a cudaError_t (0 on success).
int pk_ccl_sweep(const float* aod, const float* thresholds, int* out,
                 int T, int H, int W, int connectivity, void* stream) {
    if (T < 1 || H < 1 || W < 1 || T > 65535 ||
        (long long)H * W >= 0x7fffffffLL || (H + TH - 1) / TH > 65535 ||
        (connectivity != 1 && connectivity != 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int conn8 = connectivity == 2;
    dim3 block(TW, TH);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, T);
    ccl_local<<<grid, block, 0, s>>>(aod, thresholds, out, H, W, conn8);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ccl_border<<<grid, block, 0, s>>>(out, H, W, conn8);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ccl_finalize<<<grid, block, 0, s>>>(out, H, W);
    return (int)cudaGetLastError();
}

// masks: (T, H, W) one byte per pixel, nonzero = foreground; out: (T, H, W)
// int32, both contiguous on the device. Same checks, passes and return
// value as pk_ccl_sweep.
int pk_ccl_masks(const unsigned char* masks, int* out, int T, int H, int W,
                 int connectivity, void* stream) {
    if (T < 1 || H < 1 || W < 1 || T > 65535 ||
        (long long)H * W >= 0x7fffffffLL || (H + TH - 1) / TH > 65535 ||
        (connectivity != 1 && connectivity != 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int conn8 = connectivity == 2;
    dim3 block(TW, TH);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, T);
    ccl_local_masks<<<grid, block, 0, s>>>(masks, out, H, W, conn8);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ccl_border<<<grid, block, 0, s>>>(out, H, W, conn8);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ccl_finalize<<<grid, block, 0, s>>>(out, H, W);
    return (int)cudaGetLastError();
}

const char* pk_ccl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
