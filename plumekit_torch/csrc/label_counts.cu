// Per-(threshold, fire) component sizes: the K3 kernel of the identify
// sweep.
//
// Replaces the Pallas TPU kernel fire_label_counts
// (plumekit/ops/pallas/label_counts.py:83):
//
//   counts[t, f] = sum over pixels of (labels[t] == labs[t, f])
//
// for a (T, H, W) int32 label stack and a (T, F) int32 table, F <= 128.
// Exact for every lab, duplicates and 0 (the background) included.
//
// Design: grid (chunks, T). A block streams one chunk of one label plane,
// one pixel per lane per step, so that a warp reads 128 contiguous bytes.
// For each lab f the warp takes a ballot of the lanes whose pixel equals
// it; lane f % 32 adds the ballot's popcount to its register counter
// f / 32 (four registers cover F = 128). No counter is contended inside
// the pixel loop, even for lab 0, which matches most pixels. At the end
// the warps add their counters into shared memory and the block adds
// those into the zero-initialised (T, F) table with one global atomic per
// lab. Integer sums, so the order of the atomics cannot change a count.
//
// What bounds it on an H100: issue rate, not bytes. Every pixel costs
// about six warp instructions per lab per 32 pixels (shared load,
// compare, vote, popcount, lane test, add), so at F = 128 a 1.34 G-pixel
// stack (8192^2, T = 20) is some 20 G warp instructions against 5.4 GB
// of reads. The plain version reads the stack once per lab instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXF = 128;
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 128;   // pixels per block

__global__ void __launch_bounds__(THREADS)
label_counts(const int* __restrict__ labels, const int* __restrict__ labs,
             int* __restrict__ counts, long long hw, int F) {
    __shared__ int s_labs[MAXF];
    __shared__ int s_cnt[MAXF];
    const int t = blockIdx.y;
    for (int i = threadIdx.x; i < MAXF; i += THREADS) {
        s_labs[i] = i < F ? labs[(size_t)t * F + i] : 0;
        s_cnt[i] = 0;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* plane = labels + (size_t)t * hw;
    const long long start = (long long)blockIdx.x * CHUNK;
    const long long end = start + CHUNK < hw ? start + CHUNK : hw;
    int acc[MAXF / 32] = {0, 0, 0, 0};

    for (long long i0 = start + warp * 32; i0 < end; i0 += THREADS) {
        const long long i = i0 + lane;
        const bool in = i < end;
        const int v = in ? __ldg(plane + i) : 0;
        // the guards on F are warp-uniform, so every lane reaches each
        // ballot; no break, so that acc[] stays in registers
#pragma unroll
        for (int g = 0; g < MAXF / 32; ++g) {
            if (g * 32 < F) {
#pragma unroll 8
                for (int j = 0; j < 32; ++j) {
                    const int f = g * 32 + j;
                    if (f < F) {
                        const unsigned b = __ballot_sync(
                            0xffffffffu, in && v == s_labs[f]);
                        if (lane == j) acc[g] += __popc(b);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int g = 0; g < MAXF / 32; ++g) {
        const int f = g * 32 + lane;
        if (f < F && acc[g]) atomicAdd(&s_cnt[f], acc[g]);
    }
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += THREADS)
        if (s_cnt[f]) atomicAdd(counts + (size_t)t * F + f, s_cnt[f]);
}

}  // namespace

extern "C" {

// labels: (T, H*W) int32; labs: (T, F) int32; counts: (T, F) int32, zeroed
// by the caller; all contiguous on the device. Launches on `stream`;
// returns a cudaError_t (0 on success).
int pk_label_counts(const int* labels, const int* labs, int* counts,
                    int T, long long hw, int F, void* stream) {
    if (T < 1 || T > 65535 || hw < 1 || F < 1 || F > MAXF)
        return (int)cudaErrorInvalidValue;
    const long long chunks = (hw + CHUNK - 1) / CHUNK;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)chunks, T);
    label_counts<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        labels, labs, counts, hw, F);
    return (int)cudaGetLastError();
}

const char* pk_label_counts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
