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
// Design: grid (blocks per level, T), each block striding over its level's
// plane. A block first puts the distinct nonzero labs of its level into a
// 256-slot open-addressed table in shared memory (load at most one half,
// so a probe ends within a slot or two). Each thread then reads 4 pixels per
// 16-byte load, two loads in flight, and probes once per pixel: a zero
// adds to the thread's own counter (the background matches most pixels,
// so it never touches a shared counter), a hit is counted by warp-aggregated
// adds (__match_any_sync over the lanes that hit, one shared atomicAdd by
// each group's leader), a miss costs the probe alone. At the end the
// block's zeros are summed by a warp reduction, and counts[t, f] is a
// gather from the table (zeros for a lab of 0), so duplicates come out
// right; one global atomicAdd per block and lab. Integer sums, so the
// order of the atomics cannot change a count.
//
// What bounds it on an H100: the bytes of the stack, 4 per pixel and level
// (5.4 GB at 8192^2, T = 20), read once whatever F is: the work per pixel
// is one probe, not one compare per lab.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXF = 128;
constexpr int SLOTS = 256;          // a power of two, at least 2 * MAXF
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int slot_of(int v) {
    return (int)(((uint32_t)v * 2654435761u) >> 24);   // 8 bits: SLOTS
}

struct Table {
    int key[SLOTS];                 // 0 = empty (a lab of 0 is not stored)
    int cnt[SLOTS];
};

// count one pixel; every lane of the warp calls it together
__device__ __forceinline__ void count(Table& s, int v, bool in, int& zeros,
                                      int lane) {
    zeros += in && v == 0;
    int h = -1;
    if (in && v != 0) {
        h = slot_of(v);
        int k;
        while ((k = s.key[h]) != v && k != 0) h = (h + 1) & (SLOTS - 1);
        if (k == 0) h = -1;
    }
    const unsigned hit = __ballot_sync(FULL, h >= 0);
    if (h >= 0) {
        const unsigned peers = __match_any_sync(hit, h);
        if (lane == __ffs(peers) - 1) atomicAdd(&s.cnt[h], __popc(peers));
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
label_counts(const int* __restrict__ labels, const int* __restrict__ labs,
             int* __restrict__ counts, long long hw, int F) {
    __shared__ Table s;
    __shared__ int s_slot[MAXF];
    __shared__ int s_zeros;
    const int t = blockIdx.y;
    for (int i = threadIdx.x; i < SLOTS; i += THREADS) {
        s.key[i] = 0;
        s.cnt[i] = 0;
    }
    if (threadIdx.x == 0) s_zeros = 0;
    __syncthreads();
    if (threadIdx.x < F) {
        const int v = labs[(size_t)t * F + threadIdx.x];
        int h = -1;
        if (v != 0) {
            h = slot_of(v);
            for (int old; (old = atomicCAS(&s.key[h], 0, v)) != 0 && old != v;)
                h = (h + 1) & (SLOTS - 1);
        }
        s_slot[threadIdx.x] = h;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int* plane = labels + (size_t)t * hw;
    const long long stride = (long long)gridDim.x * THREADS;
    // each warp's base is uniform, so every lane reaches each vote
    const long long first = (long long)blockIdx.x * THREADS
        + (threadIdx.x & ~31);
    int zeros = 0;
    if (VEC) {
        const int4* p4 = reinterpret_cast<const int4*>(plane);
        const long long n = hw / 4;
        for (long long base = first; base < n; base += 2 * stride) {
            const long long i = base + lane, j = i + stride;
            const bool in_i = i < n, in_j = j < n;
            const int4 a = in_i ? __ldcs(p4 + i) : make_int4(0, 0, 0, 0);
            const int4 b = in_j ? __ldcs(p4 + j) : make_int4(0, 0, 0, 0);
            count(s, a.x, in_i, zeros, lane);
            count(s, a.y, in_i, zeros, lane);
            count(s, a.z, in_i, zeros, lane);
            count(s, a.w, in_i, zeros, lane);
            count(s, b.x, in_j, zeros, lane);
            count(s, b.y, in_j, zeros, lane);
            count(s, b.z, in_j, zeros, lane);
            count(s, b.w, in_j, zeros, lane);
        }
    } else {
        for (long long base = first; base < hw; base += stride) {
            const long long i = base + lane;
            const bool in = i < hw;
            count(s, in ? __ldcs(plane + i) : 0, in, zeros, lane);
        }
    }
    zeros = __reduce_add_sync(FULL, zeros);
    if (lane == 0 && zeros) atomicAdd(&s_zeros, zeros);
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += THREADS) {
        const int h = s_slot[f];
        const int c = h < 0 ? s_zeros : s.cnt[h];
        if (c) atomicAdd(counts + (size_t)t * F + f, c);
    }
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
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // 16-byte loads where every plane starts on a 16-byte boundary
    const bool vec = hw % 4 == 0 && (uintptr_t)labels % 16 == 0;
    const long long units = vec ? hw / 4 : hw;
    // two waves of eight blocks per SM over all levels, no block idle
    long long per_level = (2LL * 8 * sms + T - 1) / T;
    const long long most = (units + THREADS - 1) / THREADS;
    if (per_level > most) per_level = most;
    const dim3 grid((unsigned)per_level, T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec) {
        label_counts<true><<<grid, THREADS, 0, s>>>(labels, labs, counts, hw,
                                                    F);
    } else {
        label_counts<false><<<grid, THREADS, 0, s>>>(labels, labs, counts, hw,
                                                     F);
    }
    return (int)cudaGetLastError();
}

const char* pk_label_counts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
