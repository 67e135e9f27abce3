// Probe of dependent gathers on Hopper (sm_90a): a copy of an (H, W) int32
// plane in which N strided positions are replaced by a two-hop lookup,
//   out[r, c] = x[x[r, c] / W, x[r, c] % W],
// the access pattern of a union-find `find` (each hop's address is the value
// the hop before it loaded).
//
// Replaces the Pallas TPU probe experiments/scalar_dma_probe.py run (:85,
// pallas_call :88), which asks whether that chip can start per-element DMAs
// at computed offsets. On this card any thread can load from a computed
// address, so the question becomes what a dependent load costs. Two forms,
// the same result (every read is from the input, so order does not matter):
//   chained:  one thread walks the N positions in turn, each lookup's
//             address made to wait for the lookup before it, so time / N
//             is the latency of two dependent loads;
//   parallel: one thread per position; time / N is the throughput.
// What bounds it: the plane copy moves 8 bytes per pixel; the lookups are
// N * 12 bytes and, chained, N * 2 round trips to L2 or device memory: at
// the probe's size the parallel form is bound by its launch, the chained
// form by latency.
// Plain interface for ctypes; every launch returns its cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// position i of the probe's static grid: 32 rows of N / 32 columns
__device__ __forceinline__ int probe_position(int i, int per_row, int stride_r,
                                              int stride_c, int W) {
  return (i / per_row) * stride_r * W + (i % per_row) * stride_c;
}

__global__ void copy_plane_kernel(const int* x, int* out, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = x[i];
}

__global__ void gather_chained_kernel(const int* x, int* out, int W, int n,
                                      int per_row, int stride_r, int stride_c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int last = 0;
  for (int i = 0; i < n; ++i) {
    // values are pixel ids >= 0, so last >> 31 is 0; the compiler cannot
    // know, and so each lookup's address waits for the lookup before it
    const int at =
        probe_position(i, per_row, stride_r, stride_c, W) + (last >> 31);
    const int v = x[at];  // hop 1
    last = x[v];          // hop 2: the value is a flat pixel id
    out[at] = last;
  }
}

__global__ void gather_parallel_kernel(const int* x, int* out, int W, int n,
                                       int per_row, int stride_r,
                                       int stride_c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int at = probe_position(i, per_row, stride_r, stride_c, W);
  out[at] = x[x[at]];
}

}  // namespace

extern "C" {

// x, out: (H, W) int32 with values in [0, H*W). With copy != 0 out = x first
// (the whole probe); then the n probe positions are overwritten (with
// copy == 0 out must hold the copy already: the lookups alone, which is
// what the probe times per lookup). chained != 0 picks the one-thread form.
// The lookup kernel is launched `repeats` times back to back (every launch
// writes the same values): timed from outside, a long run of launches reads
// the card's time per launch and not the caller's time per call.
// Returns a cudaError_t (0 on success).
int pk_scalar_gather_probe(const void* x, void* out, int H, int W, int n,
                           int per_row, int stride_r, int stride_c,
                           int chained, int copy, int repeats, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (n < 0 || per_row <= 0 || stride_r <= 0 || stride_c <= 0 || repeats < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* xi = static_cast<const int*>(x);
  int* oi = static_cast<int*>(out);
  if (copy) {
    const size_t pixels = (size_t)H * W;
    const size_t blocks = (pixels + 255) / 256;
    copy_plane_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        xi, oi, pixels);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0) return 0;
  for (int r = 0; r < repeats; ++r) {
    if (chained)
      gather_chained_kernel<<<1, 32, 0, s>>>(xi, oi, W, n, per_row, stride_r,
                                             stride_c);
    else
      gather_parallel_kernel<<<(n + 255) / 256, 256, 0, s>>>(
          xi, oi, W, n, per_row, stride_r, stride_c);
  }
  return (int)cudaGetLastError();
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
