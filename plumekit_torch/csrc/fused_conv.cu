// One 3x3 SAME conv + per-channel scale/shift + ReLU for Hopper (sm_90a):
//   y = relu(conv3x3(x, w) * s + b)
// NHWC bf16 activations, bf16 weights / scale / shift, fp32 accumulation.
//
// Replaces the Pallas TPU kernel plumekit/models/pallas/fused_conv.py
// fused_conv3x3_bn_relu (:259, pallas_call :292); same function, not the
// same blocking. The TPU entry falls back to XLA unless the channel counts
// are multiples of 128 (a lane rule of that chip); here every shape takes
// the kernel, with channels padded to 32.
//
// Design: the first phase of the fused double conv on its own
// (conv_from_global of conv_tiles.cuh with no ring): one thread block owns a
// 16 x 16 output tile of one image and every output channel, stages the
// 18 x 18 input patch and the weights 32 channels at a time by cp.async, two
// buffers deep, multiplies on the tensor cores (mma.sync.m16n8k16, bf16 in,
// fp32 accumulate) and writes the tile to device memory once.
//
// What bounds it on an H100: 2*9*Cin*Cout flops per pixel against
// (Cin + Cout) * 2 bytes; above Cin = Cout = 64 or so the arithmetic, below
// it the activation bytes. Every output-channel chunk re-stages the input
// patch from L2, so wide layers pay that again Cout/32 times.
// Plain interface for ctypes; the launch returns its cudaError_t.

#include "conv_tiles.cuh"

namespace {

using namespace pk;

constexpr int kTile = 16;
constexpr int kKC = 32;
using G = ConvGeom<kTile, kTile, kKC, 0>;
constexpr size_t kSmem = 2 * (2 * (size_t)G::XS + 2 * (size_t)G::WS);

__global__ void __launch_bounds__(kThreads)
fused_conv_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ wt,
                  const uint16_t* __restrict__ sc,
                  const uint16_t* __restrict__ sh, uint16_t* __restrict__ out,
                  int H, int W, int Cin, int Cin_p, int Cout, int Cout_p) {
  extern __shared__ uint4 smem_u4[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem_u4);
  uint16_t* ws = xs + 2 * G::XS;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0};
  conv_from_global<kTile, kTile, kKC, 0>(xs, ws, src, wt, sc, sh, Cin_p, Cout_p,
                                         b, H, W, ty * kTile, tx * kTile,
                                         nullptr, 0, out, Cout);
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) bf16; wt: (Cout_p, 9, Cin_p) bf16; sc, sh: (Cout_p,);
// out: (B, H, W, Cout) bf16. Padded channel counts are multiples of 32 and
// their padding is zero. Returns a cudaError_t (0 on success).
int pk_fused_conv3x3_bn_relu(const void* x, const void* wt, const void* sc,
                             const void* sh, void* out, int B, int H, int W,
                             int Cin, int Cin_p, int Cout, int Cout_p,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (Cin_p % kChanPad || Cout_p % kChanPad || Cin > Cin_p || Cout > Cout_p ||
      Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((H + kTile - 1) / kTile) *
                           ((W + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_conv_kernel<<<(unsigned)blocks, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wt),
      static_cast<const uint16_t*>(sc), static_cast<const uint16_t*>(sh),
      static_cast<uint16_t*>(out), H, W, Cin, Cin_p, Cout, Cout_p);
  return (int)cudaGetLastError();
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
