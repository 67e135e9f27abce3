// Fused U-Net double-conv block for Hopper (sm_90a):
//   y = relu(conv3x3(relu(conv3x3(x, w1) * s1 + b1) -> bf16, w2) * s2 + b2)
// NHWC bf16 activations, bf16 weights / scales / shifts, fp32 accumulation,
// SAME padding on both convs.
//
// Replaces the Pallas TPU kernel plumekit/models/pallas/fused_conv.py
// fused_double_conv3x3_bn_relu (:180, pallas_call :216); same function,
// not the same blocking (see fused_conv.py:139-176 for the semantics).
//
// Design: the conv1 output never leaves the chip.
//   * one thread block owns a TH x TW output tile of one image and every
//     output channel;
//   * phase 1 computes conv1 + scale/shift + ReLU over the (TH+2) x (TW+2)
//     tile-plus-halo, rounds it to bf16 and keeps it in shared memory for
//     all Cmid channels, with the ring outside the true image zeroed (the
//     SAME-chaining rule of fused_conv.py:150-164);
//   * phase 2 reads that tile for conv2 + scale/shift + ReLU and writes the
//     output tile to device memory once.
// Both phases are implicit GEMMs on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with fragments loaded by
// ldmatrix: rows are pixels, columns are output channels in chunks of 32,
// the reduction runs over 9 taps x KC-channel chunks staged in shared
// memory by cp.async, two buffers deep, so the next chunk's loads are in
// flight while the current one is multiplied.
//
// What bounds it on an H100: the block's arithmetic (2*9*(Cin*Cmid +
// Cmid*Cout) flops per pixel) far exceeds its activation traffic ((Cin +
// Cout) * 2 bytes per pixel), but every tile re-reads all of w1 and w2 from
// L2. With 16x16 tiles (Cmid <= 128) that is cheap and the tensor-core issue
// rate bounds it; with the 8x8 tiles that Cmid 256 and 512 force (the bf16
// intermediate alone is 112 x 520 x 2 B = 116 KB at Cmid 512) the weight
// stream from L2 bounds it, and the halo ring adds 56% to conv1.
// The two phases are device functions of conv_tiles.cuh, shared with the
// single conv (fused_conv.cu) and the whole-forward kernel (unet_mega.cu).
// Plain interface for ctypes; every launch returns its cudaError_t.

#include "conv_tiles.cuh"

namespace {

using namespace pk;

template <int TH, int TW, int KC>
__global__ void __launch_bounds__(kThreads)
fused_double_conv_kernel(const uint16_t* __restrict__ x,
                         const uint16_t* __restrict__ w1t,
                         const uint16_t* __restrict__ s1,
                         const uint16_t* __restrict__ b1,
                         const uint16_t* __restrict__ w2t,
                         const uint16_t* __restrict__ s2,
                         const uint16_t* __restrict__ b2,
                         uint16_t* __restrict__ out, int H, int W, int Cin,
                         int Cin_p, int Cmid_p, int Cout, int Cout_p) {
  extern __shared__ uint4 smem_u4[];
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0};
  const DoubleConvWeights w{w1t, s1, b1, w2t, s2, b2, Cin_p, Cmid_p, Cout, Cout_p};
  double_conv_tile<TH, TW, KC, false>(reinterpret_cast<uint16_t*>(smem_u4), src,
                                      w, b, H, W, ty * TH, tx * TW, out,
                                      HeadArgs{});
}

template <int TH, int TW, int KC>
int launch(const void* x, const void* w1t, const void* s1, const void* b1,
           const void* w2t, const void* s2, const void* b2, void* out, int B,
           int H, int W, int Cin, int Cin_p, int Cmid_p, int Cout, int Cout_p,
           cudaStream_t stream) {
  const size_t smem = DoubleConvSmem<TH, TW, KC>::bytes(Cmid_p);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_double_conv_kernel<TH, TW, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_double_conv_kernel<TH, TW, KC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1t),
      static_cast<const uint16_t*>(s1), static_cast<const uint16_t*>(b1),
      static_cast<const uint16_t*>(w2t), static_cast<const uint16_t*>(s2),
      static_cast<const uint16_t*>(b2), static_cast<uint16_t*>(out), H, W, Cin,
      Cin_p, Cmid_p, Cout, Cout_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) bf16; w1t: (Cmid_p, 9, Cin_p) bf16; s1, b1: (Cmid_p,);
// w2t: (Cout_p, 9, Cmid_p) bf16; s2, b2: (Cout_p,); out: (B, H, W, Cout).
// Padded channel counts are multiples of 32 and their padding is zero.
// Returns a cudaError_t (0 on success).
int pk_fused_double_conv3x3_bn_relu(const void* x, const void* w1t,
                                    const void* s1, const void* b1,
                                    const void* w2t, const void* s2,
                                    const void* b2, void* out, int B, int H,
                                    int W, int Cin, int Cin_p, int Cmid_p,
                                    int Cout, int Cout_p, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (Cin_p % kChanPad || Cmid_p % kChanPad || Cout_p % kChanPad || Cin > Cin_p ||
      Cout > Cout_p || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (double_conv_tile_for(Cmid_p)) {
    case kTile16Kc32:
      return launch<16, 16, 32>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin,
                                Cin_p, Cmid_p, Cout, Cout_p, s);
    case kTile8Kc16:
      return launch<8, 8, 16>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin,
                              Cin_p, Cmid_p, Cout, Cout_p, s);
    default:
      return launch<8, 8, 32>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin,
                              Cin_p, Cmid_p, Cout, Cout_p, s);
  }
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
