// Fused U-Net double-conv block for Hopper (sm_90a):
//   y = relu(conv3x3(relu(conv3x3(x, w1) * s1 + b1) -> bf16, w2) * s2 + b2)
// NHWC bf16 activations, bf16 weights / scales / shifts, fp32 accumulation,
// SAME padding on both convs.
//
// Replaces the Pallas TPU kernel plumekit/models/pallas/fused_conv.py
// fused_double_conv3x3_bn_relu (:180, pallas_call :216); same function,
// not the same blocking (see fused_conv.py:139-176 for the semantics).
//
// The conv1 output never leaves the chip: a block computes conv1 +
// scale/shift + ReLU over its tile plus a 1-px ring, rounds it to bf16 and
// keeps it in shared memory for all Cmid channels, with the ring outside the
// true image zeroed (the SAME-chaining rule of fused_conv.py:150-164); conv2
// reads that tile and writes the output to device memory once.
//
// What bounds it on an H100: the block's arithmetic (2*9*(Cin*Cmid +
// Cmid*Cout) flops per pixel) far exceeds its activation traffic ((Cin +
// Cout) * 2 bytes per pixel), so the tensor cores should be the limit. What
// keeps a kernel from it is operand re-reading: every block streams all of
// w1 and w2 from L2 (3.5 MB at 512 -> 256 -> 256), the ring tile is a
// kilobyte per pixel at Cmid 512 and caps the pixels a block can hold, and
// the ring adds conv1 rows that are computed for no output.
//
// Design (device code in conv_tiles.cuh; the tile, the images per block and
// the path come from plumekit_torch/models/kernels/conv_tiles.py):
//   * more than 64 mid channels: the wgmma path. Both convs run as passes of
//     128 output channels over up to 256 rows of the padded raster of their
//     input (the staged patch for conv1, the ring tile itself for conv2), an
//     input chunk staged once per pass, the weights through the copy engine
//     in the order they were packed. Tiles are picked to fill the plane and
//     the m64 rows (9 x 18 on 36 x 36 and 72 x 72, 6 x 18 on 18 x 18 at
//     Cmid 512, 12 x 12 on 24 x 24), and planes smaller than a block's rows
//     share a block between images (two 6 x 6 images at Cmid 512);
//   * up to 64 mid channels: the mma.sync path on 16 x 16 tiles, as it was:
//     there the activations are the traffic and it beats cuDNN.
// Plain interface for ctypes; every launch returns its cudaError_t.

#include "conv_tiles.cuh"

namespace {

using namespace pk;

constexpr int kTile = 16;
constexpr int kKC = 32;

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
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0, 1};
  const DoubleConvWeights w{w1t, s1, b1, w2t, s2, b2, Cin_p, Cmid_p, Cout, Cout_p};
  double_conv_tile<kTile, kTile, kKC, false>(
      reinterpret_cast<uint16_t*>(smem_u4), src, w, b, H, W, ty * kTile,
      tx * kTile, out, HeadArgs{});
}

// blockIdx.x: (image group, tile row, tile column)
__global__ void __launch_bounds__(kThreads, 1)
fused_double_conv_wg_kernel(const uint16_t* __restrict__ x,
                            const uint16_t* __restrict__ w1s,
                            const uint16_t* __restrict__ s1,
                            const uint16_t* __restrict__ b1,
                            const uint16_t* __restrict__ w2s,
                            const uint16_t* __restrict__ s2,
                            const uint16_t* __restrict__ b2,
                            uint16_t* __restrict__ out, int B, int H, int W,
                            int Cin, int Cin_p, int Cmid_p, int Cout,
                            int Cout_p, WgTile tile) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  WgPipe pipe = wg_pipe_init(smem);
  const int tiles_x = (W + tile.tw - 1) / tile.tw;
  const int tiles_y = (H + tile.th - 1) / tile.th;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int group = t / tiles_y;
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0, 1};
  const DoubleConvWeights w{w1s, s1, b1, w2s, s2, b2, Cin_p, Cmid_p, Cout, Cout_p};
  wg_double_conv_item<false>(smem, pipe, src, w, B, H, W, group * tile.g,
                             ty * tile.th, tx * tile.tw, tile, out,
                             HeadArgs{}, nullptr);
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) bf16; s1, b1: (Cmid_p,); s2, b2: (Cout_p,); out:
// (B, H, W, Cout) bf16; the padding of every padded channel count is zero.
//   path 0 (mma.sync): w1t (Cmid_p, 9, Cin_p), w2t (Cout_p, 9, Cmid_p) bf16,
//     channel counts padded to 32; th = tw = 16, g = 1.
//   path 1 (wgmma): w1t, w2t the weight streams [N_p / 128][K_p / 32][9][4]
//     [128][8] bf16, Cin_p padded to 32, Cmid_p and Cout_p to 128; th x tw
//     tiles of g images per block.
// Returns a cudaError_t (0 on success).
int pk_fused_double_conv3x3_bn_relu(const void* x, const void* w1t,
                                    const void* s1, const void* b1,
                                    const void* w2t, const void* s2,
                                    const void* b2, void* out, int B, int H,
                                    int W, int Cin, int Cin_p, int Cmid_p,
                                    int Cout, int Cout_p, int path, int th,
                                    int tw, int g, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (Cin_p % kChanPad || Cin > Cin_p || Cout > Cout_p || Cin <= 0 ||
      Cout <= 0 || th <= 0 || tw <= 0 || g <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles =
      (long long)((H + th - 1) / th) * ((W + tw - 1) / tw);
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  if (path == 1) {
    const WgTile tile{th, tw, g};
    const WgGeom gm(tile, 1, Cmid_p);
    if (Cmid_p % kWgN || Cout_p % kWgN || !gm.fits(false))
      return (int)cudaErrorInvalidValue;
    const size_t smem = gm.smem_bytes(false);
    cudaError_t err = cudaFuncSetAttribute(
        fused_double_conv_wg_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)((B + g - 1) / g) * tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fused_double_conv_wg_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
        u16(x), u16(w1t), u16(s1), u16(b1), u16(w2t), u16(s2), u16(b2),
        static_cast<uint16_t*>(out), B, H, W, Cin, Cin_p, Cmid_p, Cout, Cout_p,
        tile);
    return (int)cudaGetLastError();
  }
  if (path != 0 || Cmid_p % kChanPad || Cout_p % kChanPad || th != kTile ||
      tw != kTile || g != 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = DoubleConvSmem<kTile, kTile, kKC>::bytes(Cmid_p);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_double_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_double_conv_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      u16(x), u16(w1t), u16(s1), u16(b1), u16(w2t), u16(s2), u16(b2),
      static_cast<uint16_t*>(out), H, W, Cin, Cin_p, Cmid_p, Cout, Cout_p);
  return (int)cudaGetLastError();
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
