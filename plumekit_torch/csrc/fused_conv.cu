// One 3x3 SAME conv + per-channel scale/shift + ReLU for Hopper (sm_90a):
//   y = relu(conv3x3(x, w) * s + b)
// NHWC bf16 activations, bf16 weights / scale / shift, fp32 accumulation.
//
// Replaces the Pallas TPU kernel plumekit/models/pallas/fused_conv.py
// fused_conv3x3_bn_relu (:259, pallas_call :292); same function, not the
// same blocking. The TPU entry falls back to XLA unless the channel counts
// are multiples of 128 (a lane rule of that chip); here every shape takes
// a kernel.
//
// What bounds it on an H100: 2*9*Cin*Cout flops per pixel against
// (Cin + Cout) * 2 bytes; above Cin = Cout = 64 or so the arithmetic, below
// it the activation bytes. A wide conv on a small plane is bound by how
// often its weights are re-read: at 512 -> 512 they are 4.7 MB against 36
// pixels per image.
//
// Design (device code in conv_tiles.cuh; the tile, the images per block and
// the path come from plumekit_torch/models/kernels/conv_tiles.py):
//   * more than 64 output channels: the wgmma path. A block takes one pass
//     of 128 output channels over a TH x TW tile of each of G images; the
//     rows of its GEMM run over the padded raster of the staged input patch
//     (up to 256 rows), the pass's weights stream through the copy engine
//     once for all G images, and the passes of a tile are separate blocks,
//     so a 6 x 6 plane at 512 channels still fills the card;
//   * up to 64 output channels: the mma.sync path, one block per 16 x 16
//     tile of one image, every output channel, 32 at a time.
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
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0, 1};
  conv_from_global<kTile, kTile, kKC, 0>(xs, ws, src, wt, sc, sh, Cin_p, Cout_p,
                                         b, H, W, ty * kTile, tx * kTile,
                                         nullptr, 0, out, Cout);
}

// blockIdx.x: (image group, tile row, tile column, pass), the pass fastest
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_wg_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ wstream,
                     const uint16_t* __restrict__ sc,
                     const uint16_t* __restrict__ sh,
                     uint16_t* __restrict__ out, int B, int H, int W, int Cin,
                     int Cin_p, int Cout, int n_pass, WgTile tile) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  WgPipe pipe = wg_pipe_init(smem);
  const int tiles_x = (W + tile.tw - 1) / tile.tw;
  const int tiles_y = (H + tile.th - 1) / tile.th;
  int t = blockIdx.x;
  const int pass = t % n_pass;
  t /= n_pass;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int group = t / tiles_y;
  const ConvSrc src{x, nullptr, Cin, Cin_p, 0, 1};
  wg_single_conv_item(smem, pipe, src, wstream, sc, sh, Cin_p, Cout, B, H, W,
                      group * tile.g, ty * tile.th, tx * tile.tw, tile, pass,
                      out);
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) bf16; sc, sh: (Cout_p,); out: (B, H, W, Cout) bf16; the
// padding of every padded channel count is zero.
//   path 0 (mma.sync): wt (Cout_p, 9, Cin_p) bf16, channel counts padded to
//     32; th = tw = 16, g = 1.
//   path 1 (wgmma): wt the weight stream [Cout_p / 128][Cin_p / 32][9][4]
//     [128][8] bf16, Cin_p padded to 32, Cout_p to 128; th x tw tiles of g
//     images per block.
// Returns a cudaError_t (0 on success).
int pk_fused_conv3x3_bn_relu(const void* x, const void* wt, const void* sc,
                             const void* sh, void* out, int B, int H, int W,
                             int Cin, int Cin_p, int Cout, int Cout_p,
                             int path, int th, int tw, int g, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (Cin_p % kChanPad || Cin > Cin_p || Cout > Cout_p || Cin <= 0 ||
      Cout <= 0 || th <= 0 || tw <= 0 || g <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((H + th - 1) / th) * ((W + tw - 1) / tw);
  if (path == 1) {
    const WgTile tile{th, tw, g};
    const WgGeom gm(tile, 0, 0);
    if (Cout_p % kWgN || !gm.fits(false)) return (int)cudaErrorInvalidValue;
    const size_t smem = gm.smem_bytes(false);
    cudaError_t err = cudaFuncSetAttribute(
        fused_conv_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_pass = Cout_p / kWgN;
    const long long blocks = (long long)((B + g - 1) / g) * tiles * n_pass;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fused_conv_wg_kernel<<<(unsigned)blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wt),
        static_cast<const uint16_t*>(sc), static_cast<const uint16_t*>(sh),
        static_cast<uint16_t*>(out), B, H, W, Cin, Cin_p, Cout, n_pass, tile);
    return (int)cudaGetLastError();
  }
  if (path != 0 || Cout_p % kChanPad || th != kTile || tw != kTile || g != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * tiles;
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
