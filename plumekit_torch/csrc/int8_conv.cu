// Q1: one 3x3 SAME conv in int8 with the int8 forward's fused epilogue, for
// Hopper (sm_90a):
//   acc = conv3x3(x, w)                    s8 x s8 -> s32, exact
//   y   = relu(float(acc) * a + b)     a: conv x BN scale, b: BN shift
//   out = clamp(rint(y / s), -127, 127) int8, or y itself in fp32
// NHWC int8 activations, weights packed from HWIO int8, a and b per output
// channel in fp32, s one fp32 scale read from device memory.
//
// Replaces no Pallas kernel: the JAX package's int8 forward
// (plumekit/models/quantized_forward.py) leaves its convolutions to XLA
// (_qconv, :133, lax.conv_general_dilated with preferred_element_type=int32),
// which the TPU runs on its native int8 path. PyTorch has no int8
// convolution on CUDA; the plain version (models/kernels/int8_conv.py) is
// nine shifted copies of the input through torch._int_mm.
//
// What bounds it on an H100: 2 * 9 * Cin * Cout integer operations per pixel
// against Cin + Cout bytes (4 * Cout for fp32 out); the ridge of 1,979 TOPS
// over 3.35 TB/s is about 590 operations per byte. Of the U-Net's convs at
// 288² tiles those of the two 288² levels (Cin = 2, 32 -> 32, the concat
// 64 -> 32, the fp32 last) and the 32 -> 64 and 64 -> 64 ones at 144² (384
// and 576 per byte) are bound by their bytes; the 144² concat (128 -> 64,
// 768 per byte) and every conv from 72² down by their operations.
//
// Design: an implicit GEMM on the skeleton of the mma.sync path of
// conv_tiles.cuh (rows are the pixels of one T x T output tile, T = 16 or
// 8, columns 32 output channels per block, the reduction over taps x input
// channels), with int8 operands:
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: one k step is 32
//     input channels, so input channels are padded to multiples of 32 and a
//     staged chunk of the input patch is 32 bytes per pixel (48 with the
//     padding that keeps ldmatrix free of bank conflicts). The s8 fragments
//     of m16n8k32 lie byte for byte where the bf16 fragments of m16n8k16 do,
//     so ldmatrix.b16 loads them as the bf16 path does;
//   * operands staged by cp.async, two chunks deep; 8 warps, 4 along the
//     pixels and 2 along the 32 channels;
//   * the input may come from two planes (a decoder block's concat of the
//     skip and the upsampled half): padded channels [0, C0p) from x0, the
//     rest from x1, so the concat is never written;
//   * the epilogue rounds as the plain version does, step by step (no FMA
//     contraction): __fmul_rn, __fadd_rn, __fdiv_rn by the scale, rintf
//     (half to even, as torch.round), so the two agree bit for bit.
// A wgmma m64nNk32 s8 version with TMA and the weight ring of conv_tiles.cuh
// is later work. Plain interface for ctypes; the launch returns its
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4;         // warps along the pixels
constexpr int kNC = 32;            // output channels per block
constexpr int kKC = 32;            // input channels per chunk (a k step)
constexpr int kKS = kKC + 16;      // bytes per staged row: no bank conflicts

template <int T>
struct Geom {
  static constexpr int P = T * T;                       // output pixels
  static constexpr int MT = P / 16;                     // 16-row mma tiles
  static constexpr int MI = (MT + kWarpsM - 1) / kWarpsM;  // per warp
  static constexpr int XW = T + 2;                      // input patch side
  static constexpr int XS = XW * XW * kKS;              // staged input chunk
  static constexpr int WS = kNC * 9 * kKS;              // staged weights
  static constexpr int SMEM = 2 * (XS + WS);
  static_assert(MT % kWarpsM == 0, "every warp owns whole mma row tiles");
};

// Where the conv reads its input channels: padded channels [0, c0p) from the
// (B, H, W, c0) plane p0, from c0p on from the (B, H, W, c1) plane p1.
struct Src {
  const int8_t* p0;
  const int8_t* p1;
  int c0, c0p, c1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the most recently committed group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage padded channels [k0, k0 + 32) of the XW x XW input patch whose
// top-left pixel is (y0, x0) into xs[pixel * kKS + k]; pixels outside the
// image and channels past the source's count read as zero.
template <int XW>
__device__ __forceinline__ void load_x(uint8_t* xs, const Src& src, int b,
                                       int H, int W, int y0, int x0, int k0) {
  const bool second = k0 >= src.c0p;
  const int8_t* plane = second ? src.p1 : src.p0;
  const int C = second ? src.c1 : src.c0;
  const int kb = second ? k0 - src.c0p : k0;
  for (int i = threadIdx.x; i < XW * XW * 2; i += kThreads) {
    const int part = i & 1;
    const int pix = i >> 1;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    const int ch = kb + part * 16;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < C;
    const int8_t* p =
        inside ? plane + (((size_t)b * H + gy) * W + gx) * C + ch : plane;
    uint8_t* dst = xs + pix * kKS + part * 16;
    if ((C & 15) == 0) {
      cp_async16(dst, p, inside);
    } else {  // unaligned channel count (the input conv): byte by byte
      uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (inside && ch + j < C)
          e[j >> 2] |= uint32_t(uint8_t(p[j])) << (8 * (j & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(e[0], e[1], e[2], e[3]);
    }
  }
}

// Stage the weights of output channels [n0, n0 + 32), every tap, input
// channels [k0, k0 + 32) of the packed (Np, 9, Kp) int8 tensor into
// ws[(n * 9 + tap) * kKS + k].
__device__ __forceinline__ void load_w(uint8_t* ws, const int8_t* wt, int n0,
                                       int k0, int Kp) {
  for (int i = threadIdx.x; i < kNC * 9 * 2; i += kThreads) {
    const int part = i & 1;
    const int row = i >> 1;  // n * 9 + tap
    cp_async16(ws + row * kKS + part * 16,
               wt + ((size_t)n0 * 9 + row) * Kp + k0 + part * 16, true);
  }
}

// y = relu(acc * a + b), rounded step by step as the plain version rounds
__device__ __forceinline__ float epilogue(int acc, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), 0.f);
}

__device__ __forceinline__ int8_t quantize(float y, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// blockIdx.x: (image, tile row, tile column, 32-channel chunk of the
// output), the chunk fastest, so that the blocks of one tile run together
// and read its input from L2.
template <int T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Src src, const int8_t* __restrict__ wt,
                 const float* __restrict__ a, const float* __restrict__ bsh,
                 const float* __restrict__ s_out, int8_t* __restrict__ out8,
                 float* __restrict__ out32, int H, int W, int Kp, int Cout,
                 int n_chunks) {
  using G = Geom<T>;
  extern __shared__ uint4 smem_u4[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(smem_u4);
  uint8_t* ws = xs + 2 * G::XS;
  const int tiles_x = (W + T - 1) / T;
  const int tiles_y = (H + T - 1) / T;
  int t = blockIdx.x;
  const int n0 = (t % n_chunks) * kNC;
  t /= n_chunks;
  const int tx0 = (t % tiles_x) * T;
  t /= tiles_x;
  const int ty0 = (t % tiles_y) * T;
  const int b = t / tiles_y;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  // ldmatrix.x4 row providers: A rows (lane & 7) + 8 * bit3 at byte 16 *
  // bit4; B rows (output channels) wn * 16 + (lane & 7) + 8 * bit4 at byte
  // 16 * bit3
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_k = (lane >> 4) << 4;
  const int b_n = wn * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) << 4;
  int a_off[G::MI];  // byte offset of this lane's A row in a staged chunk
#pragma unroll
  for (int i = 0; i < G::MI; ++i) {
    const int q = (wm + kWarpsM * i) * 16 + a_row;
    const int r = q / T;
    a_off[i] = (r * G::XW + q - r * T) * kKS + a_k;
  }
  const int b_off = b_n * 9 * kKS + b_k;

  int acc[G::MI][2][4];
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_k = Kp / kKC;
  load_x<G::XW>(xs, src, b, H, W, ty0 - 1, tx0 - 1, 0);
  load_w(ws, wt, n0, 0, Kp);
  cp_async_commit();
  for (int kc = 0; kc < n_k; ++kc) {
    if (kc + 1 < n_k) {
      const int nb = (kc + 1) & 1;
      load_x<G::XW>(xs + nb * G::XS, src, b, H, W, ty0 - 1, tx0 - 1,
                    (kc + 1) * kKC);
      load_w(ws + nb * G::WS, wt, n0, (kc + 1) * kKC, Kp);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const uint32_t xa = smem_u32(xs + (kc & 1) * G::XS);
    const uint32_t wa = smem_u32(ws + (kc & 1) * G::WS) + b_off;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int a_tap = ((tap / 3) * G::XW + tap % 3) * kKS;
      uint32_t bf[4];
      ldsm_x4(bf, wa + tap * kKS);
#pragma unroll
      for (int i = 0; i < G::MI; ++i) {
        uint32_t af[4];
        ldsm_x4(af, xa + a_off[i] + a_tap);
        mma_s8(acc[i][0], af, bf[0], bf[1]);
        mma_s8(acc[i][1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two chunks from now
  }

  // epilogue: C fragment rows g and g + 8, columns 2 * q4 and 2 * q4 + 1 of
  // each 8-wide n tile
  const int g = lane >> 2;
  const int q4 = lane & 3;
  const float s = s_out != nullptr ? *s_out : 1.f;
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < G::MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (wm + kWarpsM * i) * 16 + g + 8 * h;
      const int r = q / T;
      const int gy = ty0 + r;
      const int gx = tx0 + q - r * T;
      if (gy >= H || gx >= W) continue;
      const size_t pix = (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + (wn * 2 + j) * 8 + 2 * q4;
        if (n >= Cout) continue;
        // a and b are padded to the 32-channel chunk: n + 1 is readable
        const float v0 = epilogue(acc[i][j][2 * h], a[n], bsh[n]);
        const float v1 = epilogue(acc[i][j][2 * h + 1], a[n + 1], bsh[n + 1]);
        if (out8 != nullptr) {
          const int8_t q0 = quantize(v0, s), q1 = quantize(v1, s);
          if (pairs) {
            *reinterpret_cast<char2*>(out8 + pix + n) = make_char2(q0, q1);
          } else {
            out8[pix + n] = q0;
            if (n + 1 < Cout) out8[pix + n + 1] = q1;
          }
        } else if (pairs) {
          *reinterpret_cast<float2*>(out32 + pix + n) = make_float2(v0, v1);
        } else {
          out32[pix + n] = v0;
          if (n + 1 < Cout) out32[pix + n + 1] = v1;
        }
      }
    }
  }
}

template <int T>
int launch(const Src& src, const int8_t* wt, const float* a, const float* bsh,
           const float* s_out, int8_t* out8, float* out32, int B, int H,
           int W, int Kp, int Cout, int n_chunks, cudaStream_t stream) {
  using G = Geom<T>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((H + T - 1) / T) *
                           ((W + T - 1) / T) * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_conv_kernel<T><<<(unsigned)blocks, kThreads, G::SMEM, stream>>>(
      src, wt, a, bsh, s_out, out8, out32, H, W, Kp, Cout, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x0: (B, H, W, C0) int8; x1: (B, H, W, C1) int8 or null (C1 = 0); wt:
// (Np, 9, Kp) int8, input channel k < C0p from x0 and C0p + k from x1, zero
// in every padding; a, bsh: (Np,) fp32, zero padded; s_out: one fp32 scale
// on the device, or null for fp32 output. out: (B, H, W, Cout), int8 when
// s_out is given, else fp32. C0p and Kp are multiples of 32, Np of 32; tile
// is 16 or 8. A channel count that is a multiple of 16 is read 16 bytes at a
// time and its plane must be 16-byte aligned. Returns a cudaError_t.
int pk_int8_conv3x3(const void* x0, const void* x1, const void* wt,
                    const void* a, const void* bsh, const void* s_out,
                    void* out, int B, int H, int W, int C0, int C0p, int C1,
                    int Kp, int Cout, int Np, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C0 <= 0 || C0 > C0p || C0p % kKC || Kp % kKC || Kp < C0p ||
      C1 < 0 || C1 > Kp - C0p || (C1 > 0) != (x1 != nullptr) || Cout <= 0 ||
      Cout > Np || Np % kNC)
    return (int)cudaErrorInvalidValue;
  const Src src{static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1),
                C0, C0p, C1};
  int8_t* out8 = s_out != nullptr ? static_cast<int8_t*>(out) : nullptr;
  float* out32 = s_out != nullptr ? nullptr : static_cast<float*>(out);
  const auto w8 = static_cast<const int8_t*>(wt);
  const auto fa = static_cast<const float*>(a);
  const auto fb = static_cast<const float*>(bsh);
  const auto fs = static_cast<const float*>(s_out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile == 16)
    return launch<16>(src, w8, fa, fb, fs, out8, out32, B, H, W, Kp, Cout,
                      Np / kNC, st);
  if (tile == 8)
    return launch<8>(src, w8, fa, fb, fs, out8, out32, B, H, W, Kp, Cout,
                     Np / kNC, st);
  return (int)cudaErrorInvalidValue;
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
