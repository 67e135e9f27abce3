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
// Plain interface for ctypes; every launch returns its cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4;              // warps along the pixel dimension
constexpr int kWarpsN = 2;              // warps along the channel dimension
constexpr int kNC = 32;                 // output channels per chunk
constexpr int kChanPad = 32;            // padded channel counts are multiples
constexpr int kNI = kNC / 8 / kWarpsN;  // 8-wide mma tiles per warp along N (2)
constexpr int kMaxSmem = 232448;        // 227 KB opt-in limit of one block
static_assert(kNI == 2, "one ldmatrix.x4 loads the B fragments of two n-tiles");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf2f(const uint16_t* p, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage weights [n0, n0+32) x 9 taps x [k0, k0+KC) of a packed
// (Np, 9, Kp) bf16 tensor into ws[(n*9 + tap)*(KC+8) + k].
template <int KC>
__device__ __forceinline__ void load_w_chunk(uint16_t* ws, const uint16_t* wt,
                                             int n0, int k0, int Kp) {
  constexpr int PARTS = KC / 8;
  for (int i = threadIdx.x; i < kNC * 9 * PARTS; i += kThreads) {
    const int part = i % PARTS;
    const int row = i / PARTS;  // n * 9 + tap
    cp_async16(ws + row * (KC + 8) + part * 8,
               wt + ((size_t)n0 * 9 + row) * Kp + k0 + part * 8, true);
  }
}

// Stage channels [k0, k0+KC) of the (TH+4) x (TW+4) input halo tile whose
// top-left pixel is (y0, x0); pixels outside the image and channels past Cin
// read as zero.
template <int TH, int TW, int KC>
__device__ __forceinline__ void load_x_chunk(uint16_t* xs, const uint16_t* x,
                                             int b, int H, int W, int Cin,
                                             int y0, int x0, int k0) {
  constexpr int XW = TW + 4;
  constexpr int NPIX = (TH + 4) * XW;
  constexpr int PARTS = KC / 8;
  for (int i = threadIdx.x; i < NPIX * PARTS; i += kThreads) {
    const int part = i % PARTS;
    const int pix = i / PARTS;
    const int r = pix / XW;
    const int c = pix - r * XW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    const int ch = k0 + part * 8;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin;
    const uint16_t* src =
        inside ? x + (((size_t)b * H + gy) * W + gx) * Cin + ch : x;
    uint16_t* dst = xs + pix * (KC + 8) + part * 8;
    if ((Cin & 7) == 0) {
      cp_async16(dst, src, inside);
    } else {  // unaligned channel count: synchronous, element by element
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = (inside && ch + j < Cin) ? src[j] : 0;
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
          e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
    }
  }
}

template <int TH, int TW, int KC>
struct Geometry {
  static constexpr int KS = KC + 8;                       // padded chunk row (bf16):
                                                          // conflict-free ldmatrix
  static constexpr int IW = TW + 2;                       // intermediate tile width
  static constexpr int P1 = (TH + 2) * IW;                // intermediate pixels
  static constexpr int MT1 = (P1 + 15) / 16;              // their 16-row mma tiles
  static constexpr int MI1 = (MT1 + kWarpsM - 1) / kWarpsM;
  static constexpr int XW = TW + 4;                       // input halo tile width
  static constexpr int XPIX = (TH + 4) * XW;
  static constexpr int XS = XPIX * KS;                    // one staged input chunk
  static constexpr int WS = kNC * 9 * KS;                 // one staged weight chunk
  static constexpr int P2 = TH * TW;                      // output pixels
  static constexpr int MT2 = P2 / 16;
  static constexpr int MI2 = (MT2 + kWarpsM - 1) / kWarpsM;
  static_assert(P2 % 16 == 0, "output tile must hold whole mma row tiles");

  static size_t smem_bytes(int cmid_p) {
    return 2 * ((size_t)MT1 * 16 * (cmid_p + 8) + 2 * (size_t)XS + 2 * (size_t)WS);
  }
};

// Multiply one staged chunk: for each of the 9 taps and each 16-channel
// step, acc[i][j] += A(rows of m-tile i) * B(n-tile j). a_off[i] is the
// byte offset of this lane's ldmatrix row in the A buffer; a pixel row
// takes a_row_bytes and the A grid is a_tap_rows pixels wide, so tap
// (dy, dx) sits (dy * a_tap_rows + dx) rows further on.
template <int MI, int MT, int KC>
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][kNI][4],
                                          uint32_t a_base, const int (&a_off)[MI],
                                          int a_row_bytes, int a_tap_rows,
                                          uint32_t b_base, int wm) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int a_tap = ((tap / 3) * a_tap_rows + (tap % 3)) * a_row_bytes;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t b[4];
      ldsm_x4(b, b_base + (tap * (KC + 8) + kk) * 2);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (wm + kWarpsM * i >= MT) continue;  // warp-uniform
        uint32_t a[4];
        ldsm_x4(a, a_base + a_off[i] + a_tap + kk * 2);
        mma_bf16(acc[i][0], a, b[0], b[1]);
        mma_bf16(acc[i][1], a, b[2], b[3]);
      }
    }
  }
}

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
  using G = Geometry<TH, TW, KC>;
  extern __shared__ uint4 smem_u4[];
  const int IS = Cmid_p + 8;  // intermediate row stride (bf16)
  uint16_t* inter = reinterpret_cast<uint16_t*>(smem_u4);
  uint16_t* xs = inter + G::MT1 * 16 * IS;  // two input chunk buffers
  uint16_t* ws = xs + 2 * G::XS;            // two weight chunk buffers

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const int ty0 = ty * TH;
  const int tx0 = tx * TW;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma C fragment: row within an 8-row half
  const int q4 = lane & 3;  // mma C fragment: column pair
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  // ldmatrix.x4 row providers: A rows (lane&7) + 8*bit3, k offset 8*bit4;
  // B rows n = (lane&7) + 8*bit4 of the warp's 16 columns, k offset 8*bit3
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_k = (lane >> 4) << 3;
  const int b_n = wn * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) << 3;
  const int b_off = (b_n * 9 * G::KS + b_k) * 2;

  // ---- phase 1: conv1 over the tile plus its 1-px ring -> inter (bf16) ----
  int a1[G::MI1];  // byte offset of this lane's A row in an input chunk
#pragma unroll
  for (int i = 0; i < G::MI1; ++i) {
    int q = (wm + kWarpsM * i) * 16 + a_row;
    q = q < G::P1 ? q : G::P1 - 1;  // padding rows read a valid pixel
    const int r = q / G::IW;
    a1[i] = ((r * G::XW + q - r * G::IW) * G::KS + a_k) * 2;
  }
  const int kch1 = Cin_p / KC;
  const int n1 = (Cmid_p / kNC) * kch1;
  float acc1[G::MI1][kNI][4];
  load_x_chunk<TH, TW, KC>(xs, x, b, H, W, Cin, ty0 - 2, tx0 - 2, 0);
  load_w_chunk<KC>(ws, w1t, 0, 0, Cin_p);
  cp_async_commit();
  for (int c = 0; c < n1; ++c) {
    const int n0 = (c / kch1) * kNC;
    const int kc = c % kch1;
    if (c + 1 < n1) {
      const int nb = (c + 1) & 1;
      load_x_chunk<TH, TW, KC>(xs + nb * G::XS, x, b, H, W, Cin, ty0 - 2,
                               tx0 - 2, ((c + 1) % kch1) * KC);
      load_w_chunk<KC>(ws + nb * G::WS, w1t, ((c + 1) / kch1) * kNC,
                       ((c + 1) % kch1) * KC, Cin_p);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < G::MI1; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;
    }
    mma_chunk<G::MI1, G::MT1, KC>(acc1, smem_u32(xs + (c & 1) * G::XS), a1,
                                  G::KS * 2, G::XW,
                                  smem_u32(ws + (c & 1) * G::WS) + b_off, wm);
    if (kc == kch1 - 1) {
      // epilogue: scale/shift + ReLU, round to bf16, zero outside the image
#pragma unroll
      for (int i = 0; i < G::MI1; ++i) {
        const int mt = wm + kWarpsM * i;
        if (mt >= G::MT1) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mt * 16 + g + 8 * h;
          const int r = q / G::IW;
          const int gy = ty0 - 1 + r;
          const int gx = tx0 - 1 + q - r * G::IW;
          const bool inside = q < G::P1 && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int n = n0 + (wn * kNI + j) * 8 + 2 * q4;
            float v0 = fmaxf(acc1[i][j][2 * h] * bf2f(s1, n) + bf2f(b1, n), 0.f);
            float v1 = fmaxf(acc1[i][j][2 * h + 1] * bf2f(s1, n + 1) + bf2f(b1, n + 1), 0.f);
            if (!inside) v0 = v1 = 0.f;
            *reinterpret_cast<__nv_bfloat162*>(inter + q * IS + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks from now
  }

  // ---- phase 2: conv2 over inter -> output tile (bf16, device memory) ----
  int a2[G::MI2];  // byte offset of this lane's A row in inter
#pragma unroll
  for (int i = 0; i < G::MI2; ++i) {
    const int o = (wm + kWarpsM * i) * 16 + a_row;
    const int r = o / TW;
    a2[i] = ((r * G::IW + o - r * TW) * IS + a_k) * 2;
  }
  const uint32_t inter_base = smem_u32(inter);
  const int kch2 = Cmid_p / KC;
  const int n2 = (Cout_p / kNC) * kch2;
  float acc2[G::MI2][kNI][4];
  load_w_chunk<KC>(ws, w2t, 0, 0, Cmid_p);
  cp_async_commit();
  for (int c = 0; c < n2; ++c) {
    const int n0 = (c / kch2) * kNC;
    const int kc = c % kch2;
    if (c + 1 < n2)
      load_w_chunk<KC>(ws + ((c + 1) & 1) * G::WS, w2t, ((c + 1) / kch2) * kNC,
                       ((c + 1) % kch2) * KC, Cmid_p);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < G::MI2; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
    }
    mma_chunk<G::MI2, G::MT2, KC>(acc2, inter_base + kc * KC * 2, a2, IS * 2,
                                  G::IW, smem_u32(ws + (c & 1) * G::WS) + b_off,
                                  wm);
    if (kc == kch2 - 1) {
#pragma unroll
      for (int i = 0; i < G::MI2; ++i) {
        const int mt = wm + kWarpsM * i;
        if (mt >= G::MT2) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = mt * 16 + g + 8 * h;
          const int gy = ty0 + o / TW;
          const int gx = tx0 + o % TW;
          if (gy >= H || gx >= W) continue;
          uint16_t* dst = out + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int n = n0 + (wn * kNI + j) * 8 + 2 * q4;
            if (n >= Cout) continue;
            const float v0 = fmaxf(acc2[i][j][2 * h] * bf2f(s2, n) + bf2f(b2, n), 0.f);
            const float v1 = fmaxf(acc2[i][j][2 * h + 1] * bf2f(s2, n + 1) + bf2f(b2, n + 1), 0.f);
            if (n + 1 < Cout && (Cout & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
            } else {
              reinterpret_cast<__nv_bfloat16*>(dst)[n] = __float2bfloat16_rn(v0);
              if (n + 1 < Cout)
                reinterpret_cast<__nv_bfloat16*>(dst)[n + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int TH, int TW, int KC>
int launch(const void* x, const void* w1t, const void* s1, const void* b1,
           const void* w2t, const void* s2, const void* b2, void* out, int B,
           int H, int W, int Cin, int Cin_p, int Cmid_p, int Cout, int Cout_p,
           cudaStream_t stream) {
  const size_t smem = Geometry<TH, TW, KC>::smem_bytes(Cmid_p);
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
  // 16x16 tiles while the intermediate is small. Above, 8x8 tiles; at
  // Cmid 256 16-channel chunks keep two blocks on an SM, at Cmid 512 one
  // block fits either way and 32-channel chunks halve the barriers (each
  // choice measured the faster on an H100 80GB HBM3 at 700 W, PERF.md).
  if (Cmid_p <= 128)
    return launch<16, 16, 32>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin,
                              Cin_p, Cmid_p, Cout, Cout_p, s);
  if (Cmid_p <= 256)
    return launch<8, 8, 16>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin,
                            Cin_p, Cmid_p, Cout, Cout_p, s);
  return launch<8, 8, 32>(x, w1t, s1, b1, w2t, s2, b2, out, B, H, W, Cin, Cin_p,
                          Cmid_p, Cout, Cout_p, s);
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
