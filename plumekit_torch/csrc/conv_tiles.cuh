// Device code shared by the conv kernels of plumekit_torch for Hopper
// (sm_90a): the fused double conv (fused_double_conv.cu), the single conv
// (fused_conv.cu) and the whole-forward U-Net kernel (unet_mega.cu).
//
// One thread block of 256 threads owns a TH x TW output tile of one image
// and every output channel. A 3x3 SAME conv + per-channel scale/shift +
// ReLU is an implicit GEMM on the tensor cores through mma.sync.m16n8k16
// (bf16 in, fp32 accumulate) with fragments loaded by ldmatrix: rows are
// pixels, columns are output channels in chunks of 32, the reduction runs
// over the taps x KC-channel chunks staged in shared memory by cp.async,
// two buffers deep, so the next chunk's loads are in flight while the
// current one is multiplied.
//
//   conv_from_global<TH, TW, KC, R>  input patch staged from device memory;
//       output over the tile plus an R-px ring: R = 1 keeps it in shared
//       memory as bf16 with the ring outside the image zeroed (the first
//       conv of a double conv), R = 0 writes it to device memory.
//   conv_from_smem<TH, TW, KC, HEAD>  input read from that shared-memory
//       tile; output to device memory as bf16, or (HEAD) kept in fp32 and
//       multiplied by a 1x1 fp32 head whose logits are written instead.
//   double_conv_tile  the two chained: the first conv's output never leaves
//       the chip.
//
// Activations are read through cp.async.cg or plain loads, never through
// the read-only path: inside the whole-forward kernel one stage reads what
// the stage before it wrote.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pk {

constexpr int kThreads = 256;
constexpr int kWarpsM = 4;              // warps along the pixel dimension
constexpr int kWarpsN = 2;              // warps along the channel dimension
constexpr int kNC = 32;                 // output channels per chunk
constexpr int kChanPad = 32;            // padded channel counts are multiples
constexpr int kNI = kNC / 8 / kWarpsN;  // 8-wide mma tiles per warp along N (2)
constexpr int kMaxSmem = 232448;        // 227 KB opt-in limit of one block
constexpr int kHeadOut = 8;             // most logits per pixel of the 1x1 head
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

// Where a conv reads its input channels: padded channels [0, c0p) come from
// the (B, H, W, c0) plane p0, channels from c0p on from the (B, H, W, c1)
// plane p1 (the concat-free skip join of a U-Net decoder block). c0p is a
// multiple of 32; with one source p1 is null and c0p the whole padded depth.
struct ConvSrc {
  const uint16_t* p0;
  const uint16_t* p1;
  int c0, c0p, c1;
};

// This thread's place in the block's 4 x 2 warp grid and in the mma and
// ldmatrix fragments.
struct Lane {
  int g;      // mma C fragment: row within an 8-row half
  int q4;     // mma C fragment: column pair
  int wm;     // warp along the pixel dimension
  int wn;     // warp along the channel dimension
  int a_row;  // ldmatrix.x4 A row provider: (lane & 7) + 8 * bit3
  int a_k;    // its k offset: 8 * bit4
  int b_n;    // B row provider among the chunk's 32 columns
  int b_k;    // its k offset: 8 * bit3
  __device__ __forceinline__ Lane() {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    q4 = lane & 3;
    wm = warp % kWarpsM;
    wn = warp / kWarpsM;
    a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    a_k = (lane >> 4) << 3;
    b_n = wn * 16 + (lane & 7) + ((lane >> 4) << 3);
    b_k = ((lane >> 3) & 1) << 3;
  }
};

// Stage weights [n0, n0+32) x TAPS taps x [k0, k0+KC) of a packed
// (Np, TAPS, Kp) bf16 tensor into ws[(n*TAPS + tap)*(KC+8) + k].
template <int KC, int TAPS>
__device__ __forceinline__ void load_w_chunk(uint16_t* ws, const uint16_t* wt,
                                             int n0, int k0, int Kp) {
  constexpr int PARTS = KC / 8;
  for (int i = threadIdx.x; i < kNC * TAPS * PARTS; i += kThreads) {
    const int part = i % PARTS;
    const int row = i / PARTS;  // n * TAPS + tap
    cp_async16(ws + row * (KC + 8) + part * 8,
               wt + ((size_t)n0 * TAPS + row) * Kp + k0 + part * 8, true);
  }
}

// Stage padded channels [k0, k0+KC) of the PH x PW input patch whose
// top-left pixel is (y0, x0) into xs[pixel*(KC+8) + k]; pixels outside the
// image and channels past the source's count read as zero.
template <int PH, int PW, int KC>
__device__ __forceinline__ void load_x_chunk(uint16_t* xs, const ConvSrc& src,
                                             int b, int H, int W, int y0,
                                             int x0, int k0) {
  constexpr int NPIX = PH * PW;
  constexpr int PARTS = KC / 8;
  const bool second = k0 >= src.c0p;
  const uint16_t* plane = second ? src.p1 : src.p0;
  const int C = second ? src.c1 : src.c0;
  const int kb = second ? k0 - src.c0p : k0;
  for (int i = threadIdx.x; i < NPIX * PARTS; i += kThreads) {
    const int part = i % PARTS;
    const int pix = i / PARTS;
    const int r = pix / PW;
    const int c = pix - r * PW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    const int ch = kb + part * 8;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < C;
    const uint16_t* p =
        inside ? plane + (((size_t)b * H + gy) * W + gx) * C + ch : plane;
    uint16_t* dst = xs + pix * (KC + 8) + part * 8;
    if ((C & 7) == 0) {
      cp_async16(dst, p, inside);
    } else {  // unaligned channel count: synchronous, element by element
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = (inside && ch + j < C) ? p[j] : 0;
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
          e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
    }
  }
}

// Multiply one staged chunk: for each tap and each 16-channel step,
// acc[i][j] += A(rows of m-tile i) * B(n-tile j). a_off[i] is the byte
// offset of this lane's ldmatrix row in the A buffer; a pixel row takes
// a_row_bytes and the A grid is a_tap_rows pixels wide, so tap (dy, dx)
// sits (dy * a_tap_rows + dx) rows further on.
template <int MI, int MT, int KC, int TAPS>
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][kNI][4],
                                          uint32_t a_base, const int (&a_off)[MI],
                                          int a_row_bytes, int a_tap_rows,
                                          uint32_t b_base, int wm) {
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
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

template <int MI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][kNI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Two bf16 values (or one, where the channel count ends or is odd) to
// dst[n], dst[n + 1] of a pixel's C channels.
__device__ __forceinline__ void store_bf16_pair(uint16_t* dst, int n, int C,
                                                float v0, float v1) {
  if (n + 1 < C && (C & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
  } else {
    reinterpret_cast<__nv_bfloat16*>(dst)[n] = __float2bfloat16_rn(v0);
    if (n + 1 < C)
      reinterpret_cast<__nv_bfloat16*>(dst)[n + 1] = __float2bfloat16_rn(v1);
  }
}

// The shapes of a conv over a TH x TW tile plus an R-px ring.
template <int TH, int TW, int KC, int R>
struct ConvGeom {
  static constexpr int KS = KC + 8;            // padded chunk row (bf16):
                                               // conflict-free ldmatrix
  static constexpr int OH = TH + 2 * R;        // output rows
  static constexpr int OW = TW + 2 * R;        // output columns
  static constexpr int P = OH * OW;            // output pixels
  static constexpr int MT = (P + 15) / 16;     // their 16-row mma tiles
  static constexpr int MI = (MT + kWarpsM - 1) / kWarpsM;
  static constexpr int XH = OH + 2;            // input patch
  static constexpr int XW = OW + 2;
  static constexpr int XS = XH * XW * KS;      // one staged input chunk
  static constexpr int WS = kNC * 9 * KS;      // one staged weight chunk
};

// conv3x3 + scale/shift + ReLU over the tile at (ty0, tx0) plus its R-px
// ring, the input staged from device memory through xs (2 x XS) and ws
// (2 x WS). wt: (Np, 9, Kp) packed weights; sc, sh: (Np,).
//   R == 1: rounds to bf16 into inter[q * IS + n], q running over the
//           (TH+2) x (TW+2) ring tile, zero outside the image;
//   R == 0: writes out[b, gy, gx, n] for n < Cout.
template <int TH, int TW, int KC, int R>
__device__ __forceinline__ void conv_from_global(
    uint16_t* xs, uint16_t* ws, const ConvSrc& src, const uint16_t* wt,
    const uint16_t* sc, const uint16_t* sh, int Kp, int Np, int b, int H, int W,
    int ty0, int tx0, uint16_t* inter, int IS, uint16_t* out, int Cout) {
  using G = ConvGeom<TH, TW, KC, R>;
  const Lane ln;
  const int b_off = (ln.b_n * 9 * G::KS + ln.b_k) * 2;
  int a1[G::MI];  // byte offset of this lane's A row in an input chunk
#pragma unroll
  for (int i = 0; i < G::MI; ++i) {
    int q = (ln.wm + kWarpsM * i) * 16 + ln.a_row;
    q = q < G::P ? q : G::P - 1;  // padding rows read a valid pixel
    const int r = q / G::OW;
    a1[i] = ((r * G::XW + q - r * G::OW) * G::KS + ln.a_k) * 2;
  }
  const int kch = Kp / KC;
  const int n_chunks = (Np / kNC) * kch;
  const int y0 = ty0 - R - 1;
  const int x0 = tx0 - R - 1;
  float acc[G::MI][kNI][4];
  load_x_chunk<G::XH, G::XW, KC>(xs, src, b, H, W, y0, x0, 0);
  load_w_chunk<KC, 9>(ws, wt, 0, 0, Kp);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = (c / kch) * kNC;
    const int kc = c % kch;
    if (c + 1 < n_chunks) {
      const int nb = (c + 1) & 1;
      load_x_chunk<G::XH, G::XW, KC>(xs + nb * G::XS, src, b, H, W, y0, x0,
                                     ((c + 1) % kch) * KC);
      load_w_chunk<KC, 9>(ws + nb * G::WS, wt, ((c + 1) / kch) * kNC,
                          ((c + 1) % kch) * KC, Kp);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) zero_acc<G::MI>(acc);
    mma_chunk<G::MI, G::MT, KC, 9>(acc, smem_u32(xs + (c & 1) * G::XS), a1,
                                   G::KS * 2, G::XW,
                                   smem_u32(ws + (c & 1) * G::WS) + b_off,
                                   ln.wm);
    if (kc == kch - 1) {
      // epilogue: scale/shift + ReLU, round to bf16
#pragma unroll
      for (int i = 0; i < G::MI; ++i) {
        const int mt = ln.wm + kWarpsM * i;
        if (mt >= G::MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mt * 16 + ln.g + 8 * h;
          const int r = q / G::OW;
          const int gy = ty0 - R + r;
          const int gx = tx0 - R + q - r * G::OW;
          const bool inside =
              q < G::P && gy >= 0 && gy < H && gx >= 0 && gx < W;
          if (R == 0 && !inside) continue;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int n = n0 + (ln.wn * kNI + j) * 8 + 2 * ln.q4;
            float v0 = fmaxf(acc[i][j][2 * h] * bf2f(sc, n) + bf2f(sh, n), 0.f);
            float v1 = fmaxf(
                acc[i][j][2 * h + 1] * bf2f(sc, n + 1) + bf2f(sh, n + 1), 0.f);
            if (R == 1) {
              // the ring outside the true image is the next conv's padding
              if (!inside) v0 = v1 = 0.f;
              *reinterpret_cast<__nv_bfloat162*>(inter + q * IS + n) =
                  __floats2bfloat162_rn(v0, v1);
            } else if (n < Cout) {
              store_bf16_pair(out + (((size_t)b * H + gy) * W + gx) * Cout, n,
                              Cout, v0, v1);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two chunks from now
  }
}

// What conv_from_smem's HEAD form needs besides the conv: fp32 head weights
// (Cout_p, kHeadOut) and bias (kHeadOut,), zero padded; logits
// (B, H, W, n_out) fp32.
struct HeadArgs {
  const float* w;
  const float* b;
  float* logits;
  int n_out;
};

// conv3x3 + scale/shift + ReLU over the TH x TW tile at (ty0, tx0), reading
// the bf16 ring tile inter[(TH+2) x (TW+2)][IS] in shared memory; weights
// w2t: (Cout_p, 9, Cmid_p) staged through ws (2 x WS).
//   !HEAD: rounds to bf16 and writes out[b, gy, gx, n] for n < Cout;
//   HEAD:  keeps the result in fp32, passes it 32 channels at a time through
//          stash (TH*TW x 33 floats of shared memory) and writes
//          logits[b, gy, gx, :] = result @ head.w + head.b instead, each
//          pixel's sum taken by one thread in channel order.
template <int TH, int TW, int KC, bool HEAD>
__device__ __forceinline__ void conv_from_smem(
    const uint16_t* inter, int IS, uint16_t* ws, float* stash,
    const uint16_t* w2t, const uint16_t* s2, const uint16_t* b2, int Cmid_p,
    int Cout, int Cout_p, int b, int H, int W, int ty0, int tx0, uint16_t* out,
    const HeadArgs& head) {
  using G = ConvGeom<TH, TW, KC, 0>;
  constexpr int IW = TW + 2;  // ring tile width
  constexpr int SS = kNC + 1;  // stash row stride (floats): no bank conflicts
  static_assert(G::P % 16 == 0, "output tile must hold whole mma row tiles");
  static_assert(G::P <= kThreads, "one thread per pixel sums the head");
  const Lane ln;
  const int b_off = (ln.b_n * 9 * G::KS + ln.b_k) * 2;
  int a2[G::MI];  // byte offset of this lane's A row in inter
#pragma unroll
  for (int i = 0; i < G::MI; ++i) {
    const int o = (ln.wm + kWarpsM * i) * 16 + ln.a_row;
    const int r = o / TW;
    a2[i] = ((r * IW + o - r * TW) * IS + ln.a_k) * 2;
  }
  const uint32_t inter_base = smem_u32(inter);
  const int kch = Cmid_p / KC;
  const int n_chunks = (Cout_p / kNC) * kch;
  float acc[G::MI][kNI][4];
  float logit[kHeadOut];
  if (HEAD) {
#pragma unroll
    for (int o = 0; o < kHeadOut; ++o) logit[o] = 0.f;
  }
  load_w_chunk<KC, 9>(ws, w2t, 0, 0, Cmid_p);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = (c / kch) * kNC;
    const int kc = c % kch;
    if (c + 1 < n_chunks)
      load_w_chunk<KC, 9>(ws + ((c + 1) & 1) * G::WS, w2t,
                          ((c + 1) / kch) * kNC, ((c + 1) % kch) * KC, Cmid_p);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) zero_acc<G::MI>(acc);
    mma_chunk<G::MI, G::MT, KC, 9>(acc, inter_base + kc * KC * 2, a2, IS * 2,
                                   IW, smem_u32(ws + (c & 1) * G::WS) + b_off,
                                   ln.wm);
    if (kc == kch - 1) {
#pragma unroll
      for (int i = 0; i < G::MI; ++i) {
        const int mt = ln.wm + kWarpsM * i;
        if (mt >= G::MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = mt * 16 + ln.g + 8 * h;
          const int gy = ty0 + o / TW;
          const int gx = tx0 + o % TW;
          if (!HEAD && (gy >= H || gx >= W)) continue;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int nn = (ln.wn * kNI + j) * 8 + 2 * ln.q4;
            const int n = n0 + nn;
            const float v0 =
                fmaxf(acc[i][j][2 * h] * bf2f(s2, n) + bf2f(b2, n), 0.f);
            const float v1 = fmaxf(
                acc[i][j][2 * h + 1] * bf2f(s2, n + 1) + bf2f(b2, n + 1), 0.f);
            if (HEAD) {
              stash[o * SS + nn] = v0;
              stash[o * SS + nn + 1] = v1;
            } else if (n < Cout) {
              store_bf16_pair(out + (((size_t)b * H + gy) * W + gx) * Cout, n,
                              Cout, v0, v1);
            }
          }
        }
      }
      if (HEAD) {
        __syncthreads();
        if (threadIdx.x < G::P) {
          const float* row = stash + threadIdx.x * SS;
          for (int nn = 0; nn < kNC; ++nn) {
            const float v = row[nn];
            const float* hw = head.w + (size_t)(n0 + nn) * kHeadOut;
#pragma unroll
            for (int o = 0; o < kHeadOut; ++o) logit[o] += v * hw[o];
          }
        }
      }
    }
    __syncthreads();
  }
  if (HEAD && threadIdx.x < G::P) {
    const int gy = ty0 + threadIdx.x / TW;
    const int gx = tx0 + threadIdx.x % TW;
    if (gy < H && gx < W) {
      float* dst = head.logits + (((size_t)b * H + gy) * W + gx) * head.n_out;
#pragma unroll
      for (int o = 0; o < kHeadOut; ++o)
        if (o < head.n_out) dst[o] = logit[o] + head.b[o];
    }
  }
}

// Shared memory of one double-conv tile: the bf16 ring tile, two input
// chunk buffers and two weight chunk buffers.
template <int TH, int TW, int KC>
struct DoubleConvSmem {
  using G1 = ConvGeom<TH, TW, KC, 1>;
  __host__ __device__ static constexpr int inter_elems(int cmid_p) {
    return G1::MT * 16 * (cmid_p + 8);
  }
  __host__ __device__ static constexpr size_t bytes(int cmid_p) {
    return 2 * ((size_t)inter_elems(cmid_p) + 2 * (size_t)G1::XS +
                2 * (size_t)G1::WS);
  }
  // the head's fp32 stash lies over the input buffers, idle in the second conv
  static_assert((size_t)TH * TW * (kNC + 1) * 4 <= 2 * (size_t)G1::XS * 2,
                "the head's stash must fit the input chunk buffers");
};

// The tile of a double conv, chosen by its mid channels, for every kernel
// that runs double_conv_tile. 16x16 tiles while the bf16 ring tile is small.
// Above, 8x8 tiles; at Cmid 256 16-channel chunks keep two blocks on an SM,
// at Cmid 512 one block fits either way and 32-channel chunks halve the
// barriers (each choice measured the faster in the fused double conv on an
// H100 80GB HBM3 at 700 W, PERF.md).
enum DoubleConvTile { kTile16Kc32 = 0, kTile8Kc16 = 1, kTile8Kc32 = 2 };
inline DoubleConvTile double_conv_tile_for(int cmid_p) {
  return cmid_p <= 128 ? kTile16Kc32 : cmid_p <= 256 ? kTile8Kc16 : kTile8Kc32;
}
inline int double_conv_tile_side(DoubleConvTile t) {
  return t == kTile16Kc32 ? 16 : 8;
}

// The weights of one double conv: (Cmid_p, 9, Cin_p) and (Cout_p, 9, Cmid_p)
// bf16, scales and shifts per padded output channel.
struct DoubleConvWeights {
  const uint16_t* w1t;
  const uint16_t* s1;
  const uint16_t* b1;
  const uint16_t* w2t;
  const uint16_t* s2;
  const uint16_t* b2;
  int Cin_p, Cmid_p, Cout, Cout_p;
};

// (conv3x3 + scale/shift + ReLU) x 2 over the tile at (ty0, tx0) of image b,
// SAME padding on both. smem: DoubleConvSmem<TH, TW, KC>::bytes(Cmid_p).
template <int TH, int TW, int KC, bool HEAD>
__device__ __forceinline__ void double_conv_tile(
    uint16_t* smem, const ConvSrc& src, const DoubleConvWeights& w, int b,
    int H, int W, int ty0, int tx0, uint16_t* out, const HeadArgs& head) {
  using S = DoubleConvSmem<TH, TW, KC>;
  const int IS = w.Cmid_p + 8;  // ring tile row stride (bf16)
  uint16_t* inter = smem;
  uint16_t* xs = inter + S::inter_elems(w.Cmid_p);
  uint16_t* ws = xs + 2 * S::G1::XS;
  conv_from_global<TH, TW, KC, 1>(xs, ws, src, w.w1t, w.s1, w.b1, w.Cin_p,
                                  w.Cmid_p, b, H, W, ty0, tx0, inter, IS,
                                  nullptr, 0);
  conv_from_smem<TH, TW, KC, HEAD>(inter, IS, ws, reinterpret_cast<float*>(xs),
                                   w.w2t, w.s2, w.b2, w.Cmid_p, w.Cout,
                                   w.Cout_p, b, H, W, ty0, tx0, out, head);
}

}  // namespace pk
