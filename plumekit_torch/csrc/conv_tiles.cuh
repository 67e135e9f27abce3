// Device code shared by the conv kernels of plumekit_torch for Hopper
// (sm_90a): the fused double conv (fused_double_conv.cu), the single conv
// (fused_conv.cu) and the whole-forward U-Net kernel (unet_mega.cu).
//
// A 3x3 SAME conv + per-channel scale/shift + ReLU is an implicit GEMM on the
// tensor cores (bf16 in, fp32 accumulate): rows are pixels, columns output
// channels, the reduction runs over taps x input channels. Two paths, chosen
// by the output width of the conv (plumekit_torch/models/kernels/
// conv_tiles.py holds the rule and hands the choice to the C entry points):
//
// The wgmma path (more than 64 output channels; wg_* below). What bounds a
// wide conv on an H100 is how often a block re-reads its operands: at 256 or
// 512 channels the weights are megabytes, every block streams all of them
// from L2, and mma.sync fragments are re-loaded from shared memory for every
// 32 output channels. So here:
//   * one block of two warpgroups accumulates 128 output channels at a time
//     over up to 256 rows (4 x m64n128k16 per 16 input channels), fp32
//     accumulators in registers; an input chunk of 32 channels is staged
//     once per pass and feeds 128 columns per read;
//   * M runs over the *padded raster* of the staged patch: the patch of G
//     images, (TH + 2r) x (TW + 2r) pixels each, lies in shared memory as
//     [channel group of 8][pixel][8 channels] (the no-swizzle K-major
//     layout of the wgmma descriptor: 8 x 16 B core matrices, 16 B from row
//     to row), so tap (dy, dx) is the same matrix started dy * width + dx
//     rows later. The two columns and two rows per image that wrap are
//     computed and dropped (a row of the product depends on the same row of
//     A only, so junk never leaks into a kept pixel);
//   * the tile (TH, TW) and the images per block G are runtime numbers:
//     small planes put several images into one block's M, so the weights
//     stream once for all of them, and tiles are picked to fill the plane;
//   * weights are packed once on the host in the order the kernel consumes
//     them, [pass of 128][chunk of 32][tap][channel group][n][8]: a stage
//     (one tap of one chunk, 8 KB) is one cp.async.bulk into a ring of four
//     slots, completion on an mbarrier; consumers release a slot through a
//     second mbarrier once their wgmma group on it has retired, and thread 0
//     refills it. No thread computes a weight address;
//   * in the double conv the first conv's output (tile plus 1-px ring, all
//     mid channels, bf16, zero outside the image) stays in shared memory in
//     the same layout and is the second conv's A operand as it lies.
//
// The mma.sync path (up to 64 output channels; the functions above wg_*):
// one block owns a 16 x 16 tile of one image, mma.sync.m16n8k16 with
// ldmatrix fragments, 32 output channels per chunk, operands staged by
// cp.async two buffers deep. At these widths the activations, not the
// weights, are the traffic, the kernel beats cuDNN, and it is kept as it
// was. It also holds the 1x1 fp32 head of the whole-forward kernel.
//
// Activations are read through cp.async.cg or ld.global.cg (L2 only),
// never through the read-only path, and through L1 only where the source
// says it is not written during the launch (ConvSrc::ro): inside the
// whole-forward kernel one stage reads what the stage before it wrote, and a
// plane's room is written again once its readers are done.

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
static_assert(kHeadOut == 8, "the head's epilogues load a row as two float4");
static_assert(kNI == 2, "one ldmatrix.x4 loads the B fragments of two n-tiles");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf2f(const uint16_t* p, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

// one bf16 activation through L2 only (ld.global.cg): the whole-forward
// kernel rewrites scratch planes, and an SM's L1 may hold a stale line
__device__ __forceinline__ float bf2f_cg(const uint16_t* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(p)));
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
// ro: p0 is not written during the launch, so that its unaligned channels
// may be read through L1 (the network input; a K5 or K6 input).
struct ConvSrc {
  const uint16_t* p0;
  const uint16_t* p1;
  int c0, c0p, c1;
  int ro;
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
      for (int j = 0; j < 8; ++j)
        e[j] = !(inside && ch + j < C) ? 0
               : (src.ro && !second)   ? p[j]
                                       : __ldcg(p + j);
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

// The same for a window of n_ch channels that starts at an even channel of
// a pixel whose channel count is even or not.
__device__ __forceinline__ void store_pair_of(uint16_t* dst, int n, int n_ch,
                                              bool even_pixel, float v0,
                                              float v1) {
  if (n + 1 < n_ch && even_pixel) {
    *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
  } else {
    reinterpret_cast<__nv_bfloat16*>(dst)[n] = __float2bfloat16_rn(v0);
    if (n + 1 < n_ch)
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
  load_w_chunk<KC>(ws, wt, 0, 0, Kp);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = (c / kch) * kNC;
    const int kc = c % kch;
    if (c + 1 < n_chunks) {
      const int nb = (c + 1) & 1;
      load_x_chunk<G::XH, G::XW, KC>(xs + nb * G::XS, src, b, H, W, y0, x0,
                                     ((c + 1) % kch) * KC);
      load_w_chunk<KC>(ws + nb * G::WS, wt, ((c + 1) / kch) * kNC,
                          ((c + 1) % kch) * KC, Kp);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) zero_acc<G::MI>(acc);
    mma_chunk<G::MI, G::MT, KC>(acc, smem_u32(xs + (c & 1) * G::XS), a1,
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
//   !HEAD: rounds to bf16 and writes out[b, gy, gx, n] for n < Cout, or,
//          with keep, every tile pixel o and channel n < Cout_p to
//          keep[((n / 8) * kp + o) * 8 + n % 8] in shared memory instead
//          (the wgmma A layout; the whole-forward kernel pools, stores and
//          upsamples the tile from there);
//   HEAD:  keeps the result in fp32, passes it 32 channels at a time through
//          stash (TH*TW x 33 floats of shared memory) and writes
//          logits[b, gy, gx, :] = result @ head.w + head.b instead, each
//          pixel's sum taken by one thread in channel order.
template <int TH, int TW, int KC, bool HEAD>
__device__ __forceinline__ void conv_from_smem(
    const uint16_t* inter, int IS, uint16_t* ws, float* stash,
    const uint16_t* w2t, const uint16_t* s2, const uint16_t* b2, int Cmid_p,
    int Cout, int Cout_p, int b, int H, int W, int ty0, int tx0, uint16_t* out,
    const HeadArgs& head, uint16_t* keep = nullptr, int kp = 0) {
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
  load_w_chunk<KC>(ws, w2t, 0, 0, Cmid_p);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = (c / kch) * kNC;
    const int kc = c % kch;
    if (c + 1 < n_chunks)
      load_w_chunk<KC>(ws + ((c + 1) & 1) * G::WS, w2t,
                          ((c + 1) / kch) * kNC, ((c + 1) % kch) * KC, Cmid_p);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) zero_acc<G::MI>(acc);
    mma_chunk<G::MI, G::MT, KC>(acc, inter_base + kc * KC * 2, a2, IS * 2,
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
          if (!HEAD && keep == nullptr && (gy >= H || gx >= W)) continue;
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
            } else if (keep != nullptr) {
              *reinterpret_cast<__nv_bfloat162*>(
                  keep + (((n >> 3) * kp + o) << 3) + (n & 7)) =
                  __floats2bfloat162_rn(v0, v1);
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
            // a row of kHeadOut floats, 32-byte aligned: two 16-byte loads
            const float4* hw = reinterpret_cast<const float4*>(
                head.w + (size_t)(n0 + nn) * kHeadOut);
            const float4 h0 = hw[0], h1 = hw[1];
            logit[0] += v * h0.x;
            logit[1] += v * h0.y;
            logit[2] += v * h0.z;
            logit[3] += v * h0.w;
            logit[4] += v * h1.x;
            logit[5] += v * h1.y;
            logit[6] += v * h1.z;
            logit[7] += v * h1.w;
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

// The weights of one double conv, scales and shifts per padded output
// channel. mma.sync path: w1t (Cmid_p, 9, Cin_p) and w2t (Cout_p, 9, Cmid_p)
// bf16, channel counts padded to 32. wgmma path: the two weight streams
// (wg_conv below), Cin_p padded to 32, Cmid_p and Cout_p to 128.
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
// keep, kp: as conv_from_smem's (keep lies in the input chunk buffers, idle
// in the second conv; null: the result goes to out).
template <int TH, int TW, int KC, bool HEAD>
__device__ __forceinline__ void double_conv_tile(
    uint16_t* smem, const ConvSrc& src, const DoubleConvWeights& w, int b,
    int H, int W, int ty0, int tx0, uint16_t* out, const HeadArgs& head,
    uint16_t* keep = nullptr, int kp = 0) {
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
                                   w.Cout_p, b, H, W, ty0, tx0, out, head,
                                   keep, kp);
}

// ------------------------------------------------------------ wgmma path

constexpr int kWgN = 128;          // output channels per pass
constexpr int kWgKC = 32;          // input channels per staged chunk
constexpr int kWgStageBytes = kWgN * kWgKC * 2;  // one tap of one chunk
constexpr int kWgStages = 4;       // slots of the weight ring
constexpr int kWgMaxRows = 256;    // raster rows of one item: 2 warpgroups
                                   // x 2 m64 tiles
constexpr int kWgBarBytes = 128;   // the mbarriers, at the start of shared
                                   // memory; the weight ring follows
constexpr int kWgRingBytes = kWgStages * kWgStageBytes;
constexpr int kWgHeadStride = 33;  // floats per row of the head's stash

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// writes of this thread to shared memory (st.shared, cp.async) before, reads
// by wgmma or writes by cp.async.bulk after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) global -> shared by the copy engine; completion is
// counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in their registers across a batch of wgmmas: the
// compiler neither moves them nor assumes their values while the tensor
// cores may still write them.
template <int MT, int R>
__device__ __forceinline__ void wgmma_fence_acc(float (&acc)[R][64]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(acc[i][e])::"memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: 8 x 16 B core
// matrices; rows 16 B apart (8-row groups 128 B apart: the stride byte
// offset), the two 8-channel halves of a k16 step k_pitch16 * 16 B apart (the
// leading byte offset).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t k_pitch16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)k_pitch16 << 16) |
         ((uint64_t)8 << 32);
}

// d (64 x 128 fp32 over the warpgroup) += A (64 x 16) * B (16 x 128), both
// bf16 from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The weight ring: mbarriers full[s] at bars + 8 s, empty[s] at bars +
// 8 (kWgStages + s), slots at ring + s * kWgStageBytes. issued and consumed
// count stages since the kernel began, the same in every thread, so the slot
// and the parity of a wait follow from them.
struct WgPipe {
  uint32_t bars, ring, issued, consumed;
};

// Once per kernel, before any use; ends with a block barrier.
__device__ __forceinline__ WgPipe wg_pipe_init(void* smem) {
  WgPipe p{smem_u32(smem), smem_u32(smem) + kWgBarBytes, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(p.bars + 8 * s, 1);                       // the producer
      mbar_init(p.bars + 8 * (kWgStages + s), kThreads / 32);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  return p;
}

// Every thread calls it; thread 0 waits for the slot and starts the copy.
__device__ __forceinline__ void wg_issue(WgPipe& p, const char* src) {
  if (threadIdx.x == 0) {
    const uint32_t c = p.issued;
    const uint32_t slot = c % kWgStages;
    if (c >= kWgStages)
      mbar_wait(p.bars + 8 * (kWgStages + slot), ((c / kWgStages) - 1) & 1);
    mbar_expect_tx(p.bars + 8 * slot, kWgStageBytes);
    bulk_copy(p.ring + slot * kWgStageBytes, src, kWgStageBytes,
              p.bars + 8 * slot);
  }
  ++p.issued;
}

// n / d for 0 <= n < 2^16 and 0 < d < 2^12 through a float reciprocal: exact
// there (the quotient of n + 0.5 is at least 0.5 / d from an integer, the
// rounding error of the product below 2^-7 of that), and a handful of
// registers lighter than the integer division it stands for.
struct SmallDiv {
  int d;
  float inv;
  __device__ __forceinline__ explicit SmallDiv(int d_) : d(d_), inv(1.f / d_) {}
  __device__ __forceinline__ int div(int n) const {
    return __float2int_rd((n + 0.5f) * inv);
  }
};

// The pixels an A operand is staged from: the ph x pw patch at (y0, x0) of
// each of g images from b0 on, of planes (B, H, W, C).
struct WgPatch {
  int B, H, W, b0, g, ph, pw, y0, x0;
};

// Stage padded channels [k0, k0 + 32) of the patch into dst as
// [channel group of 8][pitch pixels][8]; pixels outside the image or past
// the batch and channels past the source's count read as zero.
__device__ __forceinline__ void wg_load_a(uint32_t dst, int pitch,
                                          const ConvSrc& src,
                                          const WgPatch& p, int k0) {
  const bool second = k0 >= src.c0p;
  const uint16_t* plane = second ? src.p1 : src.p0;
  const int C = second ? src.c1 : src.c0;
  const int kb = second ? k0 - src.c0p : k0;
  const int per = p.ph * p.pw;
  const SmallDiv by_per(per), by_pw(p.pw);
  const int total = p.g * per * (kWgKC / 8);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int part = i & 3;
    const int pix = i >> 2;
    const int img = by_per.div(pix);
    const int rem = pix - img * per;
    const int r = by_pw.div(rem);
    const int b = p.b0 + img;
    const int gy = p.y0 + r;
    const int gx = p.x0 + rem - r * p.pw;
    const int ch = kb + part * 8;
    const bool inside = b < p.B && gy >= 0 && gy < p.H && gx >= 0 &&
                        gx < p.W && ch < C;
    const uint16_t* s =
        inside ? plane + (((size_t)b * p.H + gy) * p.W + gx) * C + ch : plane;
    const uint32_t d = dst + (uint32_t)(part * pitch + pix) * 16;
    if ((C & 7) == 0) {
      cp_async16_to(d, s, inside);
    } else {  // unaligned channel count: synchronous, element by element
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = !(inside && ch + j < C) ? 0u
               : (src.ro && !second)   ? (uint32_t)s[j]
                                       : (uint32_t)__ldcg(s + j);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(e[0] | (e[1] << 16)), "r"(e[2] | (e[3] << 16)),
                   "r"(e[4] | (e[5] << 16)), "r"(e[6] | (e[7] << 16))
                   : "memory");
    }
  }
}

// One conv as a GEMM over raster rows: row q reads A rows q + dy * a_w + dx.
struct WgConv {
  int m_rows;    // raster rows to compute (<= kWgMaxRows)
  int a_w;       // raster width
  int a_pitch;   // pixels per 8-channel group of the A operand
};

// One conv's packed weights as one block reads them: n_pass passes from
// pass0 on, kch 32-channel chunks, taps taps (9, or 1 for a 1x1 product),
// stage (pass, chunk, tap) at ((pass * kch + chunk) * taps + tap) *
// kWgStageBytes: the order of the consumers' loops, so the stream is read
// front to back. sent counts the stages already handed to the copy engine.
struct WgStream {
  const char* base;
  int n_pass, kch, taps;
  int sent, total;
  __device__ __forceinline__ WgStream(const uint16_t* w, int pass0,
                                      int n_pass_, int kch_, int taps_)
      : base(reinterpret_cast<const char*>(w) +
             (size_t)pass0 * kch_ * taps_ * kWgStageBytes),
        n_pass(n_pass_), kch(kch_), taps(taps_), sent(0),
        total(n_pass_ * kch_ * taps_) {}
  __device__ __forceinline__ bool more() const { return sent < total; }
  // Every thread calls it while more(); thread 0 starts the copy.
  __device__ __forceinline__ void send(WgPipe& pipe) {
    wg_issue(pipe, base + (size_t)sent * kWgStageBytes);
    ++sent;
  }
};

__host__ __device__ constexpr int wg_round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// Pixels per channel group of a staged A operand: every row a padded m64
// tile can reach through a tap lies inside the group, and four lanes' 16 B
// parts of two pixels fall into eight different bank groups.
__host__ __device__ constexpr int wg_a_pitch(int pixels, int m_rows, int a_w,
                                             int taps) {
  const int reach = wg_round_up(m_rows, 64) + (taps == 9 ? 2 * a_w + 2 : 0);
  return wg_round_up(pixels > reach ? pixels : reach, 8) + 2;
}

// The rows and columns of a 64 x 128 accumulator tile that this thread
// holds: rows row0 + 8 h, columns 8 j + col0 (+1), in d[4 j + 2 h (+1)].
struct WgLane {
  int wg, row0, col0;
  __device__ __forceinline__ WgLane() {
    const int lane = threadIdx.x & 31;
    wg = threadIdx.x >> 7;
    row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    col0 = 2 * (lane & 3);
  }
};

// One conv, all passes of its weight stream `own`: per pass 128 output
// channels over g.m_rows raster rows.
//   STAGED: the A operand is staged per chunk by load(dst, chunk) into two
//           buffers of a_buf_bytes at a_addr, the next chunk (of this pass
//           or the next) while the current one is multiplied;
//   else:   it lies at a_addr for every chunk, 4 * a_pitch * 16 B per chunk
//           (the ring tile of a double conv).
// The ring runs kWgStages - 1 stages ahead. Stages of `own` that the
// caller's previous conv already sent are not sent again; as this conv's
// last slots fall free they take the first stages of `next`, the stream of
// the conv the caller runs next (or null), so that no conv starts on an
// empty ring. After each pass epi.run<MT>(acc, pass) sees the accumulators
// of the stream's pass `pass`. MT: the m64 tiles of this warpgroup (tiles
// wgi and wgi + 2). The block is at a barrier when the function returns.
template <int MT, bool STAGED, class Load, class Epi>
__device__ __forceinline__ void wg_conv_tiles(WgPipe& pipe, const WgConv& g,
                                              WgStream& own, WgStream* next,
                                              uint32_t a_addr,
                                              uint32_t a_buf_bytes, Load& load,
                                              Epi& epi, int wgi) {
  constexpr int kAhead = kWgStages - 1;
  int next_room = next == nullptr ? 0 : kAhead;  // of next, still to send
  // whatever wrote this shared memory before, the copy engine writes now
  fence_proxy_async();
  __syncthreads();
  while (own.sent < kAhead && own.more()) own.send(pipe);
  if (STAGED) {
    load(a_addr, 0);
    cp_async_commit();
  }
  int chunk = 0;  // chunks staged so far, over the passes
  float acc[MT > 0 ? MT : 1][64];
  for (int lp = 0; lp < own.n_pass; ++lp) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
    int held = -1;  // the slot whose wgmma group is still in flight
    for (int lk = 0; lk < own.kch; ++lk, ++chunk) {
      uint32_t a_chunk;
      if (STAGED) {
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();
        a_chunk = a_addr + (chunk & 1) * a_buf_bytes;
      } else {
        a_chunk = a_addr + (uint32_t)lk * (kWgKC / 8) * g.a_pitch * 16;
      }
      for (int tap = 0; tap < own.taps; ++tap) {
        const uint32_t slot = pipe.consumed % kWgStages;
        mbar_wait(pipe.bars + 8 * slot, (pipe.consumed / kWgStages) & 1);
        ++pipe.consumed;
        const int shift = own.taps == 9 ? (tap / 3) * g.a_w + tap % 3 : 0;
        const uint32_t b_addr = pipe.ring + slot * kWgStageBytes;
        wgmma_fence_acc<MT>(acc);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int kk = 0; kk < kWgKC / 16; ++kk) {
            const uint64_t da = wg_desc(
                a_chunk + (uint32_t)((wgi + 2 * i) * 64 + shift +
                                     kk * 2 * g.a_pitch) * 16,
                g.a_pitch);
            const uint64_t db = wg_desc(b_addr + kk * 2 * kWgN * 16, kWgN);
            wgmma_m64n128k16(acc[i], da, db);
          }
        }
        wgmma_commit();
        if (held >= 0) {
          // the group before this one has retired: its slot is free
          wgmma_wait<1>();
          wgmma_fence_acc<MT>(acc);
          if ((threadIdx.x & 31) == 0)
            mbar_arrive(pipe.bars + 8 * (kWgStages + held));
          if (own.more()) {
            own.send(pipe);
          } else if (next_room > 0 && next->more()) {
            next->send(pipe);
            --next_room;
          }
        }
        held = slot;
        if (STAGED && tap == 0 &&
            (lk + 1 < own.kch || lp + 1 < own.n_pass)) {
          // every warp has retired the chunk before this one: its buffer
          // takes the next chunk
          __syncthreads();
          load(a_addr + ((chunk + 1) & 1) * a_buf_bytes,
               lk + 1 < own.kch ? lk + 1 : 0);
          cp_async_commit();
        }
      }
    }
    wgmma_wait<0>();
    wgmma_fence_acc<MT>(acc);
    if ((threadIdx.x & 31) == 0)
      mbar_arrive(pipe.bars + 8 * (kWgStages + held));
    if (own.more()) {
      own.send(pipe);
    } else if (next_room > 0 && next->more()) {
      next->send(pipe);
      --next_room;
    }
    epi.template run<MT>(acc, lp);
    // whatever the epilogue wrote to shared memory is the block's
    fence_proxy_async();
    __syncthreads();
  }
  // the next conv's stages that no slot fell free for
  while (next_room > 0 && next->more()) {
    next->send(pipe);
    --next_room;
  }
}

// The m64 tiles of a conv go to the two warpgroups in turn: warpgroup 0
// takes tiles 0 and 2, warpgroup 1 tiles 1 and 3. Each runs the body compiled
// for its own count of tiles, so that no wgmma stands behind a condition
// (the compiler serialises those).
template <bool STAGED, class Load, class Epi>
__device__ __forceinline__ void wg_conv(WgPipe& pipe, const WgConv& g,
                                        WgStream& own, WgStream* next,
                                        uint32_t a_addr, uint32_t a_buf_bytes,
                                        Load& load, Epi& epi) {
  // broadcast from lane 0: a value the compiler knows to be warp-uniform
  const int wgi = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  const int n_mt = (g.m_rows + 63) >> 6;
  const int mine = (n_mt + 1 - wgi) >> 1;
  if (mine == 2)
    wg_conv_tiles<2, STAGED>(pipe, g, own, next, a_addr, a_buf_bytes, load,
                             epi, wgi);
  else if (mine == 1)
    wg_conv_tiles<1, STAGED>(pipe, g, own, next, a_addr, a_buf_bytes, load,
                             epi, wgi);
  else
    wg_conv_tiles<0, STAGED>(pipe, g, own, next, a_addr, a_buf_bytes, load,
                             epi, wgi);
}

struct WgNoLoad {
  __device__ __forceinline__ void operator()(uint32_t, int) const {}
};

struct WgStageLoad {
  const ConvSrc& src;
  const WgPatch& patch;
  int pitch;
  __device__ __forceinline__ void operator()(uint32_t dst, int kc) const {
    wg_load_a(dst, pitch, src, patch, kc * kWgKC);
  }
};

// Where raster row q of an item lies: image img of the group, pixel (r, c)
// of its per_h x per_w raster.
struct WgPixel {
  int img, r, c;
  __device__ __forceinline__ WgPixel(int q, int per_h, int per_w) {
    const int per = per_h * per_w;
    img = SmallDiv(per).div(q);
    const int rem = q - img * per;
    r = SmallDiv(per_w).div(rem);
    c = rem - r * per_w;
  }
};

// Scale and shift of output channels n and n + 1, read once per column pair.
struct WgBn {
  float s0, s1, b0, b1;
  __device__ __forceinline__ WgBn(const uint16_t* sc, const uint16_t* sh,
                                  int n)
      : s0(bf2f(sc, n)), s1(bf2f(sc, n + 1)), b0(bf2f(sh, n)),
        b1(bf2f(sh, n + 1)) {}
  __device__ __forceinline__ float lo(float a) const {
    return fmaxf(a * s0 + b0, 0.f);
  }
  __device__ __forceinline__ float hi(float a) const {
    return fmaxf(a * s1 + b1, 0.f);
  }
};

// Epilogue of a double conv's first conv: scale/shift + ReLU, rounded to
// bf16 into the ring tile inter[n / 8][pixel][n % 8] (g images of rh x rw
// ring pixels, ip = g * rh * rw), zero where the ring lies outside the image.
struct WgRingEpi {
  const uint16_t* sc;
  const uint16_t* sh;
  uint32_t inter;
  int ip, g, ph, pw, rh, rw, B, H, W, b0, ry0, rx0;
  template <int MT>
  __device__ __forceinline__ void run(const float (&acc)[MT > 0 ? MT : 1][64],
                                      int pass) const {
    if (MT == 0) return;
    const WgLane ln;
    int pix[2][2];  // ring pixel of this thread's rows: -1 dropped, |1<<30 zero
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const WgPixel p((ln.wg + 2 * i) * 64 + ln.row0 + 8 * h, ph, pw);
        const bool kept = p.img < g && p.r < rh && p.c < rw;
        const int b = b0 + p.img, gy = ry0 + p.r, gx = rx0 + p.c;
        const bool inside = b < B && gy >= 0 && gy < H && gx >= 0 && gx < W;
        pix[i][h] = !kept ? -1
                          : ((p.img * rh + p.r) * rw + p.c) |
                                (inside ? 0 : 1 << 30);
      }
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      const int n = pass * kWgN + j * 8 + ln.col0;
      const uint32_t col = inter + (uint32_t)(n >> 3) * ip * 16 + (n & 7) * 2;
      const WgBn bn(sc, sh, n);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[i][h] < 0) continue;
          __nv_bfloat162 v = __floats2bfloat162_rn(
              bn.lo(acc[i][4 * j + 2 * h]), bn.hi(acc[i][4 * j + 2 * h + 1]));
          uint32_t bits = *reinterpret_cast<uint32_t*>(&v);
          if (pix[i][h] & (1 << 30)) bits = 0;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           col + (uint32_t)(pix[i][h] & 0xFFFFFF) * 16),
                       "r"(bits)
                       : "memory");
        }
    }
  }
};

// Epilogue to device memory: scale/shift + ReLU, rounded to bf16 into
// out[b, y0 + r, x0 + c, n] for the th x tw pixels of each image's
// per_h x per_w raster.
struct WgOutEpi {
  const uint16_t* sc;
  const uint16_t* sh;
  uint16_t* out;    // channel 0 of the epilogue's pass 0
  int n_ch;         // channels from there on
  int Cout;         // channels of a pixel of out
  int g, per_h, per_w, th, tw, B, H, W, b0, y0, x0;
  template <int MT>
  __device__ __forceinline__ void run(const float (&acc)[MT > 0 ? MT : 1][64],
                                      int pass) const {
    if (MT == 0) return;
    const WgLane ln;
    uint16_t* dst[2][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const WgPixel p((ln.wg + 2 * i) * 64 + ln.row0 + 8 * h, per_h, per_w);
        const int b = b0 + p.img, gy = y0 + p.r, gx = x0 + p.c;
        const bool kept = p.img < g && p.r < th && p.c < tw && b < B &&
                          gy < H && gx < W;
        dst[i][h] =
            kept ? out + (((size_t)b * H + gy) * W + gx) * Cout : nullptr;
      }
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      const int n = pass * kWgN + j * 8 + ln.col0;
      if (n >= n_ch) continue;
      const WgBn bn(sc, sh, n);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (dst[i][h] != nullptr)
            store_pair_of(dst[i][h], n, n_ch, (Cout & 1) == 0,
                          bn.lo(acc[i][4 * j + 2 * h]),
                          bn.hi(acc[i][4 * j + 2 * h + 1]));
    }
  }
};

// Epilogue of the last decoder block of the whole-forward kernel: the
// result stays fp32 and goes 32 channels at a time through stash (a row of
// kWgHeadStride floats per raster row); thread q sums raster row q's logits
// in channel order into logit[].
struct WgHeadEpi {
  const uint16_t* sc;
  const uint16_t* sh;
  const float* head_w;  // (Cout_p, kHeadOut)
  float* stash;
  float* logit;         // this thread's kHeadOut sums
  int m_rows;
  template <int MT>
  __device__ __forceinline__ void run(const float (&acc)[MT > 0 ? MT : 1][64],
                                      int pass) const {
    const WgLane ln;
#pragma unroll
    for (int jb = 0; jb < kWgN / 32; ++jb) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jb * 4 + jj;
        const WgBn bn(sc, sh, pass * kWgN + j * 8 + ln.col0);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* row = stash + ((ln.wg + 2 * i) * 64 + ln.row0 + 8 * h) *
                                     kWgHeadStride + jj * 8 + ln.col0;
            row[0] = bn.lo(acc[i][4 * j + 2 * h]);
            row[1] = bn.hi(acc[i][4 * j + 2 * h + 1]);
          }
        }
      }
      __syncthreads();
      if ((int)threadIdx.x < m_rows) {
        const float* row = stash + threadIdx.x * kWgHeadStride;
        for (int nn = 0; nn < 32; ++nn) {
          const float v = row[nn];
          const float* hw =
              head_w + (size_t)(pass * kWgN + jb * 32 + nn) * kHeadOut;
#pragma unroll
          for (int o = 0; o < kHeadOut; ++o) logit[o] += v * hw[o];
        }
      }
      __syncthreads();
    }
  }
};

// The tile of a wgmma item and what follows from it. th x tw output pixels
// of each of g images; r = 1 for a double conv (the first conv also covers
// the 1-px ring), 0 for a single conv.
struct WgTile {
  int th, tw, g;
};
struct WgGeom {
  int ph, pw;      // staged input patch per image
  int rh, rw;      // ring tile per image (double conv)
  int m1, m2;      // raster rows of the first (or only) and the second conv
  int a_pitch;     // of the staged input
  int ip;          // ring pixels of the item: the ring tile's pitch
  uint32_t inter_bytes, a_buf_bytes;
  __host__ __device__ WgGeom(WgTile t, int r, int cmid_p) {
    ph = t.th + 2 * r + 2;
    pw = t.tw + 2 * r + 2;
    rh = t.th + 2;
    rw = t.tw + 2;
    m1 = t.g * ph * pw - 2 * pw - 2;
    m2 = t.g * rh * rw - 2 * rw - 2;
    a_pitch = wg_a_pitch(t.g * ph * pw, m1, pw, 9);
    ip = t.g * rh * rw;
    inter_bytes = r ? (uint32_t)(cmid_p / 8) * ip * 16 : 0;
    a_buf_bytes = (uint32_t)(kWgKC / 8) * a_pitch * 16;
  }
  // barriers, weight ring, ring tile, two input buffers (which also take the
  // second conv's reads past the ring tile's end and the head's stash)
  __host__ __device__ size_t smem_bytes(bool head) const {
    size_t tail = 2 * (size_t)a_buf_bytes;
    const size_t over = (size_t)(wg_round_up(m2, 64) + 2 * rw + 2) * 16;
    const size_t stash =
        head ? (size_t)wg_round_up(m2, 64) * kWgHeadStride * 4 : 0;
    tail = tail > over ? tail : over;
    tail = tail > stash ? tail : stash;
    return kWgBarBytes + kWgRingBytes + inter_bytes + tail;
  }
  __host__ __device__ bool fits(bool head) const {
    return m1 <= kWgMaxRows && m2 <= kWgMaxRows &&
           smem_bytes(head) <= (size_t)kMaxSmem;
  }
};

// One single-conv item on the wgmma path: pass `pass` of the conv over the
// tile at (ty0, tx0) of images b0 .. b0 + g - 1, written to out.
__device__ __forceinline__ void wg_single_conv_item(
    uint8_t* smem, WgPipe& pipe, const ConvSrc& src, const uint16_t* wstream,
    const uint16_t* sc, const uint16_t* sh, int Cin_p, int Cout, int B, int H,
    int W, int b0, int ty0, int tx0, WgTile t, int pass, uint16_t* out) {
  const WgGeom gm(t, 0, 0);
  const uint32_t a_addr = smem_u32(smem) + kWgBarBytes + kWgRingBytes;
  const WgPatch patch{B, H, W, b0, t.g, gm.ph, gm.pw, ty0 - 1, tx0 - 1};
  const WgConv cv{gm.m1, gm.pw, gm.a_pitch};
  // one pass per block, as a number the compiler cannot fold: with the pass
  // loop gone it counts the zeroing of the accumulators into the first
  // wgmma's pipeline stage and serialises the wgmmas
  int n_pass = 1;
  asm volatile("" : "+r"(n_pass));
  WgStream stream(wstream, pass, n_pass, Cin_p / kWgKC, 9);
  WgStageLoad load{src, patch, gm.a_pitch};
  // the epilogue's pass counts from the stream's first
  WgOutEpi epi{sc + pass * kWgN, sh + pass * kWgN, out + pass * kWgN,
               Cout - pass * kWgN, Cout, t.g, gm.ph, gm.pw, t.th, t.tw,
               B, H, W, b0, ty0, tx0};
  wg_conv<true>(pipe, cv, stream, nullptr, a_addr, gm.a_buf_bytes, load, epi);
}

// One double-conv item on the wgmma path: (conv3x3 + scale/shift + ReLU) x 2
// over the tile at (ty0, tx0) of images b0 .. b0 + g - 1, SAME padding on
// both; the first conv's output stays in shared memory. !HEAD: written to
// out as bf16; HEAD: kept fp32 into the 1x1 head, logits written instead.
// after: the weight stream of a conv the caller runs right after this item
// (its first stages are sent from here), or null. pass0, n_pass2: the
// second conv computes only its passes [pass0, pass0 + n_pass2) of 128
// output channels (n_pass2 < 0: all of them; !HEAD only).
// smem: WgGeom(t, 1, Cmid_p).smem_bytes(HEAD).
template <bool HEAD>
__device__ __forceinline__ void wg_double_conv_item(
    uint8_t* smem, WgPipe& pipe, const ConvSrc& src,
    const DoubleConvWeights& w, int B, int H, int W, int b0, int ty0, int tx0,
    WgTile t, uint16_t* out, const HeadArgs& head, WgStream* after,
    int pass0 = 0, int n_pass2 = -1) {
  const WgGeom gm(t, 1, w.Cmid_p);
  const uint32_t inter = smem_u32(smem) + kWgBarBytes + kWgRingBytes;
  const uint32_t a_addr = inter + gm.inter_bytes;
  const WgPatch patch{B, H, W, b0, t.g, gm.ph, gm.pw, ty0 - 2, tx0 - 2};
  const WgConv c1{gm.m1, gm.pw, gm.a_pitch};
  const WgConv c2{gm.m2, gm.rw, gm.ip};
  WgStream s1(w.w1t, 0, w.Cmid_p / kWgN, w.Cin_p / kWgKC, 9);
  WgStream s2(w.w2t, pass0, n_pass2 < 0 ? w.Cout_p / kWgN : n_pass2,
              w.Cmid_p / kWgKC, 9);
  WgStageLoad load{src, patch, gm.a_pitch};
  WgRingEpi ring{w.s1, w.b1, inter, gm.ip, t.g, gm.ph, gm.pw, gm.rh,
                 gm.rw, B,    H,     W,     b0,  ty0 - 1, tx0 - 1};
  wg_conv<true>(pipe, c1, s1, &s2, a_addr, gm.a_buf_bytes, load, ring);
  WgNoLoad none;
  if (!HEAD) {
    // the epilogue's pass counts from the stream's first
    WgOutEpi epi{w.s2 + pass0 * kWgN, w.b2 + pass0 * kWgN, out + pass0 * kWgN,
                 w.Cout - pass0 * kWgN, w.Cout, t.g, gm.rh, gm.rw, t.th, t.tw,
                 B, H, W, b0, ty0, tx0};
    wg_conv<false>(pipe, c2, s2, after, inter, 0, none, epi);
  } else {
    float logit[kHeadOut];
#pragma unroll
    for (int o = 0; o < kHeadOut; ++o) logit[o] = 0.f;
    WgHeadEpi epi{w.s2, w.b2, head.w,
                  reinterpret_cast<float*>(smem + kWgBarBytes + kWgRingBytes +
                                           gm.inter_bytes),
                  logit, gm.m2};
    wg_conv<false>(pipe, c2, s2, after, inter, 0, none, epi);
    const WgPixel p(threadIdx.x, gm.rh, gm.rw);
    const int b = b0 + p.img, gy = ty0 + p.r, gx = tx0 + p.c;
    if ((int)threadIdx.x < gm.m2 && p.img < t.g && p.r < t.th && p.c < t.tw &&
        b < B && gy < H && gx < W) {
      float* dst = head.logits + (((size_t)b * H + gy) * W + gx) * head.n_out;
#pragma unroll
      for (int o = 0; o < kHeadOut; ++o)
        if (o < head.n_out) dst[o] = logit[o] + head.b[o];
    }
  }
}

}  // namespace pk
