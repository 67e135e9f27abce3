// Q1, the int8 forward's 3x3 conv, for Hopper (sm_90a): one 3x3 SAME conv
// in int8 with the forward's fused epilogue:
//   acc = conv3x3(x, w)                    s8 x s8 -> s32, exact
//   y   = relu(float(acc) * a + b)     a: conv x BN scale, b: BN shift
//   out = clamp(rint(y / s), -127, 127) int8, or y itself in fp32
// NHWC int8 activations, weights packed once on the host (models/kernels/
// int8_conv.py), epilogue factors per output column in fp32, s one fp32
// scale read from device memory. The forward's other int8 kernel, Q2, the
// transposed conv with its requant, is int8_upsample.cu; the two share the
// s8 wgmma wrappers and the requant (int8_wgmma.cuh).
//
// Replaces no Pallas kernel: the JAX package's int8 forward
// (plumekit/models/quantized_forward.py) leaves Q1's conv to XLA (_qconv,
// :133, with _qblock's epilogue :165-173). PyTorch has no int8 convolution
// on CUDA; the plain version (the Python module) is nine torch._int_mm
// products and the eager epilogue.
//
// What bounds it on an H100: a 3x3 conv does 2 * 9 * Cin * Cout integer
// operations per pixel against Cin + Cout bytes (4 * Cout for fp32 out); the
// ridge of 1,979 TOPS over 3.35 TB/s is about 590 operations per byte. At
// 288² tiles the convs of the 288² level, Cin = 2 and those with up to 64
// input channels at 144² are bound by their bytes, the rest by their
// operations.
//
// Design: one block of two warpgroups computes a GEMM tile of R = 128 * MT
// rows by NB columns with wgmma.mma_async m64nNBk32 .s32.s8.s8 (both
// operands K-major in shared memory, no swizzle: a core matrix is 8 rows of
// 16 bytes, 16 int8 channels; a k32 step spans two of them along K, as a
// bf16 k16 step does), the accumulators in registers (NB * MT / 2 a thread:
// a register file of 65,536 holds 32K of them per SM, so R * NB = 32K for
// the 128-register shapes). Two modes:
//   * raster (Q1): the rows run over the *padded raster* of the staged input
//     patch of g images, (th + 2) x (tw + 2) pixels each, as the bf16 conv
//     tile code does (conv_tiles.cuh, wg_conv_tiles): tap (dy, dx) is the
//     same A matrix dy * (tw + 2) + dx rows on, so a 32-channel chunk of the
//     patch is staged once and feeds nine wgmmas per m64 tile and all NB
//     output channels; the rows that wrap are computed and dropped;
//   * fold (Q1 with at most 3 input channels, the network's input conv):
//     the 9 taps x C channels of a pixel are its one k32 row (18 of 32 bytes
//     useful at C = 2, not 2), the rows are the tile's pixels, one wgmma per
//     m64 tile; the patch's raw rows arrive by 4-byte cp.async and are
//     folded in shared memory.
// The blocks are persistent (as many as fit on the card at once); each walks
// its work items (a tile and a pass of NB columns) chunk by
// chunk as one sequence of steps, staged by cp.async two steps deep: while
// the wgmmas of one 32-channel chunk run, and the epilogue and the stores of
// an item that ends with it, the next step's input lands in the other
// buffer, with its weights (all taps, NB columns, packed on the host in the
// order they are read) unless the block's pass of them stays in shared
// memory for all its items (up to 40 KB). The epilogue rounds step by step
// as the plain versions do (__fmul_rn, __fadd_rn, the IEEE quotient, rint:
// no FMA contraction), so kernel and plain version agree bit for bit; the
// int8 results pass through a stash in shared memory and leave in 16-byte
// runs of channels; an fp32 output leaves from the registers, 16 bytes a
// thread. A decoder block's first conv reads the skip and the upsampled
// half from two planes, so their concat is never written. NB, MT and the
// tile come from the rule in int8_conv.py, decided by timing each conv at
// each shape
// (experiments/int8_conv_times.py --tiles). Plain interface for ctypes; a
// launch returns its cudaError_t.

#include "conv_tiles.cuh"
#include "int8_wgmma.cuh"

namespace {

using pk::cp_async16_to;
using pk::cp_async_commit;
using pk::cp_async_wait_all;
using pk::fence_acc;
using pk::fence_proxy_async;
using pk::Quantizer;
using pk::SmallDiv;
using pk::smem_u32;
using pk::wg_desc;
using pk::wgmma_commit;
using pk::wgmma_fence;
using pk::wgmma_wait;
using pk::WgS8;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kKC = 32;            // input channels (bytes) per chunk, a k32 step
constexpr int kMaxSmem = 232448;   // 227 KB opt-in limit of one block

enum Mode { kRaster = 0, kFold = 1 };

struct Args {
  const int8_t* p0;   // first source (B, H, W, c0)
  const int8_t* p1;   // second source (B, H, W, c1) or null
  const int8_t* wt;   // packed weights: [pass][chunk][tap][2][NB][16]
  const float* a;     // epilogue multiplier per packed column
  const float* bsh;   // epilogue shift per packed column
  const float* s_out; // output scale, or null for fp32 out (Q1)
  void* out;
  int B, H, W;        // the input planes
  int c0, c0p, c1;    // channels of each source; c0p: c0 padded to 32
  int n_k;            // 32-channel chunks
  int cout;           // output channels
  int n_pass;         // passes of NB packed columns
  int th, tw, g;      // the tile of a raster or fold item
  int pitch;          // pixels per 16-channel group of a staged A chunk
  int tiles_x, tiles_y;
  int n_items;        // tiles x passes
  int buf_bytes;      // one of the two step buffers: A, weights, or stash
  int raw_off;        // the fold: where a buffer's raw input rows start
  int raw_rs;         // the fold: bytes per raw input row
  int resident;       // this block's pass of weights stays in shared memory
  int stash_off;      // where the int8 stash starts
};

// One work item: pass `pass` of NB columns over the tile at (ty0, tx0) of
// images b0 .. b0 + g - 1. Items run (image group, tile row, tile column,
// pass), the pass fastest, so the items that run at once share their input
// through L2.
struct Item {
  int pass, b0, ty0, tx0;
};

__device__ __forceinline__ Item decode(const Args& a, int item) {
  Item it{item % a.n_pass, 0, 0, 0};
  int t = item / a.n_pass;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  it.b0 = (t / a.tiles_y) * a.g;
  it.ty0 = ty * a.th;
  it.tx0 = tx * a.tw;
  return it;
}

__device__ __forceinline__ void st_shared_v4(uint32_t d, const uint32_t (&e)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
               "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3])
               : "memory");
}

// 16 channels [ch, ch + 16) of one pixel of a C-channel plane at s into the
// shared address d: asynchronously where C is a multiple of 16, else byte by
// byte; zero where !inside or past C.
__device__ __forceinline__ void stage16(uint32_t d, const int8_t* s,
                                        bool inside, int C, int ch) {
  if ((C & 15) == 0) {
    cp_async16_to(d, s, inside);
  } else {
    uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (inside && ch + j < C)
        e[j >> 2] |= uint32_t(uint8_t(s[j])) << (8 * (j & 3));
    st_shared_v4(d, e);
  }
}

// Padded channels [k0, k0 + 32) of the (th + 2) x (tw + 2) patch at (y0, x0)
// of images b0 .. b0 + g - 1 into dst as [group of 16][pitch pixels][16];
// pixels outside the image or past the batch read as zero.
__device__ __forceinline__ void load_a_raster(uint32_t dst, const Args& a,
                                              int b0, int y0, int x0,
                                              int k0) {
  const bool second = k0 >= a.c0p;
  const int8_t* plane = second ? a.p1 : a.p0;
  const int C = second ? a.c1 : a.c0;
  const int kb = second ? k0 - a.c0p : k0;
  const int pw = a.tw + 2, per = (a.th + 2) * pw;
  const SmallDiv by_per(per), by_pw(pw);
  const int total = a.g * per * 2;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int part = i & 1;
    const int pix = i >> 1;
    const int img = by_per.div(pix);
    const int rem = pix - img * per;
    const int r = by_pw.div(rem);
    const int b = b0 + img, gy = y0 + r, gx = x0 + rem - r * pw;
    const int ch = kb + part * 16;
    const bool inside = b < a.B && gy >= 0 && gy < a.H && gx >= 0 &&
                        gx < a.W && ch < C;
    const int8_t* s =
        inside ? plane + (((size_t)b * a.H + gy) * a.W + gx) * C + ch : plane;
    stage16(dst + (uint32_t)(part * a.pitch + pix) * 16, s, inside, C, ch);
  }
}

// The fold's input, step one: the (th + 2) rows of (tw + 2) pixels of the
// patch at (y0, x0) of images b0 .., as 4-byte words from the word that holds
// each row's first byte (C bytes a pixel make rows of any alignment), into
// raw rows of raw_rs bytes; rows outside the image are not fetched, and
// words past the plane read as zero.
__device__ __forceinline__ void load_raw_fold(uint32_t raw, const Args& a,
                                              int b0, int y0, int x0) {
  const int ph = a.th + 2, rows = a.g * ph;
  const int words = a.raw_rs / 4;
  const long long total = (long long)a.B * a.H * a.W * a.c0;
  const char* base = reinterpret_cast<const char*>(a.p0);
  for (int i = threadIdx.x; i < rows * words; i += kThreads) {
    const int row = i / words, w = i - row * words;
    const int img = row / ph, b = b0 + img, gy = y0 + row - img * ph;
    if (b >= a.B || gy < 0 || gy >= a.H) continue;
    const long long start = (((long long)b * a.H + gy) * a.W + x0) * a.c0;
    const long long at = (start & ~3LL) + 4 * w;
    const int n = at < 0 ? 0 : (int)min(4LL, max(0LL, total - at));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     raw + (uint32_t)(row * a.raw_rs + 4 * w)),
                 "l"(n > 0 ? base + at : base), "r"(n));
  }
}

// The fold's input, step two: row q is pixel q of the th x tw tile at
// (y0 + 1, x0 + 1), its 32 bytes the 9 taps x C channels of the pixel's 3 x 3
// neighbourhood (byte tap * C + c), read from the raw rows; zero from 9 * C
// on, outside the image and past the batch.
template <int R, int C>
__device__ __forceinline__ void build_fold(uint32_t dst, const uint8_t* raw,
                                           const Args& a, int b0, int y0,
                                           int x0) {
  const int per = a.th * a.tw, ph = a.th + 2;
  const SmallDiv by_per(per), by_tw(a.tw);
  for (int q = threadIdx.x; q < R; q += kThreads) {
    const int img = by_per.div(q);
    const int rem = q - img * per;
    const int r = by_tw.div(rem), c = rem - r * a.tw;
    const int b = b0 + img;
    uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (img < a.g && b < a.B && y0 + 1 + r < a.H && x0 + 1 + c < a.W) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int y = r + tap / 3, x = c + tap % 3;
        const int gy = y0 + y, gx = x0 + x;
        if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) continue;
        const long long start =
            (((long long)b * a.H + gy) * a.W + x0) * C;
        const uint8_t* p = raw + (img * ph + y) * a.raw_rs +
                           (int)(start & 3) + x * C;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const int k = tap * C + ch;
          w[k >> 2] |= uint32_t(p[ch]) << (8 * (k & 3));
        }
      }
    }
    const uint32_t lo[4] = {w[0], w[1], w[2], w[3]};
    const uint32_t hi[4] = {w[4], w[5], w[6], w[7]};
    st_shared_v4(dst + (uint32_t)q * 16, lo);
    st_shared_v4(dst + (uint32_t)(a.pitch + q) * 16, hi);
  }
}

// One chunk's packed weights (all taps, NB columns) into dst.
__device__ __forceinline__ void load_w(uint32_t dst, const int8_t* src,
                                       int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    cp_async16_to(dst + (uint32_t)i * 16, src + (size_t)i * 16, true);
}

// acc[i] += the product of one staged chunk for this warpgroup's m64 tiles
// wgi + 2 i: for each tap, A from row (wgi + 2 i) * 64 + shift of the
// staged input, B the tap's NB x 32 slice of the staged weights. Issued
// here, asynchronously; mma_wait retires them.
template <int NB, int MT, int TAPS>
__device__ __forceinline__ void mma_issue(int (&acc)[MT][NB / 2],
                                          uint32_t a_chunk, uint32_t w_chunk,
                                          int pitch, int pw, int wgi) {
  fence_acc<MT>(acc);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    const int shift = TAPS == 9 ? (tap / 3) * pw + tap % 3 : 0;
    const uint64_t db = wg_desc(w_chunk + (uint32_t)tap * NB * 32, NB);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint64_t da = wg_desc(
          a_chunk + (uint32_t)((wgi + 2 * i) * 64 + shift) * 16, pitch);
      WgS8<NB>::mma(acc[i], da, db);
    }
  }
  wgmma_commit();
}

template <int NB, int MT>
__device__ __forceinline__ void mma_wait(int (&acc)[MT][NB / 2]) {
  wgmma_wait<0>();
  fence_acc<MT>(acc);
}

// y = relu(acc * a + b), rounded step by step as the plain version rounds:
// Q1's fp32 output
__device__ __forceinline__ float epilogue_f32(int acc, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), 0.f);
}

// The accumulators through the epilogue, quantized, into the stash: row q
// of the item at stash + q * (NB + 16), column n at n.
template <int NB, int MT, bool RELU>
__device__ __forceinline__ void stash_tile(const int (&acc)[MT][NB / 2],
                                           const Args& a, uint8_t* stash,
                                           int pass, int wgi) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const Quantizer<RELU> quantize(*a.s_out);
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int n = 8 * j + col0;
    const int gn = pass * NB + n;
    const float a0 = a.a[gn], a1 = a.a[gn + 1];
    const float b0 = a.bsh[gn], b1 = a.bsh[gn + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (wgi + 2 * i) * 64 + row0 + 8 * h;
        *reinterpret_cast<char2*>(stash + q * (NB + 16) + n) = make_char2(
            quantize(acc[i][4 * j + 2 * h], a0, b0),
            quantize(acc[i][4 * j + 2 * h + 1], a1, b1));
      }
  }
}

// Where row q of a Q1 block lands: the element offset of its pixel's
// channel 0 in out, or -1 for a row that is dropped.
template <int MODE>
__device__ __forceinline__ long long q1_pixel(const Args& a, int q, int b0,
                                              int ty0, int tx0) {
  const int rw = MODE == kRaster ? a.tw + 2 : a.tw;
  const int per = (MODE == kRaster ? a.th + 2 : a.th) * rw;
  const int img = SmallDiv(per).div(q);
  const int rem = q - img * per;
  const int r = SmallDiv(rw).div(rem);
  const int c = rem - r * rw;
  const int b = b0 + img, gy = ty0 + r, gx = tx0 + c;
  if (img >= a.g || r >= a.th || c >= a.tw || b >= a.B || gy >= a.H ||
      gx >= a.W)
    return -1;
  return (((long long)b * a.H + gy) * a.W + gx) * a.cout;
}

// The stash to device memory, 16 bytes a thread: a run of 16 channels from
// packed column pass * NB + n on, the row's pixel, channels n on.
template <int NB, int MT, int MODE>
__device__ __forceinline__ void store_tile(const Args& a, const uint8_t* stash,
                                           int pass, int b0, int ty0,
                                           int tx0) {
  constexpr int R = 128 * MT;
  constexpr int upr = NB / 16;           // runs per stash row
  const bool runs = a.cout % 16 == 0;
  int8_t* out = static_cast<int8_t*>(a.out);
  for (int u = threadIdx.x; u < R * upr; u += kThreads) {
    const int q = u / upr;
    const int n = pass * NB + (u - q * upr) * 16;
    const uint8_t* src = stash + q * (NB + 16) + (n - pass * NB);
    if (n >= a.cout) continue;
    const long long pix = q1_pixel<MODE>(a, q, b0, ty0, tx0);
    if (pix < 0) continue;
    if (runs) {
      *reinterpret_cast<uint4*>(out + pix + n) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 16 && n + e < a.cout; ++e)
        out[pix + n + e] = static_cast<int8_t>(src[e]);
    }
  }
}

// Q1's fp32 output (the last decoder block's second conv, which feeds the
// head) straight from the accumulator fragments: the two threads holding
// columns 2c .. 2c + 3 of an 8-wide group swap a row's pair by one shuffle,
// so the even one writes those four columns of row g and the odd one of
// row g + 8, 16 bytes each.
template <int NB, int MT, int MODE>
__device__ __forceinline__ void store_f32(const int (&acc)[MT][NB / 2],
                                          const Args& a, const Item& it,
                                          int wgi) {
  const int lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const bool odd = lane & 1;
  // this thread's four columns from 8 j + c4
  const int c4 = 2 * (lane & 2);
  const bool runs = (a.cout & 3) == 0;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    // the row this thread writes: g for an even lane, g + 8 for an odd one
    const long long pix = q1_pixel<MODE>(
        a, (wgi + 2 * i) * 64 + row0 + (odd ? 8 : 0), it.b0, it.ty0, it.tx0);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int n_own = it.pass * NB + 8 * j + 2 * (lane & 3);
      // a and b are padded to whole passes: n_own + 1 is readable
      const float a0 = a.a[n_own], a1 = a.a[n_own + 1];
      const float b0 = a.bsh[n_own], b1 = a.bsh[n_own + 1];
      float v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h][0] = epilogue_f32(acc[i][4 * j + 2 * h], a0, b0);
        v[h][1] = epilogue_f32(acc[i][4 * j + 2 * h + 1], a1, b1);
      }
      // even lanes give their row g + 8 pair, odd ones their row g pair
      const float s0 = odd ? v[0][0] : v[1][0];
      const float s1 = odd ? v[0][1] : v[1][1];
      const float r0 = __shfl_xor_sync(0xffffffff, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffff, s1, 1);
      const float4 f = odd ? make_float4(r0, r1, v[1][0], v[1][1])
                           : make_float4(v[0][0], v[0][1], r0, r1);
      const int n = it.pass * NB + 8 * j + c4;
      if (pix < 0 || n >= a.cout) continue;
      if (runs) {
        *reinterpret_cast<float4*>(out + pix + n) = f;
      } else {
        const float e[4] = {f.x, f.y, f.z, f.w};
        for (int k = 0; k < 4 && n + k < a.cout; ++k) out[pix + n + k] = e[k];
      }
    }
  }
}

// The items of this block (blockIdx.x, + gridDim.x, ...), n_k steps each.
// Shared memory: with `resident`, every chunk of the block's pass of weights
// (the grid is then a multiple of the passes, so the pass is the same for
// all the block's items); two step buffers of buf_bytes, each a staged
// input chunk, and its weights unless they are resident; the int8 stash.
template <int NB, int MT, int MODE>
__device__ __forceinline__ void run_items(const Args& a, uint8_t* smem) {
  constexpr int TAPS = MODE == kRaster ? 9 : 1;
  constexpr int R = 128 * MT;
  constexpr uint32_t w_bytes = TAPS * NB * 32;
  const uint32_t w_res = smem_u32(smem);
  const uint32_t base = w_res + (a.stash_off - 2 * a.buf_bytes);
  const uint32_t a_bytes = 2u * a.pitch * 16;
  uint8_t* stash = smem + a.stash_off;
  // broadcast from lane 0: a value the compiler knows to be warp-uniform
  const int wgi = __shfl_sync(0xffffffff, threadIdx.x >> 7, 0);
  const int items = a.n_items > (int)blockIdx.x
                        ? (a.n_items - 1 - (int)blockIdx.x) / gridDim.x + 1
                        : 0;
  const int steps = items * a.n_k;
  auto item_of = [&](int s) {
    return decode(a, blockIdx.x + (s / a.n_k) * gridDim.x);
  };
  // step s stages into buffer s & 1: input at +0, weights (unless
  // resident) at +a_bytes
  auto stage = [&](int s) {
    const int kc = s % a.n_k;
    const Item it = item_of(s);
    const uint32_t ad = base + (s & 1) * a.buf_bytes;
    if constexpr (MODE == kRaster)
      load_a_raster(ad, a, it.b0, it.ty0 - 1, it.tx0 - 1, kc * kKC);
    else
      load_raw_fold(ad + a.raw_off, a, it.b0, it.ty0 - 1, it.tx0 - 1);
    if (!a.resident)
      load_w(ad + a_bytes,
             a.wt + ((size_t)it.pass * a.n_k + kc) * w_bytes, w_bytes);
    cp_async_commit();
  };
  int acc[MT][NB / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[i][e] = 0;
  if (steps > 0) {
    if (a.resident)  // lands with step 0
      load_w(w_res,
             a.wt + (size_t)(blockIdx.x % a.n_pass) * a.n_k * w_bytes,
             a.n_k * w_bytes);
    stage(0);
  }
  for (int s = 0; s < steps; ++s) {
    // step s has landed, every thread is done with step s - 1 (whose
    // buffer takes step s + 1), and the stash is free
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    const int kc = s % a.n_k;
    const uint32_t ad = base + (s & 1) * a.buf_bytes;
    if constexpr (MODE == kFold) {
      // the raw rows of step s have landed: fold them into its A operand
      const Item it = item_of(s);
      const uint8_t* raw = smem + (ad - w_res) + a.raw_off;
      if (a.c0 == 1)
        build_fold<R, 1>(ad, raw, a, it.b0, it.ty0 - 1, it.tx0 - 1);
      else if (a.c0 == 2)
        build_fold<R, 2>(ad, raw, a, it.b0, it.ty0 - 1, it.tx0 - 1);
      else
        build_fold<R, 3>(ad, raw, a, it.b0, it.ty0 - 1, it.tx0 - 1);
      fence_proxy_async();
      __syncthreads();
    }
    if (s + 1 < steps) stage(s + 1);
    // no other work between issue and wait: code there keeps registers
    // live, and ptxas then serialises the wgmmas (PERF.md §6)
    mma_issue<NB, MT, TAPS>(
        acc, ad, a.resident ? w_res + kc * w_bytes : ad + a_bytes, a.pitch,
        a.tw + 2, wgi);
    mma_wait<NB, MT>(acc);
    if (kc == a.n_k - 1) {
      const Item it = item_of(s);
      if (a.s_out == nullptr) {
        store_f32<NB, MT, MODE>(acc, a, it, wgi);
      } else {
        stash_tile<NB, MT, true>(acc, a, stash, it.pass, wgi);
        __syncthreads();
        store_tile<NB, MT, MODE>(a, stash, it.pass, it.b0, it.ty0, it.tx0);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NB / 2; ++e) acc[i][e] = 0;
    }
  }
}

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// A block's pass of weights stays in shared memory up to this many bytes.
constexpr int kResidentMax = 40 * 1024;

// blocks per SM the registers are bounded for: the accumulators take
// nb * mt / 2 a thread
constexpr int min_blocks(int nb, int mt) { return nb * mt <= 128 ? 2 : 1; }

template <int NB, int MT, int MODE>
__global__ void __launch_bounds__(kThreads, min_blocks(NB, MT))
int8_conv_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  run_items<NB, MT, MODE>(a, smem);
}

// As many blocks as fit on the card at once, or one per item if fewer.
template <int NB, int MT, int MODE>
int launch(Args a, long long items, cudaStream_t stream) {
  constexpr int w_bytes = (MODE == kRaster ? 9 : 1) * NB * 32;
  const int raw = MODE == kFold ? a.g * (a.th + 2) * a.raw_rs : 0;
  const int stash = align128(128 * MT * (NB + 16));
  // the layout: [resident weights] [step buffer] x 2 [stash]; the weights
  // stay when a pass of them is small and the whole still fits
  auto layout = [&](int resident) {
    a.resident = resident;
    const int w_step = resident ? 0 : w_bytes;
    a.raw_off = 2 * a.pitch * 16 + w_step;
    a.buf_bytes = align128(a.raw_off + raw);
    a.stash_off = (resident ? align128(a.n_k * w_bytes) : 0) + 2 * a.buf_bytes;
    return (size_t)a.stash_off + stash;
  };
  size_t smem = layout(a.n_k * w_bytes <= kResidentMax);
  if (smem > (size_t)kMaxSmem) smem = layout(0);
  if (smem > (size_t)kMaxSmem || items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_items = (int)items;
  const void* fn = reinterpret_cast<const void*>(int8_conv_kernel<NB, MT, MODE>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (items == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks =
      items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  // resident weights are one pass's: every item of a block has the pass of
  // its first (items are numbered pass fastest)
  if (a.resident) blocks -= blocks % a.n_pass;
  int8_conv_kernel<NB, MT, MODE><<<(unsigned)blocks, kThreads, smem,
                                   stream>>>(a);
  return (int)cudaGetLastError();
}

// The shapes the kernel is built for: (NB, MT) of the raster mode; the fold
// takes (32, 4) only.
template <int MODE>
int dispatch(const Args& a, int nb, int mt, long long items,
             cudaStream_t st) {
  if (MODE == kFold) {
    if (nb == 32 && mt == 4) return launch<32, 4, kFold>(a, items, st);
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 32 && mt == 4) return launch<32, 4, kRaster>(a, items, st);
  if (nb == 64 && mt == 2) return launch<64, 2, kRaster>(a, items, st);
  if (nb == 128 && mt == 2) return launch<128, 2, kRaster>(a, items, st);
  if (nb == 256 && mt == 1) return launch<256, 1, kRaster>(a, items, st);
  return (int)cudaErrorInvalidValue;
}

int round8(int n) { return (n + 7) / 8 * 8; }

}  // namespace

extern "C" {

// Q1. x0: (B, H, W, C0) int8; x1: (B, H, W, C1) int8 or null (C1 = 0);
// wt: the packed weights [Np / nb][Kp / 32][taps][2][nb][16] int8, input
// channel k < C0p from x0 and C0p + k from x1, zero in every padding (the
// fold: one chunk, one tap, byte tap * C0 + c); a, bsh: (Np,) fp32, zero
// padded; s_out: one fp32 scale on the device, or null for fp32 output. out:
// (B, H, W, Cout), int8 when s_out is given, else fp32. C0p and Kp are
// multiples of 32, Np of nb; th x tw tiles of g images per block (fold:
// th * tw * g <= 128 * mt pixels; raster: g (th + 2)(tw + 2) - 2 (tw + 2) - 2
// <= 128 * mt rows). A channel count that is a multiple of 16 is read 16
// bytes at a time and its plane must be 16-byte aligned, as must out.
// Returns a cudaError_t.
int pk_int8_conv3x3(const void* x0, const void* x1, const void* wt,
                    const void* a, const void* bsh, const void* s_out,
                    void* out, int B, int H, int W, int C0, int C0p, int C1,
                    int Kp, int Cout, int Np, int nb, int mt, int fold,
                    int th, int tw, int g, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (C0 <= 0 || C0 > C0p || C0p % kKC || Kp % kKC || Kp < C0p || C1 < 0 ||
      C1 > Kp - C0p || (C1 > 0) != (x1 != nullptr) || Cout <= 0 || nb <= 0 ||
      mt <= 0 || Np % nb || Cout > Np || th <= 0 || tw <= 0 || g <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = 128 * mt;
  Args args{static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1),
            static_cast<const int8_t*>(wt), static_cast<const float*>(a),
            static_cast<const float*>(bsh), static_cast<const float*>(s_out),
            out, B, H, W, C0, C0p, C1, Kp / kKC, Cout, Np / nb, th, tw, g,
            0, (W + tw - 1) / tw, (H + th - 1) / th, 0, 0, 0, 0};
  const long long items = (long long)((B + g - 1) / g) * args.tiles_y *
                          args.tiles_x * args.n_pass;
  const auto st = static_cast<cudaStream_t>(stream);
  if (fold) {
    if (C1 != 0 || C0 * 9 > kKC || Kp != kKC || th * tw * g > rows)
      return (int)cudaErrorInvalidValue;
    args.pitch = rows + 2;
    // a raw row: (tw + 2) pixels of C0 bytes from up to 3 bytes into a word
    args.raw_rs = ((tw + 2) * C0 + 3 + 3) / 4 * 4;
    return dispatch<kFold>(args, nb, mt, items, st);
  }
  const int pw = tw + 2, patch = g * (th + 2) * pw;
  if (patch - 2 * pw - 2 > rows) return (int)cudaErrorInvalidValue;
  // every row an m64 tile reaches through a tap lies inside a group; +2
  // spreads the two groups' rows over the banks
  args.pitch = round8(patch > rows + 2 * pw + 2 ? patch : rows + 2 * pw + 2) + 2;
  return dispatch<kRaster>(args, nb, mt, items, st);
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
