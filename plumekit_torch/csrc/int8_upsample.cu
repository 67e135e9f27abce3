// Q2, the int8 forward's 2x2 stride-2 transposed conv with its requant, for
// Hopper (sm_90a):
//   acc[b, i, j, di, dj, o] = sum_c x[b, i, j, c] * k[di, dj, c, o]
//   out[b, 2i + di, 2j + dj, o] = clamp(rint((float(acc) * sw[o] + bias[o])
//                                            / s), -127, 127)
// x (B, h, w, Cin) int8, out (B, 2h, 2w, Cout) int8, s one fp32 scale read
// from device memory; weights, sw and bias packed once on the host
// (models/kernels/int8_upsample.py).
//
// Replaces no Pallas kernel: the JAX package's int8 forward
// (plumekit/models/quantized_forward.py) leaves the product to an s8 einsum
// that XLA fuses with its dequant, pixel shuffle and requant (_upsample_q
// and _quant_act, :145-154 and :116-118, applied at :370-372). The plain
// version (the Python module) is torch._int_mm and eight eager passes.
//
// What bounds it on an H100: a GEMM of M = B h w pixels, K = Cin, N =
// 4 Cout columns does 8 Cin Cout operations per pixel against Cin + 4 Cout
// bytes. At 128 x 288² the four upsamples of the U-Net move 956 MB (0.29 ms
// at 3.35 TB/s) for 174 GOP (0.09 ms at 1,979 TOPS): bytes, the largest
// (Cin 512, 18²) nearly balanced.
//
// Design. Rows r = b h + i of the low-resolution plane, columns j. The GEMM
// columns are packed as n = di * Cp + dj * Cout + o (Cp: 2 Cout padded to
// whole chunks of CB bytes, CB = 32, 64 or 128), so that for one di the
// columns of a pixel are the 2 Cout bytes of output pixels (2i + di, 2j)
// and (2i + di, 2j + 1), side by side in device memory: the pixel shuffle
// is an address, and the output of a block of pixels is a box of the
// (R, 2, w, 2 Cout) view of out.
//   * An item is a k x n block of the plane (k rows, n = 1, 2, 4, 8 or 16
//     columns, k n = 64 MT GEMM rows; models/kernels/int8_upsample.
//     item_block picks it: 32 x 2 at w = 18, 8 x 8 at w = 72, none of the
//     network's rows wasted), all of a slice's columns.
//   * A block holds a slice of S columns of weights in shared memory for the
//     whole launch (up to 128 KB; the rule takes at most 64 KB: Cin 512
//     eight slices of 128 columns, Cin 256 two of 256, else one). The
//     blocks of a slice group take the same item side by side, so its
//     input (21 MB at most, Cin 512) reaches them through L2; with one
//     slice each input byte is read once.
//   * Input by TMA: a 3-d tensor map over (Cin, w, R), box (KB, n, k), the
//     KB-byte swizzle (KB = 32, 64 or 128 channels a chunk) that the K-major
//     wgmma descriptor reads; a ring of up to 12 stages on full/empty
//     mbarriers, fed by one producer warp.
//   * Two or three consumer warpgroups (two where the accumulators take 128
//     registers a thread), each its own items and accumulators (64 MT rows
//     by NB columns), so that their epilogues overlap the others' wgmmas; a
//     slice of more than NB columns takes several passes over the item's
//     staged input. A consumer waits for an item's input only after the
//     consumer of the item before saw its own land (a turn mbarrier each):
//     TMA copies land in any order, and a wait by the parity of a stage's
//     use is right only once the use before it has landed.
//   * Epilogue: the requant of int8_wgmma.cuh, rounded step by step as the
//     plain version rounds (the clamp of y to +-128 s left out where no y
//     of the slice can overflow the quotient: the same results, two
//     operations fewer), into a swizzled output tile in shared memory
//     (every warp store one wavefront). Thread 0's warp waits for the other
//     warps' rows and stores the item by TMA, one box (CB, n, 1, k) per
//     chunk, clipped at the plane's edges; the others go on to the next
//     item's wgmmas; a buffer is written again once its stores have read it
//     (two buffers a consumer where they fit).
//   * Persistent grid: one block per SM; the producer's warpgroup hands its
//     registers to the consumers (setmaxnreg).
//   * Channel counts off the chunks (Cin not 32, 64 or a multiple of 128;
//     2 Cout not a whole number of chunks; Cout not a multiple of 16) or a
//     plane off 16 bytes: the same kernel with the producer warp staging the
//     input by plain loads and the consumers writing their outputs byte by
//     byte, chosen by shape before the launch. The network's channel counts
//     never take it.
// What holds it back at 128 x 288² (PERF.md §6, experiments/int8_variants.py
// and the clock stamps of experiments/int8_conv_times.py --upsamples): the
// epilogue's 13 instructions a result take 40-50% of a consumer's time, and
// the wgmma phase, which the other consumers' epilogues do not hide.
// Plain interface for ctypes; a launch returns its cudaError_t.

#include <cuda.h>

#include "conv_tiles.cuh"
#include "int8_wgmma.cuh"

namespace {

using pk::bulk_copy;
using pk::fence_acc;
using pk::fence_proxy_async;
using pk::mbar_arrive;
using pk::mbar_expect_tx;
using pk::mbar_init;
using pk::Quantizer;
using pk::smem_u32;
using pk::wgmma_commit;
using pk::wgmma_fence;
using pk::wgmma_wait;
using pk::WgS8;

// consumer warpgroups of a shape: three where the accumulators take at
// most 64 registers a thread, else two; and the producer's warpgroup
__host__ __device__ constexpr int consumers_of(int nb, int mt) {
  return nb * mt <= 128 ? 3 : 2;
}
__host__ __device__ constexpr int threads_of(int nb, int mt) {
  return 128 * (consumers_of(nb, mt) + 1);
}
constexpr int kMaxSmem = 232448;                 // 227 KB opt-in limit
constexpr int kMaxStages = 12;
constexpr int kMaxWeights = 128 * 1024;          // a block's slice
constexpr int kAlign = 1024;                     // a swizzle pattern repeats
constexpr int kStampPasses = 64;                 // passes a consumer stamps
constexpr int kStampPoints = 7;                  // and the clocks of each

struct Params {
  CUtensorMap x_map;    // (Cin, w, R) bytes, box (KB, n, k)
  CUtensorMap out_map;  // (2 Cout, w, 2, R) bytes, box (CB, n, 1, k)
  const int8_t* x;
  const int8_t* wt;     // [slice][chunk][S][KB], each KB-byte row swizzled
  const float* a;       // sw per packed column
  const float* bsh;     // bias per packed column
  const float* s_out;
  int8_t* out;
  long long* stamps;    // null, or kStampPasses x kStampPoints clocks a
                        // consumer
  int R, w, cin, cout;  // rows B h of the plane, its width, channels
  int n, k;             // an item: k rows x n columns of the plane
  int col_blocks;       // items across a row
  int items;
  int slices, S, passes, n_k, kb, cb, n_cc;
  int stages, bufs, fast;
  int w_off, a_off, o_off, ab_off, bar_off;
};

// 16-byte chunk c of row `line` of a tile of rows of `width` bytes (32, 64
// or 128) starting on a 1024-byte boundary, as TMA and the wgmma
// descriptor swizzle it: the chunk index XOR bits 7.. of the row's offset.
__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t width) {
  return off ^ (((off >> 7) & (width / 16 - 1)) << 4);
}

// K-major operand, the width-byte swizzle: 8-row groups 8 * width apart.
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t width) {
  const uint64_t layout = width == 128 ? 1 : (width == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * width / 16) << 32) | (layout << 62);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores committed before the last `n` groups have read shared memory
__device__ __forceinline__ void bulk_wait_read(int n) {
  if (n == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Returns once the barrier's phase of this parity has completed; a wait of
// more than 2^34 clocks (about 10 s) traps, so that a fault of the ring is
// a launch error and not a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = -1;
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
    if (!done) {
      const long long now = clock64();
      if (t0 < 0)
        t0 = now;
      else if (now - t0 > (1LL << 34))
        __trap();
    }
  } while (!done);
}

// Named barriers of the 128 threads of consumer warpgroup g (barrier 0 is
// __syncthreads): 1 + g, where they all meet; 1 + C + g, where thread 0's
// warp waits for the others' epilogues and those arrive and go on.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void item_origin(const Params& p, int item,
                                            int& r0, int& j0) {
  const int rb = item / p.col_blocks;
  r0 = rb * p.k;
  j0 = (item - rb * p.col_blocks) * p.n;
}

// Chunk c of an item into a stage by plain loads (the slow path): row q of
// the stage is pixel (r0 + q / n, j0 + q % n), its kb bytes channels
// [c kb, c kb + kb), zero outside the plane and past Cin; the whole warp.
__device__ void load_a_plain(uint32_t dst, const Params& p, int r0, int j0,
                             int c, int rows) {
  const int parts = p.kb / 16;
  for (int e = threadIdx.x & 31; e < rows * parts; e += 32) {
    const int q = e / parts, part = e - q * parts;
    const int r = r0 + q / p.n, j = j0 + q % p.n;
    const int ch = c * p.kb + part * 16;
    const bool inside = q < p.n * p.k && r < p.R && j < p.w;
    const int8_t* s = p.x + ((size_t)r * p.w + j) * p.cin + ch;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (inside && ch + b < p.cin)
        v[b >> 2] |= uint32_t(uint8_t(s[b])) << (8 * (b & 3));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + swz((uint32_t)(q * p.kb + part * 16), p.kb)),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// The producer warp: the slice's weights once, then every chunk of every
// item of this block into the ring, in item order.
template <int MT>
__device__ void produce(const Params& p, uint32_t base, int slice, int first,
                        int stride, int my_items) {
  constexpr int RM = 64 * MT;
  const int lane = threadIdx.x & 31;
  const uint32_t bars = base + p.bar_off;
  const uint32_t wbar = bars + 16 * kMaxStages;
  const uint32_t a_bytes = RM * p.kb;
  if (lane == 0) {
    const uint32_t bytes = (uint32_t)p.n_k * p.S * p.kb;
    const int8_t* src = p.wt + (size_t)slice * bytes;
    mbar_expect_tx(wbar, bytes);
    for (uint32_t off = 0; off < bytes; off += 16384)
      bulk_copy(base + p.w_off + off, src + off,
                bytes - off < 16384 ? bytes - off : 16384, wbar);
  }
  for (int t = 0; t < my_items; ++t) {
    int r0, j0;
    item_origin(p, first + t * stride, r0, j0);
    for (int c = 0; c < p.n_k; ++c) {
      const int g = t * p.n_k + c;
      const int slot = g % p.stages, use = g / p.stages;
      const uint32_t full = bars + 8 * slot;
      const uint32_t empty = bars + 8 * (kMaxStages + slot);
      if (use > 0) mbar_wait(empty, (use - 1) & 1);
      const uint32_t dst = base + p.a_off + slot * a_bytes;
      if (p.fast) {
        if (lane == 0) {
          mbar_expect_tx(full, (uint32_t)(p.kb * p.n * p.k));
          tma_load_3d(dst, &p.x_map, c * p.kb, j0, r0, full);
        }
      } else {
        load_a_plain(dst, p, r0, j0, c, RM);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
      }
    }
  }
}

// clamp(rint(y / s), -127, 127) of y = float(acc) * a + b, as Quantizer
// rounds it; returns the bits of the rounded float, whose low byte is the
// int8 result (the bits are 0x4B400000 + result). CLAMP_Y: y is first
// clamped to +-128 s as Quantizer does, which only keeps the quotient
// finite; without it (where no y of the slice can overflow the quotient,
// `no_overflow`) every result is the same, two operations fewer.
template <bool CLAMP_Y>
__device__ __forceinline__ uint32_t requant_bits(const Quantizer<false>& qz,
                                                 int acc, float a, float b) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
  if constexpr (CLAMP_Y) y = fminf(fmaxf(y, -qz.hi), qz.hi);
  const float q0 = __fmul_rn(y, qz.r);
  float q = __fmaf_rn(__fmaf_rn(-qz.s, q0, y), qz.r, q0);
  q = __fmaf_rn(__fmaf_rn(-qz.s, q, y), qz.r, q);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(q, -127.f), 127.f), 12582912.f));
}

// The epilogue of one pass: each thread's accumulators requantized into
// the output tile `ot` (chunk n / cb of the pass at n / cb RM cb, row q at
// q cb, swizzled), two columns a 16-bit store. ab: the slice's (sw, bias)
// pairs of columns.
template <bool CLAMP_Y, int NB, int MT>
__device__ __forceinline__ void epilogue(const int (&acc)[MT][NB / 2],
                                         const Quantizer<false>& qz,
                                         const float4* ab, uint32_t ot,
                                         int pp, int col0, int cb,
                                         int cb_log, uint32_t sub_skip,
                                         const uint32_t (&q_off)[MT][2],
                                         const uint32_t (&q_swz)[MT][2]) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int n = 8 * j + col0;  // this pass's columns n, n + 1
    // sw of n and n + 1, bias of n and n + 1
    const float4 f = ab[(pp * NB + n) >> 1];
    // chunk n / cb of the pass starts n / cb (RM - 1) cb bytes further on
    const uint32_t col = (uint32_t)n + (uint32_t)(n >> cb_log) * sub_skip;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo =
            requant_bits<CLAMP_Y>(qz, acc[i][4 * j + 2 * h], f.x, f.z);
        const uint32_t hi =
            requant_bits<CLAMP_Y>(qz, acc[i][4 * j + 2 * h + 1], f.y, f.w);
        // no memory clobber: the loads of ab may move past it
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                         ot + q_off[i][h] + (col ^ q_swz[i][h])),
                     "h"((unsigned short)__byte_perm(lo, hi, 0x0040)));
      }
  }
}

// One consumer warpgroup of C: items g, g + C, ... of this block; per item
// and pass, the wgmmas over every chunk, then the epilogue into an output
// buffer and its stores. The consumers wait for their items' chunks in
// item order, each after the one before has seen its own land (the turn
// barriers): a stage's use before is then complete, so that the parity of
// a wait names the use it is meant for (copies land in any order). A
// warpgroup's warps meet once an item, after its thread 0 took the turn.
template <int NB, int MT, int KS>
__device__ void consume(const Params& p, uint8_t* sm, uint32_t base,
                        int slice, int first, int stride, int my_items,
                        int g) {
  constexpr int RM = 64 * MT;
  constexpr int KB = 32 * KS;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const uint32_t bars = base + p.bar_off;
  const uint32_t wbar = bars + 16 * kMaxStages;
  const uint32_t a_bytes = RM * KB;
  const uint32_t out_bytes = RM * NB;
  constexpr int C = consumers_of(NB, MT);
  const uint32_t turns = bars + 8 * (2 * kMaxStages + 1);
  const float4* ab = reinterpret_cast<const float4*>(sm + p.ab_off);
  const Quantizer<false> qz(*p.s_out);
  // no y of the slice overflows the quotient: |acc| <= 16384 Cin; a NaN or
  // infinite bound (of a, b or 1 / s) keeps the clamp
  const int* ab_max = reinterpret_cast<const int*>(sm + p.ab_off + 8 * p.S);
  const bool no_overflow =
      __fmul_rn(__fadd_rn(__fmul_rn(16384.f * p.cin,
                                    __int_as_float(ab_max[0])),
                          __int_as_float(ab_max[1])),
                fmaxf(qz.r, 1.f)) < 0x1p120f;
  // this thread's rows of each m64 tile, and their offsets in a chunk of
  // the output tile: row q at q cb, its swizzle term
  const int row0 = (tid >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int cb = p.cb;
  const int cb_log = cb == 128 ? 7 : (cb == 64 ? 6 : 5);
  const uint32_t sub_bytes = (uint32_t)RM * cb;
  const uint32_t sub_skip = sub_bytes - cb;
  uint32_t q_off[MT][2], q_swz[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = (uint32_t)(i * 64 + row0 + 8 * h) * cb;
      q_off[i][h] = off;
      q_swz[i][h] = ((off >> 7) & (cb / 16 - 1)) << 4;
    }
  int acc[MT][NB / 2];
  int buf = 0;
  // block 0's consumers stamp their first passes: start, its turn come,
  // first chunk landed, wgmmas done, output buffer free, epilogue done,
  // stores issued
  long long* stamp = p.stamps != nullptr && blockIdx.x == 0 && tid == 0
                         ? p.stamps + g * kStampPasses * kStampPoints
                         : nullptr;
  int stamped = 0;
  auto mark = [&](int k) {
    if (stamp != nullptr && stamped < kStampPasses)
      stamp[stamped * kStampPoints + k] = clock64();
  };
  mbar_wait(wbar, 0);
  for (int t = g; t < my_items; t += C) {
    int r0, j0;
    item_origin(p, first + t * stride, r0, j0);
    mark(0);
    // item t - 1's chunks have landed (its consumer's thread 0 saw them);
    // one thread waits, so that no warp of a warpgroup that lags behind
    // its others can take a later phase of the turn for the one it needs
    if (tid == 0) {
      if (t > 0) mbar_wait(turns + 8 * ((t - 1) % C), ((t - 1) / C) & 1);
      // and the output buffers' stores of two passes before have read them
      if (p.fast) bulk_wait_read(p.bufs - 1);
    }
    bar_sync(1 + g);
    for (int pp = 0; pp < p.passes; ++pp) {
      if (pp > 0) mark(0);
      mark(1);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NB / 2; ++e) acc[i][e] = 0;
      for (int c = 0; c < p.n_k; ++c) {
        const int gs = t * p.n_k + c;
        const int slot = gs % p.stages;
        if (pp == 0) {
          mbar_wait(bars + 8 * slot, (gs / p.stages) & 1);
          // every chunk of item t has landed: item t + 1's consumer may
          // wait for its own
          if (c == p.n_k - 1 && tid == 0) mbar_arrive(turns + 8 * g);
        }
        if (c == 0) mark(2);
        const uint32_t at = base + p.a_off + slot * a_bytes;
        const uint32_t wt =
            base + p.w_off + (uint32_t)(c * p.S + pp * NB) * KB;
        fence_acc<MT>(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const uint64_t db = desc_sw(wt + 32 * s, KB);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            WgS8<NB>::mma(acc[i], desc_sw(at + i * 64 * KB + 32 * s, KB), db);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<MT>(acc);
        // the last pass over the item frees its stages, one arrival a warp
        if (pp == p.passes - 1 && lane == 0)
          mbar_arrive(bars + 8 * (kMaxStages + slot));
      }
      mark(3);
      const uint32_t ot = base + p.o_off + (g * p.bufs + buf) * out_bytes;
      auto requant = [&](uint32_t tile, int pass) {
        if (no_overflow)
          epilogue<false, NB, MT>(acc, qz, ab, tile, pass, col0, cb, cb_log,
                                  sub_skip, q_off, q_swz);
        else
          epilogue<true, NB, MT>(acc, qz, ab, tile, pass, col0, cb, cb_log,
                                 sub_skip, q_off, q_swz);
      };
      const int sub0 = (slice * p.S + pp * NB) / cb;
      // the output buffer is free once the stores of two passes before
      // (one with one buffer) have read it: thread 0 waited at the item's
      // start, where the warpgroup met; a later pass waits again
      if (pp > 0) {
        if (p.fast && tid == 0) bulk_wait_read(p.bufs - 1);
        bar_sync(1 + g);
      }
      mark(4);
      requant(ot, pp);
      mark(5);
      if (p.fast) {
        // thread 0's warp waits for the other warps' rows, then stores the
        // item, one box (cb, n, 1, k) a chunk; the other warps go on (a
        // warp must not arrive twice in one phase of a barrier: this one
        // is not the one where the warpgroup meets)
        fence_proxy_async();
        if (tid < 32) {
          bar_sync(1 + C + g);
          if (tid == 0) {
            for (int st = 0; st < NB / cb; ++st) {
              const int gsub = sub0 + st;
              const int di = gsub / p.n_cc;
              tma_store_4d(&p.out_map, ot + st * sub_bytes,
                           (gsub - di * p.n_cc) * cb, j0, di, r0);
            }
            bulk_commit();
          }
        } else {
          bar_arrive(1 + C + g);
        }
      } else {
        bar_sync(1 + g);
        {
          // the slow path: byte by byte, inside the plane and 2 Cout only
          const int lines = p.n * p.k;
          const int two_c = 2 * p.cout;
          for (int e = tid; e < (NB / cb) * lines * cb; e += 128) {
            const int st = e / (lines * cb);
            const int rem = e - st * lines * cb;
            const int q = rem >> cb_log, byte = rem & (cb - 1);
            const int gsub = sub0 + st;
            const int di = gsub / p.n_cc;
            const int col = (gsub - di * p.n_cc) * cb + byte;
            const int r = r0 + q / p.n, jj = j0 + q % p.n;
            if (col >= two_c || r >= p.R || jj >= p.w) continue;
            p.out[((size_t)(2 * r + di) * p.w + jj) * two_c + col] =
                static_cast<int8_t>(sm[(ot - base) + st * sub_bytes +
                                       swz((uint32_t)(q * cb + byte), cb)]);
          }
        }
      }
      mark(6);
      ++stamped;
      buf = buf + 1 == p.bufs ? 0 : buf + 1;
    }
  }
  if (p.fast && tid == 0) bulk_wait_all();
}

template <int NB, int MT, int KS>
__global__ void __launch_bounds__(threads_of(NB, MT), 1)
int8_upsample_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t* sm = smem_raw + (base - raw);
  const int slice = blockIdx.x % p.slices;
  const int stride = gridDim.x / p.slices;
  const int first = blockIdx.x / p.slices;
  const int my_items =
      first < p.items ? (p.items - 1 - first) / stride + 1 : 0;
  const uint32_t bars = base + p.bar_off;
  constexpr int C = consumers_of(NB, MT);
  // the slice's epilogue factors, (sw, bias) of each pair of columns as
  // one float4, then the largest |sw| and |bias| (as ints: non-negative
  // floats order as their bits)
  float* ab = reinterpret_cast<float*>(sm + p.ab_off);
  int* ab_max = reinterpret_cast<int*>(sm + p.ab_off + 8 * p.S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                         // the producer
      mbar_init(bars + 8 * (kMaxStages + s), 4);          // a consumer's warps
    }
    mbar_init(bars + 16 * kMaxStages, 1);                 // the weights
    for (int g = 0; g < C; ++g)                           // the turns
      mbar_init(bars + 8 * (2 * kMaxStages + 1 + g), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ab_max[0] = ab_max[1] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.S; i += threads_of(NB, MT)) {
    const float a = p.a[slice * p.S + i], b = p.bsh[slice * p.S + i];
    ab[(i >> 1) * 4 + (i & 1)] = a;
    ab[(i >> 1) * 4 + 2 + (i & 1)] = b;
    atomicMax(ab_max, __float_as_int(fabsf(a)));
    atomicMax(ab_max + 1, __float_as_int(fabsf(b)));
  }
  __syncthreads();
  if (my_items == 0) return;
  const int warp = threadIdx.x >> 5;
  if (warp >= 4 * C) {
    // the producer's warpgroup gives its registers to the consumers; one
    // warp of it loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * C)
      produce<MT>(p, base, slice, first, stride, my_items);
  } else {
    if constexpr (C == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    consume<NB, MT, KS>(p, sm, base, slice, first, stride, my_items,
                        warp >> 2);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once through the runtime's
// entry-point query (the library does not link libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int width) {
  return width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : CU_TENSOR_MAP_SWIZZLE_32B);
}

int encode(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box, int width) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(width),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

template <int NB, int MT, int KS>
int launch(Params p, cudaStream_t stream) {
  constexpr int RM = 64 * MT;
  constexpr int C = consumers_of(NB, MT);
  constexpr int kThreads = threads_of(NB, MT);
  const size_t w_bytes = (size_t)p.n_k * p.S * p.kb;
  const size_t a_bytes = (size_t)RM * p.kb;
  const size_t o_bytes = (size_t)RM * NB;
  const size_t ab_bytes = align_up(8 * (size_t)p.S + 8, 128);
  const size_t bar_bytes = 8 * (2 * kMaxStages + 1 + C);
  // [weights][stages][output buffers][sw, bias, their largest][mbarriers],
  // 1024-aligned from the first; two output buffers a consumer where four
  // stages still fit, else one; as many stages as fit, up to twelve. A
  // slice of several passes holds its item's n_k stages to its last pass.
  const int min_stages = p.passes > 1 ? p.n_k : 1;
  auto layout = [&](int bufs) {
    p.bufs = bufs;
    p.w_off = 0;
    p.a_off = (int)align_up(w_bytes, kAlign);
    const size_t fixed = kAlign + p.a_off + C * bufs * o_bytes +
                         ab_bytes + bar_bytes;
    const long long room = (long long)kMaxSmem - (long long)fixed;
    p.stages = room < (long long)a_bytes
                   ? 0
                   : (int)(room / (long long)a_bytes < kMaxStages
                               ? room / (long long)a_bytes
                               : kMaxStages);
    p.o_off = p.a_off + p.stages * (int)a_bytes;
    p.ab_off = p.o_off + C * bufs * (int)o_bytes;
    p.bar_off = p.ab_off + (int)ab_bytes;
    return (size_t)kAlign + p.bar_off + bar_bytes;
  };
  size_t smem = layout(2);
  if (p.stages < (4 > min_stages ? 4 : min_stages)) smem = layout(1);
  if (p.stages < min_stages || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(int8_upsample_kernel<NB, MT, KS>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every slice in each group of `slices` blocks; no more groups than items
  long long groups = (long long)sms * per_sm / p.slices;
  if (groups < 1) groups = 1;
  if (groups > p.items) groups = p.items;
  int8_upsample_kernel<NB, MT, KS>
      <<<(unsigned)(groups * p.slices), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The shapes the kernel is built for: NB columns a pass over MT m64 tiles
// (the accumulators take NB MT / 2 registers a thread: 128 with two
// consumers, 64 with three), and KS k32 steps a chunk.
int dispatch(const Params& p, int nb, int mt, cudaStream_t st) {
  const int ks = p.kb / 32;
#define PK_Q2(NB_, MT_)                                        \
  if (nb == NB_ && mt == MT_) {                                \
    if (ks == 1) return launch<NB_, MT_, 1>(p, st);            \
    if (ks == 2) return launch<NB_, MT_, 2>(p, st);            \
    if (ks == 4) return launch<NB_, MT_, 4>(p, st);            \
  }
  PK_Q2(64, 2)
  PK_Q2(128, 1)
  PK_Q2(128, 2)
  PK_Q2(256, 1)
#undef PK_Q2
  return (int)cudaErrorInvalidValue;
}

int chunk_width(int bytes) { return bytes <= 32 ? 32 : (bytes <= 64 ? 64 : 128); }

}  // namespace

extern "C" {

// Q2. x: (B, h, w, Cin) int8; wt: the packed weights [slices][Kp / kb][S]
// [kb], column n of a slice at row n of each chunk, the kb bytes of a row
// swizzled as the kernel's shared memory holds them (kb = 32, 64 or 128 for
// Cin up to 32, up to 64 and beyond, Kp = Cin padded to kb), packed column
// di * Cp + dj * Cout + o with Cp = 2 Cout padded to its chunk width cb
// (32, 64 or 128), zero in every padding; a, bsh: (slices * S,) fp32, sw
// and bias per packed column; s_out: one fp32 scale on the device. out:
// (B, 2h, 2w, Cout) int8. nb: columns a pass (64, 128 or 256, dividing S);
// mt: m64 tiles an item (1 or 2; nb mt <= 256); an item is k rows by n
// columns of the plane, n k <= 64 mt. stamps: null, or 3 x 64 x 7 int64
// that block 0's consumers fill with the clocks of their first 64 passes
// (start, turn come, first chunk landed, wgmmas done, output buffer free,
// epilogue done, stores issued).
// Returns a cudaError_t.
int pk_int8_upsample2x2(const void* x, const void* wt, const void* a,
                        const void* bsh, const void* s_out, void* out, int B,
                        int h, int w, int Cin, int Cout, int slices, int S,
                        int kb, int nb, int mt, int n, int k, void* stamps,
                        void* stream) {
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  const int rm = 64 * mt;
  const int cb = chunk_width(2 * Cout);
  const int n_cc = (2 * Cout + cb - 1) / cb;
  const long long R = (long long)B * h;
  if (Cin <= 0 || Cout <= 0 || s_out == nullptr || kb != chunk_width(Cin) ||
      slices <= 0 || S <= 0 || S % nb || slices * S != 2 * n_cc * cb ||
      (size_t)S * ((Cin + kb - 1) / kb) * kb > (size_t)kMaxWeights || n <= 0 ||
      k <= 0 || n > 256 || k > 256 || n * k > rm || nb % cb || mt <= 0 ||
      R * w >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.a = static_cast<const float*>(a);
  p.bsh = static_cast<const float*>(bsh);
  p.s_out = static_cast<const float*>(s_out);
  p.out = static_cast<int8_t*>(out);
  p.stamps = static_cast<long long*>(stamps);
  p.R = (int)R;
  p.w = w;
  p.cin = Cin;
  p.cout = Cout;
  p.n = n;
  p.k = k;
  p.col_blocks = (w + n - 1) / n;
  const long long items = (R + k - 1) / k * p.col_blocks;
  if (items >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.slices = slices;
  p.S = S;
  p.passes = S / nb;
  p.kb = kb;
  p.n_k = (Cin + kb - 1) / kb;
  p.cb = cb;
  p.n_cc = n_cc;
  // by TMA where the channels fill whole chunks and the planes are 16-byte
  // aligned; else the plain loads and stores
  p.fast = Cin == p.n_k * kb && 2 * Cout == n_cc * cb && Cout % 16 == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (p.fast) {
    const cuuint64_t xd[3] = {(cuuint64_t)Cin, (cuuint64_t)w, (cuuint64_t)R};
    const cuuint64_t xs[2] = {(cuuint64_t)Cin, (cuuint64_t)w * Cin};
    const cuuint32_t xb[3] = {(cuuint32_t)kb, (cuuint32_t)n, (cuuint32_t)k};
    int err = encode(&p.x_map, x, 3, xd, xs, xb, kb);
    if (err) return err;
    const cuuint64_t od[4] = {(cuuint64_t)2 * Cout, (cuuint64_t)w, 2,
                              (cuuint64_t)R};
    const cuuint64_t os[3] = {(cuuint64_t)2 * Cout, (cuuint64_t)2 * w * Cout,
                              (cuuint64_t)4 * w * Cout};
    const cuuint32_t ob[4] = {(cuuint32_t)cb, (cuuint32_t)n, 1,
                              (cuuint32_t)k};
    err = encode(&p.out_map, out, 4, od, os, ob, cb);
    if (err) return err;
  }
  return dispatch(p, nb, mt, static_cast<cudaStream_t>(stream));
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
