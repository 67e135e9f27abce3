// The whole U-Net inference forward in one kernel launch for Hopper (sm_90a):
// 2*depth + 1 double convs (3x3 + folded BatchNorm + ReLU, twice), depth 2x2
// max pools, depth 2x2 / stride-2 transposed convs with bias, concat-free
// skip joins and the 1x1 fp32 head. NHWC, bf16 activations, fp32
// accumulation, fp32 logits.
//
// Replaces the Pallas TPU kernel plumekit/models/pallas/unet_mega.py
// mega_forward (:364, pallas_call :565). It computes the same function and
// rounds at the same points; it is not the same program. The TPU kernel runs
// one tile per grid step with every weight and activation in VMEM. Here the
// flagship net's weights (15.5 MB in bf16) and a 96 x 96 x 32 level-0 plane
// (590 KB) exceed an SM's 227 KB of shared memory, so weights stream from L2
// and the activation pyramid lives in a device-memory scratch buffer that
// the wrapper allocates; what stays on chip is each double conv's
// intermediate, as in fused_double_conv.cu.
//
// Design: one persistent cooperative kernel, one stage per double conv.
//   * A stage's items are (image group, output tile) pairs; block i takes
//     items i, i + gridDim.x, ... and runs the double conv of
//     conv_tiles.cuh on each, on the path and with the tile and the images
//     per item that the fused double conv takes for the stage's shape (the
//     wrapper's plan carries them from models/kernels/conv_tiles.py): above
//     64 mid channels the wgmma path, its tiles picked to fill the plane
//     (12 x 12 on 24 x 24 and 12 x 12 planes, two 6 x 6 images per item at
//     the bottleneck of a 96 x 96 tile), else mma.sync on 16 x 16 tiles.
//   * A stage with fewer than half as many items as the grid has blocks
//     (the bottleneck of 128 tiles of 96 x 96: 64 items for 132 SMs) gives
//     each item to two blocks: both run the first conv, each half of the
//     second conv's 128-channel passes, then half of the pool's channels or
//     of the upsample's columns. The upsample needs both halves: the pair
//     meets at a counter (red.release / ld.acquire); all half-items run in
//     the grid's first round, so neither waits on a block that waits.
//   * An encoder item max-pools its own tiles (they start at even pixels,
//     so every 2x2 window lies inside one) into the next level's input
//     plane; on the mma.sync path from the tile it kept in shared memory
//     (the input chunk buffers, idle in the second conv), which it also
//     stores as whole 16-byte runs.
//   * A bottleneck or decoder item then upsamples its own tiles: a (pixels
//     x Cin) @ (Cin x 4*Cout) product on the wgmma path as a conv of one
//     tap, each tap's result rounded to bf16, the bf16 bias added in bf16.
//     Its A operand lies in shared memory for every chunk: the mma.sync
//     path's kept tile as it is, else all the tile's channels staged once
//     over the dead ring tile. Each pass of 128 columns is staged in shared
//     memory and written as 16-byte runs of the 2x2 output pixels.
//   * A decoder block's first conv reads its input channels from two planes,
//     the skip and the upsampled one (ConvSrc), into one fp32 accumulator.
//   * The last decoder block keeps its result in fp32 and multiplies it by
//     the head in its epilogue: only the logits are written.
//   * cooperative_groups::this_grid().sync() separates the stages: a stage
//     reads its neighbours' halo pixels of the stage before. A plane whose
//     last reader has run gives its room to a later plane (the wrapper's
//     plan), so every activation read goes through L2 (cp.async.cg,
//     ld.global.cg), never a load that could meet a stale line in its
//     SM's L1. The launch is cudaLaunchCooperativeKernel with a grid no
//     larger than what is co-resident (SMs x occupancy at the opted-in
//     shared memory).
//   * compute_dtype="float32" runs a second kernel of this file, the fp32
//     body (below): the same stages in one cooperative launch, FFMA on the
//     CUDA cores.
//
// What bounds it on an H100: the arithmetic (about 3.4 GFLOP per 96 x 96
// tile of the base-32, depth-4 net) against 57 KB of compulsory traffic per
// tile plus the weights once: operations, by two orders of magnitude. The
// kernel reaches a fraction of the tensor-core rate for the reasons given in
// fused_double_conv.cu (weights re-read from L2 per item, the ring's
// recompute, raster rows padded to 64), one block of 255 registers per SM,
// and each item's serial phases (pool, upsample) that nothing overlaps.
// experiments/mega_stage_times.py times it stage by stage.
// Plain interface for ctypes; the launch returns its cudaError_t.

#include <cooperative_groups.h>

#include "conv_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pk;

constexpr int kMaxStages = 17;  // depth <= 8
constexpr int kPlanFields = 34;
constexpr int kTile = 16;  // the mma.sync path's tile
constexpr int kKC = 32;
// bf16 per row of an upsample pass staged in shared memory: 128 columns and
// 8 more, so that the epilogue's 4-byte writes hit 32 different banks
constexpr int kUpRow = kWgN + 8;
// pixels per channel group of the mma.sync path's kept 16 x 16 tile:
// wg_a_pitch(256, 256, 0, 1), so that the tile is also the upsample's A
constexpr int kKeepPitch = 258;
enum StageKind { kPool = 0, kUp = 1, kHead = 2 };

struct MegaStage {
  ConvSrc src;
  DoubleConvWeights w;
  uint16_t* out;        // (B, H, W, Cout) bf16; null for the head stage
  uint16_t* aux;        // kPool: (B, H/2, W/2, Cout); kUp: (B, 2H, 2W, up_cout)
  const uint16_t* upw;  // weight stream of the (up_kp x 4 * up_cout_p)
                        // product: column tap * up_cout_p + co
  const uint16_t* upb;  // (up_cout_p,)
  HeadArgs head;
  int* flags;           // split kUp stage: a counter per item, which the
                        // kernel zeroes before its first grid barrier
  int kind, H, W, up_cout, up_cout_p, up_kp;
  int path;             // 1: wgmma, 0: mma.sync on 16 x 16 tiles
  int split;            // 2: each item's output channels go to two blocks
  int rows;             // kUp: the upsample reads its A from shared memory
  WgTile tile;          // output tile and images of one item
};

// Per block and stage, five stamps (only pk_unet_mega_stamps asks for them,
// on the lean kernel's plans):
// %globaltimer at the stage's start and end, clock64 at both and the clock64
// cycles the block spent in its items' double convs.
constexpr int kStampFields = 5;

struct MegaParams {
  MegaStage st[kMaxStages];
  int n_stages;
  int B;
  unsigned long long* stamps;  // the stamps instantiation's output
};
static_assert(sizeof(MegaParams) <= 4096, "kernel parameters hold 4 KB");

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint4 max_bf16x8(uint4 a, uint4 b) {
  return make_uint4(max_bf16x2(a.x, b.x), max_bf16x2(a.y, b.y),
                    max_bf16x2(a.z, b.z), max_bf16x2(a.w, b.w));
}

// 16 bytes to an address that is 16-byte aligned where C % 8 == 0, else
// the first n < 8 of its bf16 one by one
__device__ __forceinline__ void store8(uint16_t* dst, uint4 v, int n, int C) {
  if ((C & 7) == 0) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
    for (int j = 0; j < n && j < 8; ++j) dst[j] = e[j];
  }
}

// 2x2 max pool of channels [c_lo, c_hi) of the th x tw tile at (ty0, tx0)
// of image b of plane (B, H, W, C), which this block has just written, into
// pooled (B, H/2, W/2, C). H, W, th, tw, ty0 and tx0 are even; c_lo and,
// unless it is C, c_hi are multiples of 8.
__device__ __forceinline__ void pool_tile(const uint16_t* plane,
                                          uint16_t* pooled, int C, int c_lo,
                                          int c_hi, int b, int H, int W,
                                          int ty0, int tx0, int th, int tw) {
  const int PW = tw / 2;
  const int PP = (th / 2) * PW;
  const int Hp = H / 2;
  const int Wp = W / 2;
  const int nc = c_hi - c_lo;
  const size_t row = (size_t)W * C;
  if ((C & 7) == 0) {
    const int vec = nc >> 3;
    for (int i = threadIdx.x; i < PP * vec; i += kThreads) {
      const int v = i % vec;
      const int pp = i / vec;
      const int py = ty0 / 2 + pp / PW;
      const int px = tx0 / 2 + pp % PW;
      if (py >= Hp || px >= Wp) continue;
      const uint16_t* s =
          plane + (((size_t)b * H + 2 * py) * W + 2 * px) * C + c_lo + v * 8;
      const uint4 top = max_bf16x8(__ldcg(reinterpret_cast<const uint4*>(s)),
                                   __ldcg(reinterpret_cast<const uint4*>(s + C)));
      const uint4 bot =
          max_bf16x8(__ldcg(reinterpret_cast<const uint4*>(s + row)),
                     __ldcg(reinterpret_cast<const uint4*>(s + row + C)));
      *reinterpret_cast<uint4*>(
          pooled + (((size_t)b * Hp + py) * Wp + px) * C + c_lo + v * 8) =
          max_bf16x8(top, bot);
    }
  } else {
    for (int i = threadIdx.x; i < PP * nc; i += kThreads) {
      const int ch = c_lo + i % nc;
      const int pp = i / nc;
      const int py = ty0 / 2 + pp / PW;
      const int px = tx0 / 2 + pp % PW;
      if (py >= Hp || px >= Wp) continue;
      const uint16_t* s = plane + (((size_t)b * H + 2 * py) * W + 2 * px) * C;
      const float m = fmaxf(fmaxf(bf2f_cg(s + ch), bf2f_cg(s + C + ch)),
                            fmaxf(bf2f_cg(s + row + ch),
                                  bf2f_cg(s + row + C + ch)));
      reinterpret_cast<__nv_bfloat16*>(
          pooled)[(((size_t)b * Hp + py) * Wp + px) * C + ch] =
          __float2bfloat16_rn(m);
    }
  }
}

// The mma.sync path's kept 16 x 16 tile at (ty0, tx0) of image b
// (keep[(n / 8) * kKeepPitch + o][n % 8], o = 16 r + c) to out[b, ty0 + r,
// tx0 + c, :C] as whole 16-byte runs of 8 channels; with pooled also its 2x2
// max pool to pooled (B, H/2, W/2, C) (ty0, tx0, H and W are even then).
__device__ __forceinline__ void keep_store(const uint16_t* keep, uint16_t* out,
                                           uint16_t* pooled, int C, int b,
                                           int H, int W, int ty0, int tx0) {
  const int groups = (C + 7) >> 3;
  // a thread keeps one group of 8 channels where the groups divide the
  // block (C = 8, 16, 32, 64): no division per value
  const bool fixed = kThreads % groups == 0;
  const int step = fixed ? kThreads / groups : kThreads;
  for (int i = fixed ? threadIdx.x / groups : threadIdx.x;
       i < (fixed ? kTile * kTile : kTile * kTile * groups); i += step) {
    const int grp = fixed ? threadIdx.x % groups : i % groups;
    const int o = fixed ? i : i / groups;
    const int gy = ty0 + (o >> 4), gx = tx0 + (o & 15);
    if (gy >= H || gx >= W) continue;
    store8(out + (((size_t)b * H + gy) * W + gx) * C + grp * 8,
           *reinterpret_cast<const uint4*>(keep +
                                           ((grp * kKeepPitch + o) << 3)),
           C - grp * 8, C);
  }
  if (pooled == nullptr) return;
  const int Hp = H / 2, Wp = W / 2;
  constexpr int kPooled = (kTile / 2) * (kTile / 2);
  for (int i = fixed ? threadIdx.x / groups : threadIdx.x;
       i < (fixed ? kPooled : kPooled * groups); i += step) {
    const int grp = fixed ? threadIdx.x % groups : i % groups;
    const int pp = fixed ? i : i / groups;
    const int py = (ty0 >> 1) + (pp >> 3), px = (tx0 >> 1) + (pp & 7);
    if (py >= Hp || px >= Wp) continue;
    const uint4* k = reinterpret_cast<const uint4*>(
        keep + ((grp * kKeepPitch + (pp >> 3) * 2 * kTile + (pp & 7) * 2)
                << 3));
    store8(pooled + (((size_t)b * Hp + py) * Wp + px) * C + grp * 8,
           max_bf16x8(max_bf16x8(k[0], k[1]), max_bf16x8(k[kTile], k[kTile + 1])),
           C - grp * 8, C);
  }
}

// The two blocks of a split item meet here once each has written its half
// of the item's output; after it either may read the other's half (through
// L2: cp.async.cg).
__device__ __forceinline__ void pair_sync(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag)
                 : "memory");
    int seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(flag)
                   : "memory");
    } while (seen < 2);
  }
  __syncthreads();
}

// The passes [lo, lo + n) of n_all that half `half` of an item takes
struct PassRange {
  int lo, n;
};
__device__ __forceinline__ PassRange pass_range(int n_all, int split,
                                                int half) {
  const int first = (n_all + 1) / 2;
  if (split == 1) return PassRange{0, n_all};
  return half == 0 ? PassRange{0, first} : PassRange{first, n_all - first};
}

// Epilogue of the transposed conv through shared memory: column n = tap *
// cup_p + co (pass pass0 + pass) of raster row q (image img, pixel (r, c) of
// the th x tw tile) is rounded to bf16, the bf16 bias added in bf16, and
// staged as stage[q][n % 128]; then the block writes each run of 8 channels
// as one 16-byte store to up[b, 2 (y0 + r) + dy, 2 (x0 + c) + dx, co], tap
// = 2 dy + dx. Every thread of the block runs it. With one block of eight
// warps per SM nothing hides an instruction's latency here, so the work per
// value is kept small: one bf16x2 rounding and add per pair, and in the copy
// a thread keeps one run of columns (kThreads is a multiple of 16).
struct WgUpRowEpi {
  const uint16_t* upb;
  uint16_t* up;
  uint32_t stage;  // rows x kUpRow bf16 of shared memory
  int rows, pass0, cup, cup_p, g, th, tw, B, H, W, b0, y0, x0;
  template <int MT>
  __device__ __forceinline__ void run(const float (&acc)[MT > 0 ? MT : 1][64],
                                      int pass) const {
    static_assert(kThreads % (kWgN / 8) == 0, "a thread keeps one run");
    const int p = pass0 + pass;
    const SmallDiv by_cup(cup_p);
    if (MT > 0) {
      const WgLane ln;
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j) {
        const int nn = j * 8 + ln.col0;
        const int n = p * kWgN + nn;
        const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(
            upb + n - by_cup.div(n) * cup_p);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = (ln.wg + 2 * i) * 64 + ln.row0 + 8 * h;
            if (q >= rows) continue;
            __nv_bfloat162 v = __hadd2(
                __floats2bfloat162_rn(acc[i][4 * j + 2 * h],
                                      acc[i][4 * j + 2 * h + 1]),
                bias);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             stage + (uint32_t)(q * kUpRow + nn) * 2),
                         "r"(*reinterpret_cast<uint32_t*>(&v))
                         : "memory");
          }
      }
    }
    __syncthreads();
    const int k = threadIdx.x % (kWgN / 8);
    const int n = p * kWgN + k * 8;
    const int tap = by_cup.div(n);
    const int co = n - tap * cup_p;
    if (co >= cup) return;
    const SmallDiv by_per(th * tw), by_tw(tw);
    const size_t row2 = (size_t)2 * W * cup;
    uint16_t* base = up + (size_t)(tap >> 1) * row2 + (tap & 1) * cup + co;
    for (int q = threadIdx.x / (kWgN / 8); q < rows;
         q += kThreads / (kWgN / 8)) {
      const int img = by_per.div(q);
      const int rem = q - img * th * tw;
      const int r = by_tw.div(rem);
      const int b = b0 + img, gy = y0 + r, gx = x0 + rem - r * tw;
      if (img >= g || b >= B || gy >= H || gx >= W) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(stage + (uint32_t)(q * kUpRow + k * 8) * 2));
      store8(base + ((size_t)b * 2 * H + 2 * gy) * 2 * W * cup +
                 (size_t)2 * gx * cup,
             v, cup - co, cup);
    }
  }
};

struct Item {
  int b0, ty0, tx0;
};

// The transposed conv of an item's tiles (st.out, written by this block or
// by the two blocks of a split item) into st.aux, the passes of `stream`
// (the first is pass0 of the product's 4 * up_cout_p columns). Unless
// a_ready (a_addr then holds the mma.sync path's kept tile), the tile's
// input channels are staged at a_addr all at once, over the ring tile that
// the double conv no longer needs; the one-tap product then reads its A
// from shared memory for every chunk, and WgUpRowEpi writes the result.
// Needs up_rows_smem(st) bytes.
__device__ __forceinline__ void up_item_rows(WgPipe& pipe,
                                             const MegaStage& st,
                                             WgStream& stream, int B, Item it,
                                             uint32_t a_addr, bool a_ready,
                                             int pass0) {
  const WgTile t = st.tile;
  const int rows = t.g * t.th * t.tw;
  const int pitch = wg_a_pitch(rows, rows, 0, 1);
  if (!a_ready) {
    const ConvSrc src{st.out, nullptr, st.w.Cout, st.up_kp, 0, 0};
    const WgPatch patch{B, st.H, st.W, it.b0, t.g, t.th, t.tw, it.ty0, it.tx0};
    for (int k = 0; k < st.up_kp / kWgKC; ++k)
      wg_load_a(a_addr + (uint32_t)k * (kWgKC / 8) * pitch * 16, pitch, src,
                patch, k * kWgKC);
    cp_async_commit();
    cp_async_wait_all();  // wg_conv fences and meets at a barrier first
  }
  const WgConv cv{rows, 0, pitch};
  WgUpRowEpi epi{st.upb, st.aux,
                 a_addr + (uint32_t)(st.up_kp / 8) * pitch * 16,
                 rows,   pass0,  st.up_cout, st.up_cout_p, t.g, t.th, t.tw,
                 B,      st.H,   st.W,       it.b0,        it.ty0, it.tx0};
  WgNoLoad none;
  wg_conv<false>(pipe, cv, stream, nullptr, a_addr, 0, none, epi);
}

// Epilogue of the transposed conv: column n = tap * cup_p + co of raster row
// (image, y, x) goes to up[b, 2y + dy, 2x + dx, co] as
// bf16(bf16(product) + bias).
struct WgUpEpi {
  const uint16_t* upb;
  uint16_t* up;
  int cup, cup_p, g, th, tw, B, H, W, b0, y0, x0;
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
        const WgPixel p((ln.wg + 2 * i) * 64 + ln.row0 + 8 * h, th, tw);
        const int b = b0 + p.img, gy = y0 + p.r, gx = x0 + p.c;
        const bool kept = p.img < g && b < B && gy < H && gx < W;
        dst[i][h] = kept ? up + (((size_t)b * 2 * H + 2 * gy) * 2 * W +
                                 2 * gx) * cup
                         : nullptr;
      }
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      const int n = pass * kWgN + j * 8 + ln.col0;
      const int tap = n / cup_p;
      const int co = n - tap * cup_p;
      if (co >= cup) continue;
      const size_t off = ((size_t)(tap >> 1) * 2 * W + (tap & 1)) * cup;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (dst[i][h] != nullptr)
            store_bf16_pair(
                dst[i][h] + off, co, cup,
                __bfloat162float(__float2bfloat16_rn(acc[i][4 * j + 2 * h])) +
                    bf2f(upb, co),
                __bfloat162float(
                    __float2bfloat16_rn(acc[i][4 * j + 2 * h + 1])) +
                    bf2f(upb, co + 1));
    }
  }
};

// The general kernel's upsample of a tile whose input channels do not fit
// shared memory at once (a wide net): the 2x2 stride-2 transposed conv of the
// th x tw tiles at (ty0, tx0) of images b0 .. b0 + g - 1 of st.out, which
// this block has just written, into st.aux: up[2y+dy, 2x+dx, :] =
// bf16(bf16(out[y, x, :] @ w[dy, dx]) + bias), the product accumulated in
// fp32, as a one-tap conv on the wgmma path whose A operand is staged chunk
// by chunk. stream: st.upw's, whose first stages the item's second conv may
// have sent already.
__device__ __forceinline__ void up_item(uint8_t* smem, WgPipe& pipe,
                                        const MegaStage& st, WgStream& stream,
                                        int B, int b0, int ty0, int tx0) {
  const WgTile t = st.tile;
  const int rows = t.g * t.th * t.tw;
  const int pitch = wg_a_pitch(rows, rows, 0, 1);
  const ConvSrc src{st.out, nullptr, st.w.Cout, st.up_kp, 0, 0};
  const WgPatch patch{B, st.H, st.W, b0, t.g, t.th, t.tw, ty0, tx0};
  const WgConv cv{rows, 0, pitch};
  WgStageLoad load{src, patch, pitch};
  WgUpEpi epi{st.upb, st.aux, st.up_cout, st.up_cout_p, t.g, t.th, t.tw,
              B,      st.H,   st.W,       b0,           ty0, tx0};
  wg_conv<true>(pipe, cv, stream, nullptr,
                smem_u32(smem) + kWgBarBytes + kWgRingBytes,
                (uint32_t)(kWgKC / 8) * pitch * 16, load, epi);
}

// Bytes from the mma.sync path's shared memory to its kept tile: the ring
// tile's.
__host__ __device__ size_t keep_offset(const MegaStage& st) {
  return 2 * (size_t)DoubleConvSmem<kTile, kTile, kKC>::inter_elems(
                 st.w.Cmid_p);
}

// Shared memory of an upsample that reads its A from shared memory: the
// barriers and the weight ring, (on the mma.sync path the ring tile,) the
// tile's input channels, the staged pass.
size_t up_rows_smem(const MegaStage& st) {
  const int rows = st.tile.g * st.tile.th * st.tile.tw;
  return kWgBarBytes + kWgRingBytes + (st.path == 1 ? 0 : keep_offset(st)) +
         (size_t)(st.up_kp / 8) * wg_a_pitch(rows, rows, 0, 1) * 16 +
         (size_t)rows * kUpRow * 2;
}

// Shared memory of a stage: the barriers and the weight ring, then the
// path's own buffers; the upsample's buffers lie over them.
size_t stage_smem(const MegaStage& st) {
  const int rows = st.tile.g * st.tile.th * st.tile.tw;
  size_t up = 0;
  if (st.kind == kUp)
    up = st.rows ? up_rows_smem(st)
                 : kWgBarBytes + kWgRingBytes +
                       2 * (size_t)(kWgKC / 8) *
                           wg_a_pitch(rows, rows, 0, 1) * 16;
  const size_t conv =
      st.path == 1
          ? WgGeom(st.tile, 1, st.w.Cmid_p).smem_bytes(st.kind == kHead)
          : kWgBarBytes + kWgRingBytes +
                DoubleConvSmem<kTile, kTile, kKC>::bytes(st.w.Cmid_p);
  return conv > up ? conv : up;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One wgmma item (half `half` of a split item): the double conv, then the
// pool of its own channels, or the pair's meeting and the upsample. All of
// this is inlined into the kernel: a wgmma pipeline must not cross a
// function call (the compiler serialises it there), and a called function
// gets a smaller register budget than the accumulators need.
template <bool kGeneral>
__device__ __forceinline__ void item_wgmma(const MegaStage& st, int B,
                                           uint8_t* smem, WgPipe& pipe,
                                           Item it, int item, int half,
                                           unsigned long long* conv_clk) {
  const long long c0 = conv_clk != nullptr ? clock64() : 0;
  if constexpr (kGeneral) {
    if (st.kind == kHead) {
      wg_double_conv_item<true>(smem, pipe, st.src, st.w, B, st.H, st.W,
                                it.b0, it.ty0, it.tx0, st.tile, nullptr,
                                st.head, nullptr);
      if (conv_clk != nullptr) *conv_clk += clock64() - c0;
      return;
    }
  }
  const bool up = st.kind == kUp;
  const PassRange r2 = pass_range(st.w.Cout_p / kWgN, st.split, half);
  const PassRange ru =
      pass_range(up ? 4 * st.up_cout_p / kWgN : 0, st.split, half);
  // the second conv sends the upsample's first stages; a pool stage's
  // stream is empty. One stream object, whatever the stage: a pointer that
  // may be null or not keeps the streams out of the registers (a stack
  // frame, loaded between the wgmmas)
  WgStream ups(st.upw, ru.lo, ru.n, up ? st.up_kp / kWgKC : 0, 1);
  wg_double_conv_item<false>(smem, pipe, st.src, st.w, B, st.H, st.W, it.b0,
                             it.ty0, it.tx0, st.tile, st.out, st.head, &ups,
                             r2.lo, r2.n);
  if (conv_clk != nullptr) *conv_clk += clock64() - c0;
  if (up) {
    if (st.split == 2) pair_sync(st.flags + item);
    if (!kGeneral || st.rows)
      up_item_rows(pipe, st, ups, B, it,
                   smem_u32(smem) + kWgBarBytes + kWgRingBytes, false, ru.lo);
    else if constexpr (kGeneral)
      up_item(smem, pipe, st, ups, B, it.b0, it.ty0, it.tx0);
  } else {
    // the block's own writes to st.out are visible to it after the
    // conv's last barrier
    const int c_hi = (r2.lo + r2.n) * kWgN;
    for (int g = 0; g < st.tile.g && it.b0 + g < B; ++g)
      pool_tile(st.out, st.aux, st.w.Cout, r2.lo * kWgN,
                c_hi < st.w.Cout ? c_hi : st.w.Cout, it.b0 + g, st.H, st.W,
                it.ty0, it.tx0, st.tile.th, st.tile.tw);
  }
}

// One mma.sync item: a 16 x 16 tile of one image. Unless it ends in the
// head, the tile stays in shared memory: stored from there as 16-byte runs,
// pooled from there, and the upsample's A operand as it lies.
__device__ __forceinline__ void item_mma(const MegaStage& st, int B,
                                         uint8_t* smem, WgPipe& pipe, Item it,
                                         unsigned long long* conv_clk) {
  const long long c0 = conv_clk != nullptr ? clock64() : 0;
  uint16_t* mma_smem =
      reinterpret_cast<uint16_t*>(smem + kWgBarBytes + kWgRingBytes);
  uint16_t* keep = mma_smem + keep_offset(st) / 2;
  const bool up = st.kind == kUp;
  WgStream ups(st.upw, 0, up ? 4 * st.up_cout_p / kWgN : 0,
               up ? st.up_kp / kWgKC : 0, 1);
  // the weight ring is idle on this path: the upsample's first stages
  // arrive while the double conv runs
  while (ups.sent < kWgStages - 1 && ups.more()) ups.send(pipe);
  if (st.kind == kHead) {
    double_conv_tile<kTile, kTile, kKC, true>(mma_smem, st.src, st.w, it.b0,
                                              st.H, st.W, it.ty0, it.tx0,
                                              nullptr, st.head);
    if (conv_clk != nullptr) *conv_clk += clock64() - c0;
    return;
  }
  double_conv_tile<kTile, kTile, kKC, false>(mma_smem, st.src, st.w, it.b0,
                                             st.H, st.W, it.ty0, it.tx0,
                                             st.out, st.head, keep,
                                             kKeepPitch);
  if (conv_clk != nullptr) *conv_clk += clock64() - c0;
  keep_store(keep, st.out, up ? nullptr : st.aux, st.w.Cout, it.b0, st.H,
             st.W, it.ty0, it.tx0);
  if (up)  // its wgmma pipeline begins at a barrier
    up_item_rows(pipe, st, ups, B, it, smem_u32(keep), true, 0);
  else
    __syncthreads();  // the next item's input buffers lie over keep
}

template <bool kGeneral, bool kStamps>
__device__ __forceinline__ void run_stage(const MegaStage& st, int B,
                                          uint8_t* smem, WgPipe& pipe,
                                          unsigned long long* stamp) {
  unsigned long long conv_clk = 0;
  if (kStamps && threadIdx.x == 0) {
    stamp[0] = global_ns();
    stamp[2] = clock64();
  }
  const WgTile t = st.tile;
  const int tiles_x = (st.W + t.tw - 1) / t.tw;
  const int tiles_y = (st.H + t.th - 1) / t.th;
  const int n_items = ((B + t.g - 1) / t.g) * tiles_y * tiles_x * st.split;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int half = item % st.split;
    int i = item / st.split;
    Item it;
    it.tx0 = (i % tiles_x) * t.tw;
    i /= tiles_x;
    it.ty0 = (i % tiles_y) * t.th;
    it.b0 = (i / tiles_y) * t.g;
    if (st.path == 1)
      item_wgmma<kGeneral>(st, B, smem, pipe, it, item / st.split, half,
                           kStamps ? &conv_clk : nullptr);
    else
      item_mma(st, B, smem, pipe, it, kStamps ? &conv_clk : nullptr);
  }
  if (kStamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      stamp[1] = global_ns();
      stamp[3] = clock64();
      stamp[4] = conv_clk;
    }
  }
}

// kGeneral: also the stages the flagship net never has, the wgmma path's
// head and an upsample whose tile does not fit shared memory whole (wide
// nets). The lean kernel leaves their code out: compiled into the same
// function, it slows the mma.sync stages, whose code shares one register
// allocation with it (experiments/mega_variants.py, "general"). kStamps:
// the per-stage timing experiment's instantiation (lean only), which writes
// p.stamps.
template <bool kGeneral, bool kStamps>
__global__ void __launch_bounds__(kThreads, 1)
unet_mega_kernel(const __grid_constant__ MegaParams p) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  cg::grid_group grid = cg::this_grid();
  WgPipe pipe = wg_pipe_init(smem);
  // the pair counters of split upsampling stages start at 0; stage 0 pools
  // (depth >= 1), so a grid barrier lies between this and their first use
  for (int s = 0; s < p.n_stages; ++s) {
    const MegaStage& st = p.st[s];
    if (st.flags == nullptr) continue;
    const WgTile t = st.tile;
    const int items = ((p.B + t.g - 1) / t.g) * ((st.H + t.th - 1) / t.th) *
                      ((st.W + t.tw - 1) / t.tw);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < items;
         i += gridDim.x * kThreads)
      st.flags[i] = 0;
  }
  for (int s = 0; s < p.n_stages; ++s) {
    run_stage<kGeneral, kStamps>(
        p.st[s], p.B, smem, pipe,
        kStamps ? p.stamps + ((size_t)s * gridDim.x + blockIdx.x) *
                                 kStampFields
                : nullptr);
    // the next stage reads this one's planes, halo pixels of other blocks'
    // tiles included, and may write over planes this one read
    if (s + 1 < p.n_stages) grid.sync();
  }
}

int launch(const void* x, const void* weights, void* scratch, void* logits,
           const long long* plan, int n_stages, int B,
           unsigned long long* stamps, int* blocks_out, void* stream) {
  if (B <= 0) return 0;
  if (n_stages <= 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  const char* wb = static_cast<const char*>(weights);
  uint16_t* sb = static_cast<uint16_t*>(scratch);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  auto w16 = [&](long long off) {
    return reinterpret_cast<const uint16_t*>(wb + off);
  };
  auto plane = [&](long long off) -> uint16_t* {
    return off < 0 ? nullptr : sb + off;
  };
  MegaParams p;
  p.n_stages = n_stages;
  p.B = B;
  p.stamps = stamps;
  size_t smem = 0;
  long long max_items = 1, split_items = 0;
  bool general = false;
  cudaError_t err;
  for (int s = 0; s < n_stages; ++s) {
    const long long* f = plan + (size_t)s * kPlanFields;
    MegaStage& st = p.st[s];
    st.kind = (int)f[0];
    st.H = (int)f[1];
    st.W = (int)f[2];
    st.src.p0 = f[3] < 0 ? static_cast<const uint16_t*>(x) : sb + f[3];
    st.src.ro = f[3] < 0;  // the network input
    st.src.c0 = (int)f[4];
    st.src.c0p = (int)f[5];
    st.src.p1 = plane(f[6]);
    st.src.c1 = (int)f[7];
    st.w.Cin_p = (int)f[8];
    st.w.Cmid_p = (int)f[9];
    st.w.Cout = (int)f[10];
    st.w.Cout_p = (int)f[11];
    st.w.w1t = w16(f[12]);
    st.w.s1 = w16(f[13]);
    st.w.b1 = w16(f[14]);
    st.w.w2t = w16(f[15]);
    st.w.s2 = w16(f[16]);
    st.w.b2 = w16(f[17]);
    st.out = plane(f[18]);
    st.aux = plane(f[19]);
    st.upw = w16(f[20]);
    st.upb = w16(f[21]);
    st.up_cout = (int)f[22];
    st.up_cout_p = (int)f[23];
    st.head.w = reinterpret_cast<const float*>(wb + f[24]);
    st.head.b = reinterpret_cast<const float*>(wb + f[25]);
    st.head.logits = static_cast<float*>(logits);
    st.head.n_out = (int)f[26];
    st.path = (int)f[27];
    st.tile = WgTile{(int)f[28], (int)f[29], (int)f[30]};
    st.up_kp = (int)f[31];
    st.split = (int)f[32];
    st.flags = f[33] < 0 ? nullptr : reinterpret_cast<int*>(sb + f[33]);
    const int n_pad = st.path == 1 ? kWgN : kChanPad;
    const WgTile t = st.tile;
    if (st.kind < kPool || st.kind > kHead || st.H <= 0 || st.W <= 0 ||
        st.path < 0 || st.path > 1 || t.th <= 0 || t.tw <= 0 || t.g <= 0 ||
        (st.path == 0 && (t.th != kTile || t.tw != kTile || t.g != 1)) ||
        (st.path == 1 &&
         !WgGeom(t, 1, st.w.Cmid_p).fits(st.kind == kHead)) ||
        st.w.Cin_p % kChanPad || st.w.Cmid_p % n_pad ||
        st.w.Cout_p % n_pad || st.src.c0p % kChanPad ||
        st.w.Cout > st.w.Cout_p || st.w.Cout <= 0 ||
        (st.kind == kUp &&
         (st.up_cout_p % kChanPad || st.up_cout <= 0 ||
          st.up_cout > st.up_cout_p || st.up_kp % kChanPad ||
          st.up_kp < st.w.Cout || t.g * t.th * t.tw > kWgMaxRows)) ||
        (st.kind == kPool && ((st.H | st.W | t.th | t.tw) & 1)) ||
        (st.kind == kHead && (st.head.n_out <= 0 || st.head.n_out > kHeadOut)) ||
        (st.kind != kHead && (st.out == nullptr || st.aux == nullptr)))
      return (int)cudaErrorInvalidValue;
    // the mma.sync path keeps its tile where the second conv leaves the
    // input chunk buffers idle (a U-Net block's Cout is its Cmid: at most 64
    // channels, 33 KB); its upsample reads that tile as its A operand
    if (st.path == 0 && st.kind != kHead &&
        ((size_t)(st.w.Cout_p / 8) * kKeepPitch * 8 >
             2 * (size_t)ConvGeom<kTile, kTile, kKC, 1>::XS ||
         (st.kind == kUp && st.up_kp != st.w.Cout_p)))
      return (int)cudaErrorInvalidValue;
    st.rows = st.kind == kUp && up_rows_smem(st) <= (size_t)kMaxSmem;
    if (st.kind == kUp && st.path == 0 && !st.rows)
      return (int)cudaErrorInvalidValue;
    general = general || (st.kind == kHead && st.path == 1) ||
              (st.kind == kUp && !st.rows);
    const long long items = (long long)((B + t.g - 1) / t.g) *
                            ((st.H + t.th - 1) / t.th) *
                            ((st.W + t.tw - 1) / t.tw);
    if (items > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
    if (st.split != 1 &&
        (st.split != 2 || st.path != 1 || st.kind == kHead ||
         st.w.Cout_p / kWgN < 2 ||
         (st.kind == kUp &&
          (!st.rows || 4 * st.up_cout_p / kWgN < 2 || st.flags == nullptr))))
      return (int)cudaErrorInvalidValue;
    const size_t need = stage_smem(st);
    if (need > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    smem = need > smem ? need : smem;
    max_items = items * st.split > max_items ? items * st.split : max_items;
    if (st.split == 2)
      split_items = items > split_items ? items : split_items;
    if (st.flags != nullptr && (st.split != 2 || st.kind != kUp || s == 0))
      return (int)cudaErrorInvalidValue;
  }
  if (general && stamps != nullptr) return (int)cudaErrorInvalidValue;
  void (*kernel)(MegaParams) =
      stamps != nullptr ? unet_mega_kernel<false, true>
      : general         ? unet_mega_kernel<true, false>
                        : unet_mega_kernel<false, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // grid.sync() needs every block resident at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = (long long)sms * per_sm;
  blocks = blocks < max_items ? blocks : max_items;
  // the two halves of every split item run at once: both in the grid's
  // first round of items
  if (2 * split_items > blocks) return (int)cudaErrorInvalidValue;
  if (blocks_out != nullptr) *blocks_out = (int)blocks;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3((unsigned)blocks), dim3(kThreads),
                                    args, smem, cs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- fp32 body
//
// compute_dtype="float32": the same stages in one cooperative launch, fp32
// arithmetic on the CUDA cores (FFMA; no tensor-core format rounds an
// operand), no rounding anywhere. Simple by design: each double conv runs
// as two grid-wide passes, the first conv's result through a device-memory
// plane (mid) that every stage reuses, then the pool, the transposed conv
// or the head as a third. A thread computes kF32Group output channels of
// one pixel; neighbouring threads take neighbouring pixels of the same
// channels, so a warp's weight reads are one broadcast. Activations are
// read with ld.global.cg (L2 only): mid is rewritten by every stage, and a
// plain load could meet a line that an SM's L1 kept from the stage before.
// Weights: per conv (9, Cin, Cn8) fp32, Cn8 the output channels rounded up
// to kF32Group, zero padded; scales and shifts (Cn8,); the transposed conv
// (Cin, 4, Cup8) with column tap = 2 dy + dx, its bias (Cup8,); the head
// (Cout, kHeadOut) and its bias (kHeadOut,).

constexpr int kF32Fields = 24;
constexpr int kF32Group = 8;

struct F32Stage {
  const float* p0;  // input channels [0, c0)
  const float* p1;  // input channels [c0, c0 + c1) (decoder: upsampled)
  const float *w1, *s1, *b1, *w2, *s2, *b2;
  float* mid;       // (B, H, W, cmid)
  float* out;       // (B, H, W, cout)
  float* aux;       // kPool: (B, H/2, W/2, cout); kUp: (B, 2H, 2W, up_cout)
  const float* upw;
  const float* upb;
  const float* head_w;
  const float* head_b;
  int kind, H, W, c0, c1, cmid, cout, up_cout, n_out;
};

struct F32Params {
  F32Stage st[kMaxStages];
  int n_stages;
  int B;
  float* logits;
};
static_assert(sizeof(F32Params) <= 4096, "kernel parameters hold 4 KB");

__device__ __forceinline__ int f32_round8(int n) {
  return (n + kF32Group - 1) / kF32Group * kF32Group;
}

// acc[j] += v * w[j], j < kF32Group
__device__ __forceinline__ void f32_fma8(float (&acc)[kF32Group], float v,
                                         const float* w) {
  const float4 wa = __ldg(reinterpret_cast<const float4*>(w));
  const float4 wb = __ldg(reinterpret_cast<const float4*>(w + 4));
  acc[0] = fmaf(v, wa.x, acc[0]);
  acc[1] = fmaf(v, wa.y, acc[1]);
  acc[2] = fmaf(v, wa.z, acc[2]);
  acc[3] = fmaf(v, wa.w, acc[3]);
  acc[4] = fmaf(v, wb.x, acc[4]);
  acc[5] = fmaf(v, wb.y, acc[5]);
  acc[6] = fmaf(v, wb.z, acc[6]);
  acc[7] = fmaf(v, wb.w, acc[7]);
}

// acc[j] += sum_ci x[ci] * w[ci * wstride + j], ci in [0, c), in order; four
// channels per load where c % 4 == 0 (x is then 16-byte aligned)
__device__ __forceinline__ void f32_dot(float (&acc)[kF32Group],
                                        const float* x, int c, const float* w,
                                        int wstride) {
  int ci = 0;
  if ((c & 3) == 0) {
    for (; ci < c; ci += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(x + ci));
      f32_fma8(acc, v.x, w);
      f32_fma8(acc, v.y, w + wstride);
      f32_fma8(acc, v.z, w + 2 * wstride);
      f32_fma8(acc, v.w, w + 3 * wstride);
      w += 4 * wstride;
    }
  }
  for (; ci < c; ++ci, w += wstride) f32_fma8(acc, __ldcg(x + ci), w);
}

// out = relu(conv3x3(in, w) * sc + sh), SAME padding, in = channels
// [0, c0) of p0 then [0, c1) of p1, cn output channels
__device__ __forceinline__ void f32_conv(const float* p0, int c0,
                                         const float* p1, int c1,
                                         const float* w, const float* sc,
                                         const float* sh, int cn, float* out,
                                         int B, int H, int W) {
  const int cn8 = f32_round8(cn);
  const long long P = (long long)B * H * W;
  const long long total = P * (cn8 / kF32Group);
  const int cin = c0 + c1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i % P;
    const int co0 = (int)(i / P) * kF32Group;
    const int x = (int)(pix % W);
    const int y = (int)((pix / W) % H);
    const long long b = pix / ((long long)W * H);
    float acc[kF32Group];
#pragma unroll
    for (int j = 0; j < kF32Group; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = y + tap / 3 - 1;
      const int xx = x + tap % 3 - 1;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const size_t q = ((size_t)b * H + yy) * W + xx;
      const float* wt = w + (size_t)tap * cin * cn8 + co0;
      f32_dot(acc, p0 + q * c0, c0, wt, cn8);
      if (c1 > 0) f32_dot(acc, p1 + q * c1, c1, wt + (size_t)c0 * cn8, cn8);
    }
    float* o = out + pix * cn;
#pragma unroll
    for (int j = 0; j < kF32Group; ++j)
      if (co0 + j < cn) o[co0 + j] = fmaxf(fmaf(acc[j], sc[co0 + j], sh[co0 + j]), 0.f);
  }
}

__device__ __forceinline__ void f32_pool(const float* in, float* out, int C,
                                         int B, int H, int W) {
  const int Hp = H / 2, Wp = W / 2;
  const long long total = (long long)B * Hp * Wp * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const long long pp = i / C;
    const int px = (int)(pp % Wp);
    const int py = (int)((pp / Wp) % Hp);
    const long long b = pp / ((long long)Wp * Hp);
    const float* s = in + (((size_t)b * H + 2 * py) * W + 2 * px) * C + c;
    const size_t row = (size_t)W * C;
    out[i] = fmaxf(fmaxf(__ldcg(s), __ldcg(s + C)),
                   fmaxf(__ldcg(s + row), __ldcg(s + row + C)));
  }
}

// up[b, 2y + dy, 2x + dx, co] = sum_ci in[b, y, x, ci] * w[ci][2 dy + dx][co]
// + bias[co]
__device__ __forceinline__ void f32_up(const float* in, int cin,
                                       const float* w, const float* bias,
                                       int cup, float* up, int B, int H,
                                       int W) {
  const int cup8 = f32_round8(cup);
  const long long P = (long long)B * H * W;
  const long long total = P * 4 * (cup8 / kF32Group);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i % P;
    const int rest = (int)(i / P);
    const int tap = rest & 3;
    const int co0 = (rest >> 2) * kF32Group;
    const int x = (int)(pix % W);
    const int y = (int)((pix / W) % H);
    const long long b = pix / ((long long)W * H);
    float acc[kF32Group];
#pragma unroll
    for (int j = 0; j < kF32Group; ++j) acc[j] = 0.f;
    f32_dot(acc, in + pix * cin, cin, w + (size_t)tap * cup8 + co0,
            4 * cup8);
    float* o = up + (((size_t)b * 2 * H + 2 * y + (tap >> 1)) * 2 * W + 2 * x +
                     (tap & 1)) * cup;
#pragma unroll
    for (int j = 0; j < kF32Group; ++j)
      if (co0 + j < cup) o[co0 + j] = acc[j] + bias[co0 + j];
  }
}

// logits[p, o] = sum_c in[p, c] * w[c][o] + bias[o], o < n_out
__device__ __forceinline__ void f32_head(const float* in, int C,
                                         const float* w, const float* bias,
                                         int n_out, float* logits,
                                         long long P) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    float acc[kHeadOut];
#pragma unroll
    for (int o = 0; o < kHeadOut; ++o) acc[o] = 0.f;
    const float* row = in + p * C;
    for (int c = 0; c < C; ++c) {
      const float v = __ldcg(row + c);
#pragma unroll
      for (int o = 0; o < kHeadOut; ++o)
        acc[o] = fmaf(v, __ldg(w + c * kHeadOut + o), acc[o]);
    }
    for (int o = 0; o < n_out; ++o) logits[p * n_out + o] = acc[o] + bias[o];
  }
}

__global__ void __launch_bounds__(kThreads)
unet_mega_f32_kernel(const __grid_constant__ F32Params p) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < p.n_stages; ++s) {
    const F32Stage& st = p.st[s];
    f32_conv(st.p0, st.c0, st.p1, st.c1, st.w1, st.s1, st.b1, st.cmid, st.mid,
             p.B, st.H, st.W);
    grid.sync();
    f32_conv(st.mid, st.cmid, nullptr, 0, st.w2, st.s2, st.b2, st.cout, st.out,
             p.B, st.H, st.W);
    grid.sync();
    if (st.kind == kPool)
      f32_pool(st.out, st.aux, st.cout, p.B, st.H, st.W);
    else if (st.kind == kUp)
      f32_up(st.out, st.cout, st.upw, st.upb, st.up_cout, st.aux, p.B, st.H,
             st.W);
    else
      f32_head(st.out, st.cout, st.head_w, st.head_b, st.n_out, p.logits,
               (long long)p.B * st.H * st.W);
    if (s + 1 < p.n_stages) grid.sync();
  }
}

int launch_f32(const void* x, const void* weights, void* scratch,
               void* logits, const long long* plan, int n_stages, int B,
               void* stream) {
  if (B <= 0) return 0;
  if (n_stages <= 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  const char* wb = static_cast<const char*>(weights);
  float* sb = static_cast<float*>(scratch);
  auto wf = [&](long long off) {
    return reinterpret_cast<const float*>(wb + off);
  };
  auto plane = [&](long long off) -> float* {
    return off < 0 ? nullptr : sb + off;
  };
  F32Params p;
  p.n_stages = n_stages;
  p.B = B;
  p.logits = static_cast<float*>(logits);
  for (int s = 0; s < n_stages; ++s) {
    const long long* f = plan + (size_t)s * kF32Fields;
    F32Stage& st = p.st[s];
    st.kind = (int)f[0];
    st.H = (int)f[1];
    st.W = (int)f[2];
    st.p0 = f[3] < 0 ? static_cast<const float*>(x) : sb + f[3];
    st.c0 = (int)f[4];
    st.p1 = plane(f[5]);
    st.c1 = (int)f[6];
    st.cmid = (int)f[7];
    st.cout = (int)f[8];
    st.w1 = wf(f[9]);
    st.s1 = wf(f[10]);
    st.b1 = wf(f[11]);
    st.w2 = wf(f[12]);
    st.s2 = wf(f[13]);
    st.b2 = wf(f[14]);
    st.mid = plane(f[15]);
    st.out = plane(f[16]);
    st.aux = plane(f[17]);
    st.upw = wf(f[18]);
    st.upb = wf(f[19]);
    st.up_cout = (int)f[20];
    st.head_w = wf(f[21]);
    st.head_b = wf(f[22]);
    st.n_out = (int)f[23];
    if (st.kind < kPool || st.kind > kHead || st.H <= 0 || st.W <= 0 ||
        st.c0 <= 0 || st.c1 < 0 || (st.c1 > 0) != (st.p1 != nullptr) ||
        st.cmid <= 0 || st.cout <= 0 || st.mid == nullptr ||
        st.out == nullptr ||
        (st.kind == kPool && ((st.H | st.W) & 1)) ||
        (st.kind == kUp && st.up_cout <= 0) ||
        (st.kind != kHead && st.aux == nullptr) ||
        (st.kind == kHead && (st.n_out <= 0 || st.n_out > kHeadOut)))
      return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, unet_mega_f32_kernel, kThreads, 0)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(unet_mega_f32_kernel),
      dim3((unsigned)(sms * per_sm)), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) bf16 network input; weights: the packed blob; scratch:
// bf16 activation planes; logits: (B, H, W, n_out) fp32. plan: n_stages rows
// of kPlanFields host integers, written by
// plumekit_torch/models/kernels/unet_mega.py::_plan (field order there):
// offsets into scratch in bf16 elements (-1: the network input, or none),
// offsets into weights in bytes. Returns a cudaError_t (0 on success).
int pk_unet_mega(const void* x, const void* weights, void* scratch,
                 void* logits, const long long* plan, int n_stages, int B,
                 void* stream) {
  return launch(x, weights, scratch, logits, plan, n_stages, B, nullptr,
                nullptr, stream);
}

// The same launch, with kStampFields stamps per stage and block written to
// stamps ((n_stages, blocks, kStampFields) uint64, room for the largest
// grid) and the grid's block count to *blocks_out. For the per-stage timing
// experiment (plumekit_torch/experiments/mega_stage_times.py) only.
int pk_unet_mega_stamps(const void* x, const void* weights, void* scratch,
                        void* logits, const long long* plan, int n_stages,
                        int B, void* stamps, int* blocks_out, void* stream) {
  return launch(x, weights, scratch, logits, plan, n_stages, B,
                static_cast<unsigned long long*>(stamps), blocks_out, stream);
}

// The fp32 body: x (B, H, W, Cin) fp32, weights packed in fp32, scratch fp32
// planes, logits (B, H, W, n_out) fp32; plan: n_stages rows of kF32Fields
// (unet_mega.py::_plan_f32; plane offsets in floats, weight offsets in
// bytes). Returns a cudaError_t (0 on success).
int pk_unet_mega_f32(const void* x, const void* weights, void* scratch,
                     void* logits, const long long* plan, int n_stages, int B,
                     void* stream) {
  return launch_f32(x, weights, scratch, logits, plan, n_stages, B, stream);
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
