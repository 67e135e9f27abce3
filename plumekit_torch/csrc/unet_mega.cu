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
//   * A stage's items are (image, output tile) pairs; block i takes items
//     i, i + gridDim.x, ... and runs double_conv_tile of conv_tiles.cuh on
//     each, with the tile that the fused double conv takes for the stage's
//     mid channels: 16 x 16 up to 128, 8 x 8 above (double_conv_tile_for).
//   * An encoder item then max-pools its own tile (tiles start at even
//     pixels, so every 2x2 window lies inside one) into the next level's
//     input plane. A bottleneck or decoder item then upsamples its own tile:
//     a (pixels x Cin) @ (Cin x 4*Cout) product on the tensor cores, each
//     tap's result rounded to bf16, the bf16 bias added in bf16, scattered
//     to the 2x2 output pixels. Both read the tile back from device memory
//     after a block barrier: the block wrote it itself.
//   * A decoder block's first conv reads its input channels from two planes,
//     the skip and the upsampled one (ConvSrc), into one fp32 accumulator.
//   * The last decoder block keeps its result in fp32 and multiplies it by
//     the head in its epilogue: only the logits are written.
//   * cooperative_groups::this_grid().sync() separates the stages: a stage
//     reads its neighbours' halo pixels of the stage before. No scratch
//     plane is written again after it was read in the same launch, so a
//     plain load can never meet a stale line in its SM's L1. The launch is
//     cudaLaunchCooperativeKernel with a grid no larger than what is
//     co-resident (SMs x occupancy at the opted-in shared memory).
//
// What bounds it on an H100: the arithmetic (about 3.4 GFLOP per 96 x 96
// tile of the base-32, depth-4 net) against 57 KB of compulsory traffic per
// tile plus the weights once: operations, by two orders of magnitude. The
// kernel reaches a fraction of the tensor-core rate for the reasons given in
// fused_double_conv.cu (weights re-read from L2 per tile, the ring's
// recompute, mma.sync rather than wgmma), and the bottleneck of a small
// tile leaves 44% of its 8 x 8 tile outside the image (6 x 6 at depth 4 of a
// 96 x 96 tile).
// Plain interface for ctypes; the launch returns its cudaError_t.

#include <cooperative_groups.h>

#include "conv_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pk;

constexpr int kMaxStages = 17;  // depth <= 8
constexpr int kPlanFields = 28;
enum StageKind { kPool = 0, kUp = 1, kHead = 2 };

struct MegaStage {
  ConvSrc src;
  DoubleConvWeights w;
  uint16_t* out;        // (B, H, W, Cout) bf16; null for the head stage
  uint16_t* aux;        // kPool: (B, H/2, W/2, Cout); kUp: (B, 2H, 2W, up_cout)
  const uint16_t* upw;  // (4 * up_cout_p, Cout_p): row tap * up_cout_p + co
  const uint16_t* upb;  // (up_cout_p,)
  HeadArgs head;
  int kind, H, W, up_cout, up_cout_p;
  DoubleConvTile tile;  // double_conv_tile_for(Cmid_p), set by the launch code
};

struct MegaParams {
  MegaStage st[kMaxStages];
  int n_stages;
  int B;
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

// 2x2 max pool of the tile at (ty0, tx0) of plane (B, H, W, C), which this
// block has just written, into pooled (B, H/2, W/2, C). H, W, ty0 and tx0
// are even.
template <int TH, int TW>
__device__ __forceinline__ void pool_tile(const uint16_t* plane,
                                          uint16_t* pooled, int C, int b, int H,
                                          int W, int ty0, int tx0) {
  constexpr int PW = TW / 2;
  constexpr int PP = (TH / 2) * PW;
  const int Hp = H / 2;
  const int Wp = W / 2;
  const size_t row = (size_t)W * C;
  if ((C & 7) == 0) {
    const int vec = C >> 3;
    for (int i = threadIdx.x; i < PP * vec; i += kThreads) {
      const int v = i % vec;
      const int pp = i / vec;
      const int py = ty0 / 2 + pp / PW;
      const int px = tx0 / 2 + pp % PW;
      if (py >= Hp || px >= Wp) continue;
      const uint16_t* s =
          plane + (((size_t)b * H + 2 * py) * W + 2 * px) * C + v * 8;
      const uint4 top = max_bf16x8(*reinterpret_cast<const uint4*>(s),
                                   *reinterpret_cast<const uint4*>(s + C));
      const uint4 bot = max_bf16x8(*reinterpret_cast<const uint4*>(s + row),
                                   *reinterpret_cast<const uint4*>(s + row + C));
      *reinterpret_cast<uint4*>(
          pooled + (((size_t)b * Hp + py) * Wp + px) * C + v * 8) =
          max_bf16x8(top, bot);
    }
  } else {
    for (int i = threadIdx.x; i < PP * C; i += kThreads) {
      const int ch = i % C;
      const int pp = i / C;
      const int py = ty0 / 2 + pp / PW;
      const int px = tx0 / 2 + pp % PW;
      if (py >= Hp || px >= Wp) continue;
      const uint16_t* s = plane + (((size_t)b * H + 2 * py) * W + 2 * px) * C;
      const float m = fmaxf(fmaxf(bf2f(s, ch), bf2f(s + C, ch)),
                            fmaxf(bf2f(s + row, ch), bf2f(s + row + C, ch)));
      reinterpret_cast<__nv_bfloat16*>(
          pooled)[(((size_t)b * Hp + py) * Wp + px) * C + ch] =
          __float2bfloat16_rn(m);
    }
  }
}

// 2x2 stride-2 transposed conv of the tile at (ty0, tx0) of plane
// (B, H, W, Cin), which this block has just written, into up
// (B, 2H, 2W, Cout): up[2y+dy, 2x+dx, :] = bf16(bf16(plane[y, x, :] @
// w[dy, dx]) + bias), the product accumulated in fp32. upw: (4 * Cout_p,
// Cin_p) bf16, row (2*dy + dx) * Cout_p + co. xs: 2 x TH*TW*(KC+8), ws:
// 2 x 32*(KC+8) bf16 of shared memory.
template <int TH, int TW, int KC>
__device__ __forceinline__ void up_tile(uint16_t* xs, uint16_t* ws,
                                        const uint16_t* plane, int Cin,
                                        int Cin_p, const uint16_t* upw,
                                        const uint16_t* upb, uint16_t* up,
                                        int Cout, int Cout_p, int b, int H,
                                        int W, int ty0, int tx0) {
  constexpr int KS = KC + 8;
  constexpr int P = TH * TW;
  constexpr int MT = P / 16;
  constexpr int MI = (MT + kWarpsM - 1) / kWarpsM;
  constexpr int AS = P * KS;    // one staged pixel chunk
  constexpr int BS = kNC * KS;  // one staged weight chunk
  const Lane ln;
  const ConvSrc src{plane, nullptr, Cin, Cin_p, 0};
  const int b_off = (ln.b_n * KS + ln.b_k) * 2;
  int a_off[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i)
    a_off[i] = (((ln.wm + kWarpsM * i) * 16 + ln.a_row) * KS + ln.a_k) * 2;
  const int kch = Cin_p / KC;
  const int n_chunks = (4 * Cout_p / kNC) * kch;
  float acc[MI][kNI][4];
  load_x_chunk<TH, TW, KC>(xs, src, b, H, W, ty0, tx0, 0);
  load_w_chunk<KC, 1>(ws, upw, 0, 0, Cin_p);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = (c / kch) * kNC;
    const int kc = c % kch;
    if (c + 1 < n_chunks) {
      const int nb = (c + 1) & 1;
      load_x_chunk<TH, TW, KC>(xs + nb * AS, src, b, H, W, ty0, tx0,
                               ((c + 1) % kch) * KC);
      load_w_chunk<KC, 1>(ws + nb * BS, upw, ((c + 1) / kch) * kNC,
                          ((c + 1) % kch) * KC, Cin_p);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (kc == 0) zero_acc<MI>(acc);
    mma_chunk<MI, MT, KC, 1>(acc, smem_u32(xs + (c & 1) * AS), a_off, KS * 2, 0,
                             smem_u32(ws + (c & 1) * BS) + b_off, ln.wm);
    if (kc == kch - 1) {
      const int tap = n0 / Cout_p;  // a 32-column chunk lies inside one tap
      const int co0 = n0 - tap * Cout_p;
      const int dy = tap >> 1;
      const int dx = tap & 1;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mt = ln.wm + kWarpsM * i;
        if (mt >= MT) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = mt * 16 + ln.g + 8 * h;
          const int gy = ty0 + o / TW;
          const int gx = tx0 + o % TW;
          if (gy >= H || gx >= W) continue;
          uint16_t* dst = up + (((size_t)b * 2 * H + 2 * gy + dy) * 2 * W +
                                2 * gx + dx) * Cout;
#pragma unroll
          for (int j = 0; j < kNI; ++j) {
            const int n = co0 + (ln.wn * kNI + j) * 8 + 2 * ln.q4;
            if (n >= Cout) continue;
            const float v0 =
                __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h])) +
                bf2f(upb, n);
            const float v1 =
                __bfloat162float(__float2bfloat16_rn(acc[i][j][2 * h + 1])) +
                bf2f(upb, n + 1);
            store_bf16_pair(dst, n, Cout, v0, v1);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int TH, int TW, int KC>
__device__ __forceinline__ void run_stage(const MegaStage& st, int B,
                                          uint16_t* smem) {
  using S = DoubleConvSmem<TH, TW, KC>;
  static_assert(TH * TW * (KC + 8) <= S::G1::XS && kNC * (KC + 8) <= S::G1::WS,
                "the upsample's chunks must fit the conv's buffers");
  const int tiles_x = (st.W + TW - 1) / TW;
  const int tiles_y = (st.H + TH - 1) / TH;
  const int n_items = B * tiles_y * tiles_x;
  uint16_t* xs = smem + S::inter_elems(st.w.Cmid_p);
  uint16_t* ws = xs + 2 * S::G1::XS;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int t = item;
    const int tx0 = (t % tiles_x) * TW;
    t /= tiles_x;
    const int ty0 = (t % tiles_y) * TH;
    const int b = t / tiles_y;
    if (st.kind == kHead) {
      double_conv_tile<TH, TW, KC, true>(smem, st.src, st.w, b, st.H, st.W, ty0,
                                         tx0, nullptr, st.head);
      continue;
    }
    double_conv_tile<TH, TW, KC, false>(smem, st.src, st.w, b, st.H, st.W, ty0,
                                        tx0, st.out, st.head);
    // the block's own writes to st.out are visible to it after the barrier
    // that ends double_conv_tile
    if (st.kind == kPool) {
      pool_tile<TH, TW>(st.out, st.aux, st.w.Cout, b, st.H, st.W, ty0, tx0);
    } else {
      up_tile<TH, TW, KC>(xs, ws, st.out, st.w.Cout, st.w.Cout_p, st.upw,
                          st.upb, st.aux, st.up_cout, st.up_cout_p, b, st.H,
                          st.W, ty0, tx0);
    }
  }
}

size_t tile_smem(DoubleConvTile t, int cmid_p) {
  switch (t) {
    case kTile16Kc32: return DoubleConvSmem<16, 16, 32>::bytes(cmid_p);
    case kTile8Kc16: return DoubleConvSmem<8, 8, 16>::bytes(cmid_p);
    default: return DoubleConvSmem<8, 8, 32>::bytes(cmid_p);
  }
}

__global__ void __launch_bounds__(kThreads)
unet_mega_kernel(const __grid_constant__ MegaParams p) {
  extern __shared__ uint4 smem_u4[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_u4);
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < p.n_stages; ++s) {
    const MegaStage& st = p.st[s];
    switch (st.tile) {
      case kTile16Kc32: run_stage<16, 16, 32>(st, p.B, smem); break;
      case kTile8Kc16: run_stage<8, 8, 16>(st, p.B, smem); break;
      default: run_stage<8, 8, 32>(st, p.B, smem); break;
    }
    // the next stage reads this one's planes, halo pixels of other blocks'
    // tiles included
    if (s + 1 < p.n_stages) grid.sync();
  }
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
  if (B <= 0) return 0;
  if (n_stages <= 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  const char* wb = static_cast<const char*>(weights);
  uint16_t* sb = static_cast<uint16_t*>(scratch);
  auto w16 = [&](long long off) {
    return reinterpret_cast<const uint16_t*>(wb + off);
  };
  auto plane = [&](long long off) -> uint16_t* {
    return off < 0 ? nullptr : sb + off;
  };
  MegaParams p;
  p.n_stages = n_stages;
  p.B = B;
  size_t smem = 0;
  long long max_items = 1;
  for (int s = 0; s < n_stages; ++s) {
    const long long* f = plan + (size_t)s * kPlanFields;
    MegaStage& st = p.st[s];
    st.kind = (int)f[0];
    st.H = (int)f[1];
    st.W = (int)f[2];
    st.src.p0 = f[3] < 0 ? static_cast<const uint16_t*>(x) : sb + f[3];
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
    if (st.kind < kPool || st.kind > kHead || st.H <= 0 || st.W <= 0 ||
        st.w.Cin_p % kChanPad || st.w.Cmid_p % kChanPad ||
        st.w.Cout_p % kChanPad || st.src.c0p % kChanPad ||
        st.w.Cout > st.w.Cout_p || st.w.Cout <= 0 ||
        (st.kind == kUp && (st.up_cout_p % kChanPad || st.up_cout <= 0 ||
                            st.up_cout > st.up_cout_p)) ||
        (st.kind == kPool && ((st.H | st.W) & 1)) ||
        (st.kind == kHead && (st.head.n_out <= 0 || st.head.n_out > kHeadOut)) ||
        (st.kind != kHead && (st.out == nullptr || st.aux == nullptr)))
      return (int)cudaErrorInvalidValue;
    st.tile = double_conv_tile_for(st.w.Cmid_p);
    const size_t need = tile_smem(st.tile, st.w.Cmid_p);
    if (need > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    smem = need > smem ? need : smem;
    const int side = double_conv_tile_side(st.tile);
    const long long items = (long long)B * ((st.H + side - 1) / side) *
                            ((st.W + side - 1) / side);
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    max_items = items > max_items ? items : max_items;
  }
  cudaError_t err = cudaFuncSetAttribute(
      unet_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // grid.sync() needs every block resident at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, unet_mega_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = (long long)sms * per_sm;
  blocks = blocks < max_items ? blocks : max_items;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(unet_mega_kernel), dim3((unsigned)blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
