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
//   * An encoder item then max-pools its own tiles (they start at even
//     pixels, so every 2x2 window lies inside one) into the next level's
//     input plane. A bottleneck or decoder item then upsamples its own
//     tiles: a (pixels x Cin) @ (Cin x 4*Cout) product through the wgmma
//     path as a conv of one tap, each tap's result rounded to bf16, the bf16
//     bias added in bf16, scattered to the 2x2 output pixels. Both read the
//     tiles back from device memory after a block barrier: the block wrote
//     them itself.
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
// fused_double_conv.cu (weights re-read from L2 per item, the ring's
// recompute, raster rows padded to 64), and because a stage ends when its
// slowest block does: the bottleneck of 128 tiles of 96 x 96 is 64 items for
// 132 SMs.
// Plain interface for ctypes; the launch returns its cudaError_t.

#include <cooperative_groups.h>

#include "conv_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pk;

constexpr int kMaxStages = 17;  // depth <= 8
constexpr int kPlanFields = 32;
constexpr int kTile = 16;  // the mma.sync path's tile
constexpr int kKC = 32;
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
  int kind, H, W, up_cout, up_cout_p, up_kp;
  int path;             // 1: wgmma, 0: mma.sync on 16 x 16 tiles
  WgTile tile;          // output tile and images of one item
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

// 2x2 max pool of the th x tw tile at (ty0, tx0) of image b of plane
// (B, H, W, C), which this block has just written, into pooled
// (B, H/2, W/2, C). H, W, th, tw, ty0 and tx0 are even.
__device__ __forceinline__ void pool_tile(const uint16_t* plane,
                                          uint16_t* pooled, int C, int b, int H,
                                          int W, int ty0, int tx0, int th,
                                          int tw) {
  const int PW = tw / 2;
  const int PP = (th / 2) * PW;
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

// 2x2 stride-2 transposed conv of the th x tw tiles at (ty0, tx0) of images
// b0 .. b0 + g - 1 of st.out, which this block has just written, into
// st.aux: up[2y+dy, 2x+dx, :] = bf16(bf16(out[y, x, :] @ w[dy, dx]) + bias),
// the product accumulated in fp32, as a one-tap conv on the wgmma path
// whose A operand is the tiles' pixels. stream: st.upw's, whose first stages
// the item's second conv may have sent already.
__device__ __forceinline__ void up_item(uint8_t* smem, WgPipe& pipe,
                                        const MegaStage& st, WgStream& stream,
                                        int B, int b0, int ty0, int tx0) {
  const WgTile t = st.tile;
  const int rows = t.g * t.th * t.tw;
  const int pitch = wg_a_pitch(rows, rows, 0, 1);
  const ConvSrc src{st.out, nullptr, st.w.Cout, st.up_kp, 0};
  const WgPatch patch{B, st.H, st.W, b0, t.g, t.th, t.tw, ty0, tx0};
  const WgConv cv{rows, 0, pitch};
  WgStageLoad load{src, patch, pitch};
  WgUpEpi epi{st.upb, st.aux, st.up_cout, st.up_cout_p, t.g, t.th, t.tw,
              B,      st.H,   st.W,       b0,           ty0, tx0};
  wg_conv<true>(pipe, cv, stream, nullptr,
                smem_u32(smem) + kWgBarBytes + kWgRingBytes,
                (uint32_t)(kWgKC / 8) * pitch * 16, load, epi);
}

// Shared memory of a stage: the barriers and the weight ring, then the
// path's own buffers; the upsample's two input buffers lie over them.
size_t stage_smem(const MegaStage& st) {
  const int rows = st.tile.g * st.tile.th * st.tile.tw;
  const size_t up =
      kWgBarBytes + kWgRingBytes +
      2 * (size_t)(kWgKC / 8) * wg_a_pitch(rows, rows, 0, 1) * 16;
  const size_t conv =
      st.path == 1
          ? WgGeom(st.tile, 1, st.w.Cmid_p).smem_bytes(st.kind == kHead)
          : kWgBarBytes + kWgRingBytes +
                DoubleConvSmem<kTile, kTile, kKC>::bytes(st.w.Cmid_p);
  return conv > up ? conv : up;
}

// One item of a stage, by path and kind. All are inlined into the kernel: a
// wgmma pipeline must not cross a function call (the compiler serialises it
// there), and a called function gets a smaller register budget than the
// accumulators need.
struct Item {
  int b0, ty0, tx0;
};

__device__ __forceinline__ WgPipe item_wgmma(const MegaStage& st, int B,
                                          uint8_t* smem, WgPipe pipe, Item it) {
  // an upsampling item's second conv sends the upsample's first stages
  const bool up = st.kind == kUp;
  WgStream ups(st.upw, 0, up ? 4 * st.up_cout_p / kWgN : 0,
               up ? st.up_kp / kWgKC : 0, 1);
  wg_double_conv_item<false>(smem, pipe, st.src, st.w, B, st.H, st.W, it.b0,
                             it.ty0, it.tx0, st.tile, st.out, st.head,
                             up ? &ups : nullptr);
  if (up) up_item(smem, pipe, st, ups, B, it.b0, it.ty0, it.tx0);
  return pipe;
}

__device__ __forceinline__ WgPipe item_wgmma_head(const MegaStage& st, int B,
                                               uint8_t* smem, WgPipe pipe,
                                               Item it) {
  wg_double_conv_item<true>(smem, pipe, st.src, st.w, B, st.H, st.W, it.b0,
                            it.ty0, it.tx0, st.tile, nullptr, st.head,
                            nullptr);
  return pipe;
}

__device__ __forceinline__ void item_mma(const MegaStage& st, uint8_t* smem,
                                      Item it) {
  uint16_t* mma_smem =
      reinterpret_cast<uint16_t*>(smem + kWgBarBytes + kWgRingBytes);
  if (st.kind == kHead)
    double_conv_tile<kTile, kTile, kKC, true>(mma_smem, st.src, st.w, it.b0,
                                              st.H, st.W, it.ty0, it.tx0,
                                              nullptr, st.head);
  else
    double_conv_tile<kTile, kTile, kKC, false>(mma_smem, st.src, st.w, it.b0,
                                               st.H, st.W, it.ty0, it.tx0,
                                               st.out, st.head);
}

__device__ __forceinline__ WgPipe item_up(const MegaStage& st, int B,
                                       uint8_t* smem, WgPipe pipe, Item it) {
  WgStream ups(st.upw, 0, 4 * st.up_cout_p / kWgN, st.up_kp / kWgKC, 1);
  up_item(smem, pipe, st, ups, B, it.b0, it.ty0, it.tx0);
  return pipe;
}

__device__ __forceinline__ void run_stage(const MegaStage& st, int B,
                                          uint8_t* smem, WgPipe& pipe) {
  const WgTile t = st.tile;
  const int tiles_x = (st.W + t.tw - 1) / t.tw;
  const int tiles_y = (st.H + t.th - 1) / t.th;
  const int n_items = ((B + t.g - 1) / t.g) * tiles_y * tiles_x;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int i = item;
    Item it;
    it.tx0 = (i % tiles_x) * t.tw;
    i /= tiles_x;
    it.ty0 = (i % tiles_y) * t.th;
    it.b0 = (i / tiles_y) * t.g;
    if (st.path == 1) {
      pipe = st.kind == kHead ? item_wgmma_head(st, B, smem, pipe, it)
                              : item_wgmma(st, B, smem, pipe, it);
    } else {
      item_mma(st, smem, it);
      if (st.kind == kUp) pipe = item_up(st, B, smem, pipe, it);
    }
    // either path ends at a block barrier: the block's own writes to st.out
    // are visible to it
    if (st.kind == kPool)
      for (int g = 0; g < t.g && it.b0 + g < B; ++g)
        pool_tile(st.out, st.aux, st.w.Cout, it.b0 + g, st.H, st.W, it.ty0,
                  it.tx0, t.th, t.tw);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
unet_mega_kernel(const __grid_constant__ MegaParams p) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  cg::grid_group grid = cg::this_grid();
  WgPipe pipe = wg_pipe_init(smem);
  for (int s = 0; s < p.n_stages; ++s) {
    run_stage(p.st[s], p.B, smem, pipe);
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
    st.path = (int)f[27];
    st.tile = WgTile{(int)f[28], (int)f[29], (int)f[30]};
    st.up_kp = (int)f[31];
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
    const size_t need = stage_smem(st);
    if (need > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    smem = need > smem ? need : smem;
    const long long items = (long long)((B + t.g - 1) / t.g) *
                            ((st.H + t.th - 1) / t.th) *
                            ((st.W + t.tw - 1) / t.tw);
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
