// K9 in bf16 for Hopper (sm_90a): the stride-2 3x3 conv with statistics as
// a warp-specialised implicit GEMM, wgmma fed by TMA.
//
//   dtp_downsample_conv3x3_stats_sm90  K9 <- diffusiontexturepainting_tpu/
//       ops/gn_conv_stream.py _downconv_stream_pallas / _downconv_kernel:
//       the VAE encoder's level transition, a stride-2 3x3 conv over x
//       padded by one zero row below and one zero column to the right
//       (diffusers' Downsample2D, pad (0,1),(0,1)):
//         out[b,i,j,n] = bias[n] + sum_{di,dj,c} x[b,2i+di,2j+dj,c]
//                                                * w[di,dj,c,n]
//       for i < H/2, j < W/2, the bias added in fp32, fp32 (sum, sumsq) per
//       (b, n) of that value BEFORE its rounding to bf16, then the rounding.
//       fp32 stays on conv3x3.cu's kDown FMA twin (dispatch by dtype in
//       ops/gn_conv.py downconv_stream).
//
// What bounds it on the H100: 2*M*9*Cin*Cout flops against x, w and out
// read or written once: at the 256^2 stamp's three calls (M = 32768, 8192
// and 2048 output pixels, K = 9*128..9*512, N = 128..512) the tensor cores,
// 0.0322 ms for the three.
//
// Design. A CTA computes a tile of 16*R output pixels of one image (R rows
// of 16 columns) by 128 output channels: one producer warpgroup and NC
// consumer warpgroups of 64 pixels (4 rows) each, R = 4*NC.
//   - A, the tap's input pixels: TMA over x viewed as (C, W, H, B) with
//     traversal strides (1, 2, 2, 1): the box (64, 32, 2R, 1) at
//     (c0, 2*j0 + dj, 2*i0 + di, b) arrives as the tile's 16*R pixels by 64
//     channels, in pixel order, 128-byte swizzle: wgmma's K-major A. The
//     pad row and column (H, W) and channels past Cin lie out of bounds
//     and arrive as zeros; so do pixels past the image, masked at the end.
//   - B, the tap's weights w[di, dj, c0:c0+64, n0:n0+128]: two 64-column
//     TMA boxes over w viewed as (Cout, Cin, 9); N contiguous, so MN-major
//     (the transpose bit, as V in flash_attention_sm90.cu).
//   - The K loop runs over 9 taps x ceil(Cin/64) channel chunks through a
//     ring of kStages stages with full/empty mbarriers; one producer thread
//     issues the copies. Each consumer issues four wgmma m64n128k16 a stage
//     into fp32 registers and keeps one stage's products in flight
//     (wgmma.wait_group 1) before releasing the stage before it.
//   - Epilogue: + bias in fp32; each thread's two rows of its columns, if
//     inside the image, go into (sum, sumsq), added across the 8 row
//     groups of a warp by shuffles and across warps through shared memory
//     in a fixed order, into this tile's (2, Cout) slot of a partials
//     buffer; the values rounded to bf16 are staged in shared memory
//     (16-byte chunks XOR-swizzled by row: no bank conflicts) and stored as
//     16-byte rows of channels. A second kernel adds each image's tile
//     partials in tile order. No atomics: a replay is bit-identical, and
//     these statistics feed every next GroupNorm.
// Grid: (N tiles, M tiles), the N tiles of one pixel tile adjacent so they
// share its A reads in L2. Grid fill (plan): two consumer warpgroups (128
// pixels) unless that grid leaves more than half the SMs idle, else one
// (64 pixels): (2, 64, 64, 512) runs 128 CTAs, not 64.
// Against conv3x3.cu's kDown: no fp32 round trip of the output, no finish
// and reduce passes over it, partials of (tiles, 2, Cout) floats (4 MiB at
// the 1024^2 envelope's largest call, where the old workspace was 256 MiB).
#include "conv_sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kAtom = 64;   // bf16 channels of one 128-byte swizzle atom
constexpr int kTileW = 16;  // output columns of a tile
constexpr int kBN = 128;    // output channels of a tile
constexpr int kSMs = 132;   // H100 SXM

template <int NC>
struct ConvPlan {
  static constexpr int kRows = 4 * NC;  // output rows of a tile
  static constexpr int kPix = 64 * NC;  // pixels of a tile
  static constexpr int kStages = 4;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kABytes = kPix * 128;         // kPix x 64 channels
  static constexpr int kBBytes = kAtom * kBN * 2;    // 64 channels x kBN
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOut = kStages * kStageBytes;  // bf16 output staging
  static constexpr int kRed = kOut + kPix * kBN * 2;  // per-warp (s1, s2)
  static constexpr int kBar = kRed + 4 * NC * 2 * kBN * 4;
  // full[kStages], empty[kStages]; 1024 bytes of slack align the base
  static constexpr int kSmem = kBar + 8 * 2 * kStages + 1024;
  static_assert(kSmem <= 232448, "shared memory");
};

struct DownArgs {
  const bf16* bias;  // (Cout,) or null
  bf16* out;         // (B, OH, OW, Cout)
  float* partial;    // (tiles, 2, Cout), or null: no statistics
  int OH, OW, Cin, Cout;
  int tiles_h, tiles_w;  // tiles of an image
};

template <int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
downconv_sm90(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw, const DownArgs a) {
  using P = ConvPlan<NC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  auto full = [&](int s) { return base + P::kBar + 8 * s; };
  auto empty = [&](int s) { return base + P::kBar + 8 * (P::kStages + s); };
  auto stage_a = [&](int s) { return base + s * P::kStageBytes; };
  auto stage_b = [&](int s) { return stage_a(s) + P::kABytes; };

  const int n0 = blockIdx.x * kBN;
  const int tile = blockIdx.y;
  const int per_image = a.tiles_h * a.tiles_w;
  const int b = tile / per_image, rem = tile % per_image;
  const int i0 = (rem / a.tiles_w) * P::kRows, j0 = (rem % a.tiles_w) * kTileW;
  const int chunks = (a.Cin + kAtom - 1) / kAtom;
  const int iters = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    if (threadIdx.x == 0) {
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        const int s = it % P::kStages;
        const int tap = it / chunks, c0 = (it % chunks) * kAtom;
        mbar_wait(empty(s), ((it / P::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), P::kStageBytes);
        tma_load(stage_a(s), &tx, full(s), c0, 2 * j0 + tap % 3,
                 2 * i0 + tap / 3, b);
        tma_load(stage_b(s), &tw, full(s), n0, c0, tap, 0);
        tma_load(stage_b(s) + kAtom * 128, &tw, full(s), n0 + kAtom, c0,
                 tap, 0);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq4 = lane % 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int s = it % P::kStages;
    mbar_wait(full(s), (it / P::kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma128::ss_t(acc, desc128(stage_a(s) + wg * 64 * 128 + kk * 32, 16),
                     desc128(stage_b(s) + kk * 16 * 128, kAtom * 128), 1);
    wg_commit();
    // the previous stage's products are done: release it
    wg_wait<1>();
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((it - 1) % P::kStages));
    }
  }
  wg_wait<0>();
  fence_regs(acc);

  // ---- epilogue ----
  // this thread's rows r0 and r0 + 8 of the warpgroup's 64 pixels
  const int r0 = 16 * warp + g;
  auto inside = [&](int r) {
    const int p = wg * 64 + r;
    return i0 + p / kTileW < a.OH && j0 + p % kTileW < a.OW;
  };
  const bool ok0 = inside(r0), ok1 = inside(r0 + 8);
  float* const red = reinterpret_cast<float*>(gbase + P::kRed);
  uint8_t* const stage = gbase + P::kOut + wg * 64 * kBN * 2;
  const int wid = wg * 4 + warp;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = 8 * i + 2 * tq4;
    float bv0 = 0.0f, bv1 = 0.0f;
    if (a.bias != nullptr && n0 + n < a.Cout) {
      bv0 = __bfloat162float(a.bias[n0 + n]);
      bv1 = __bfloat162float(a.bias[n0 + n + 1]);
    }
    const float v0 = acc[4 * i] + bv0, v1 = acc[4 * i + 1] + bv1;
    const float v2 = acc[4 * i + 2] + bv0, v3 = acc[4 * i + 3] + bv1;
    if (a.partial != nullptr) {
      float s10 = (ok0 ? v0 : 0.0f) + (ok1 ? v2 : 0.0f);
      float s11 = (ok0 ? v1 : 0.0f) + (ok1 ? v3 : 0.0f);
      float s20 = (ok0 ? v0 * v0 : 0.0f) + (ok1 ? v2 * v2 : 0.0f);
      float s21 = (ok0 ? v1 * v1 : 0.0f) + (ok1 ? v3 * v3 : 0.0f);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s10 += __shfl_xor_sync(0xffffffffu, s10, off);
        s11 += __shfl_xor_sync(0xffffffffu, s11, off);
        s20 += __shfl_xor_sync(0xffffffffu, s20, off);
        s21 += __shfl_xor_sync(0xffffffffu, s21, off);
      }
      if (g == 0) {
        float* rw = red + wid * 2 * kBN;
        rw[n] = s10, rw[n + 1] = s11;
        rw[kBN + n] = s20, rw[kBN + n + 1] = s21;
      }
    }
    const int chunk0 = (i ^ (r0 & 7)) * 16 + 4 * tq4;
    const int chunk1 = (i ^ ((r0 + 8) & 7)) * 16 + 4 * tq4;
    *reinterpret_cast<uint32_t*>(stage + r0 * kBN * 2 + chunk0) =
        pack_bf16(v0, v1);
    *reinterpret_cast<uint32_t*>(stage + (r0 + 8) * kBN * 2 + chunk1) =
        pack_bf16(v2, v3);
  }
  bar_sync(1, NC * 128);
  const int ct = threadIdx.x - 128;  // 0 .. NC*128 - 1
  if (a.partial != nullptr) {
    float* const dst = a.partial + static_cast<long long>(tile) * 2 * a.Cout;
#pragma unroll 1
    for (int v = ct; v < 2 * kBN; v += NC * 128) {
      const int row = v / kBN, n = v % kBN;
      if (n0 + n >= a.Cout) continue;
      float sum = 0.0f;
      for (int w = 0; w < 4 * NC; ++w) sum += red[(w * 2 + row) * kBN + n];
      dst[row * a.Cout + n0 + n] = sum;
    }
  }
  // 16-byte stores: a pixel's kBN channels are 16 chunks of 8
  const uint8_t* const out_stage = gbase + P::kOut;
#pragma unroll 1
  for (int v = ct; v < P::kPix * (kBN / 8); v += NC * 128) {
    const int p = v / (kBN / 8), c = v % (kBN / 8);
    const int i = i0 + p / kTileW, j = j0 + p % kTileW;
    if (i >= a.OH || j >= a.OW || n0 + 8 * c >= a.Cout) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        out_stage + p * kBN * 2 + ((c ^ (p & 7)) * 16));
    *reinterpret_cast<uint4*>(
        a.out + ((static_cast<long long>(b) * a.OH + i) * a.OW + j) *
                    a.Cout + n0 + 8 * c) = val;
  }
}

struct DownPlan {
  int nc, rows, stages, smem, tiles_h, tiles_w, m_tiles, n_tiles;
};

template <int NC>
DownPlan plan_of(int B, int OH, int OW, int Cout) {
  using P = ConvPlan<NC>;
  DownPlan p{};
  p.nc = NC, p.rows = P::kRows, p.stages = P::kStages, p.smem = P::kSmem;
  p.tiles_h = (OH + P::kRows - 1) / P::kRows;
  p.tiles_w = (OW + kTileW - 1) / kTileW;
  p.m_tiles = B * p.tiles_h * p.tiles_w;
  p.n_tiles = (Cout + kBN - 1) / kBN;
  return p;
}

// Two consumer warpgroups unless that grid would leave more than half of
// the SMs idle; `nc` 1 or 2 forces the choice (mirrored by ops/gn_conv.py
// downconv_sm90_plan).
DownPlan plan(int B, int H, int W, int Cout, int nc) {
  const DownPlan two = plan_of<2>(B, H / 2, W / 2, Cout);
  if (nc == 2 || (nc == 0 && 2LL * two.m_tiles * two.n_tiles >= kSMs))
    return two;
  return plan_of<1>(B, H / 2, W / 2, Cout);
}

template <int NC>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const DownArgs& a, const DownPlan& p,
                   cudaStream_t stream) {
  auto kern = downconv_sm90<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.n_tiles, p.m_tiles), ConvPlan<NC>::kThreads, p.smem,
         stream>>>(tx, tw, a);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int Cin, int Cout) {
  return B <= 0 || H < 2 || W < 2 || Cin <= 0 || Cout <= 0 || Cin % 8 ||
         Cout % 8;
}

}  // namespace
}  // namespace dtp

// The plan of a call, {consumer warpgroups, output rows a tile, stages,
// dynamic shared memory bytes, tiles down and across an image, M tiles,
// N tiles} into out[8] (the tests hold ops/gn_conv.py downconv_sm90_plan
// against it); `nc` as for the entry.
extern "C" int dtp_downsample_conv3x3_sm90_plan(int B, int H, int W, int Cin,
                                                int Cout, int nc, int* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout) || nc < 0 || nc > 2) return -1;
  const dtp::DownPlan p = dtp::plan(B, H, W, Cout, nc);
  const int v[8] = {p.nc,      p.rows,    p.stages,  p.smem,
                    p.tiles_h, p.tiles_w, p.m_tiles, p.n_tiles};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K9: x (B,H,W,Cin) with H, W >= 2, w (3,3,Cin,Cout), bias (Cout,) or null,
// out (B,H/2,W/2,Cout), contiguous bf16 with 16-byte-aligned bases and
// Cin, Cout multiples of 8 (TMA's 16-byte strides). With want_stats,
// `partial` holds m_tiles * 2 * Cout floats (the plan's) and `stats`
// (B, 2, Cout) fp32 receives the sums; `nc` 0 for the plan's tile, 1 or 2
// to force its consumer warpgroups (a probe's).
extern "C" cudaError_t dtp_downsample_conv3x3_stats_sm90(
    const void* x, const void* w, const void* bias, void* out, void* partial,
    void* stats, int B, int H, int W, int Cin, int Cout, int want_stats,
    int nc, void* stream) {
  using namespace dtp;
  if (bad_shape(B, H, W, Cin, Cout) || nc < 0 || nc > 2 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) ||
      (want_stats && (partial == nullptr || stats == nullptr)))
    return cudaErrorInvalidValue;
  const DownPlan p = plan(B, H, W, Cout, nc);
  if (p.m_tiles > 65535 || p.n_tiles > 65535) return cudaErrorInvalidValue;
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[3] = {static_cast<cuuint64_t>(Cin) * 2,
                            static_cast<cuuint64_t>(W) * Cin * 2,
                            static_cast<cuuint64_t>(H) * W * Cin * 2};
  const cuuint32_t xbox[4] = {kAtom, 2 * kTileW,
                              static_cast<cuuint32_t>(2 * p.rows), 1};
  const cuuint32_t xstep[4] = {1, 2, 2, 1};
  const cuuint64_t wd[4] = {static_cast<cuuint64_t>(Cout),
                            static_cast<cuuint64_t>(Cin), 9, 1};
  const cuuint64_t ws[3] = {static_cast<cuuint64_t>(Cout) * 2,
                            static_cast<cuuint64_t>(Cin) * Cout * 2,
                            static_cast<cuuint64_t>(9) * Cin * Cout * 2};
  const cuuint32_t wbox[4] = {kAtom, kAtom, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap tx, tw;
  if (!tensor_map_4d(&tx, x, xd, xs, xbox, xstep) ||
      !tensor_map_4d(&tw, w, wd, ws, wbox, unit))
    return cudaErrorInvalidValue;
  DownArgs a{};
  a.bias = static_cast<const bf16*>(bias);
  a.out = static_cast<bf16*>(out);
  a.partial = want_stats ? static_cast<float*>(partial) : nullptr;
  a.OH = H / 2, a.OW = W / 2, a.Cin = Cin, a.Cout = Cout;
  a.tiles_h = p.tiles_h, a.tiles_w = p.tiles_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = p.nc == 2 ? launch<2>(tx, tw, a, p, s)
                              : launch<1>(tx, tw, a, p, s);
  if (err != cudaSuccess || !want_stats) return err;
  return launch_tile_stats_reduce(static_cast<const float*>(partial),
                                  static_cast<float*>(stats), B,
                                  p.tiles_h * p.tiles_w, Cout, s);
}
