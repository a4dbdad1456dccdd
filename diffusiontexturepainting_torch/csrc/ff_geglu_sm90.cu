// K3 in bf16 for Hopper (sm_90a): the GEGLU feed-forward with its residual
// as two warp-specialised GEMMs, wgmma fed by TMA, with the GEGLU and the
// residual in their epilogues.
//
//   dtp_ff_geglu_sm90  K3 <- diffusiontexturepainting_tpu/ops/ff_geglu.py
//       _ff_geglu_pallas / _ff_kernel, over (N, C) tokens:
//         [v | g] = x w0^T + b0                 (fp32)
//         h       = round(v * gelu_erf(g))      (one rounding to bf16)
//         out     = round(h w2^T + b2 + residual)  (fp32 sums, one rounding)
//       w0 (2*inner, C) with the value rows first and w2 (C, inner) in
//       nn.Linear's (out, in) layout: both are K-major B operands of wgmma
//       as they stand, so no transposed copy exists. The Pallas kernel's
//       default GELU is the tanh form (a TPU speed trade); this one computes
//       the erf GELU of the module GEGLU and of the JAX package's
//       _reference. fp32 stays on ff_geglu.cu's FMA twin (dispatch by dtype
//       in ops/ff_geglu.py ff_geglu).
//
// What bounds it on the H100: 6*N*C*inner operations against 3*C*inner
// weights. At the 1024^2 UNet's level 0 (N 49152, C 320, inner 1280) the
// tensor cores (about 122 us at 989 TFLOP/s); at the 256^2 UNet's level 2
// and mid block (N 192 and 48, C 1280, inner 5120) the 39 MB of weights
// (about 11.7 us at 3.35 TB/s), which every SM has to help stream.
//
// Design. The TPU kernel keeps a token tile's y in VMEM across the inner
// axis; an SM cannot hold it, and splitting inner across blocks cost fp32
// partials of the whole output (ff_geglu.cu). Here h goes through device
// memory once, in bf16 (4*N*inner bytes written and read, 252 MB at the
// 1024^2 level 0 against 630 MB of fp32 partials), and the two products
// are one kernel template:
//   - A CTA: NC consumer warpgroups of 64 tokens and one producer warp
//     whose lane 0 keeps TMA loads in flight into a ring of stages (full
//     and empty mbarriers, 128-byte swizzle). A stage is a K step of 64:
//     64*NC rows of A and 128 rows of B, both K-major; each warpgroup runs
//     four m64n128k16 wgmma on it with both operands in shared memory and
//     releases the stage once the next step's products are issued.
//   - kGate (x w0^T, then the GEGLU): the CTA's N tile is 64 inner
//     columns i0..i0+63, its B two TMA boxes of w0: the value rows
//     i0..i0+63 as columns 0-63 and the gate rows inner+i0.. as 64-127.
//     In the accumulator layout a thread then holds v[:, j] and g[:, j] of
//     the same column (accumulators 4i+e and 4(i+8)+e), so the epilogue
//     (+ b0, erf GELU, the product, one rounding) needs no shuffle; h is
//     staged in the warpgroup's own A region (16-byte chunks XOR-swizzled
//     by row) and stored as 16-byte rows.
//   - kDown (h w2^T, then the residual): the N tile is 128 output
//     channels. Where tiles are fewer than the SMs (the 256^2 UNet's
//     levels 1, 2 and mid block), K splits in runs of whole steps over
//     blockIdx.z; each split stores its fp32 tile, and the last to finish
//     (an integer counter per tile, reset in the call) adds all splits in
//     split order: no float atomics, a replay is bit-identical. The
//     epilogue stages the residual by 16-byte loads, adds b2 and it to the
//     fp32 sums, rounds once, and stores 16-byte rows.
//   Ragged N comes in as TMA's out-of-bounds zeros and is masked on store;
//   inner or C off the tiles likewise (the value box of a ragged last
//   inner tile reads gate rows, whose h columns are never stored).
#include "sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kAtom = 64;  // K of a stage: 64 bf16, one 128-byte row
constexpr int kBN = 128;   // wgmma N: 64 inner columns' value and gate, or
                           // 128 output channels
constexpr int kIT = 64;    // inner columns of a kGate tile
constexpr int kSMs = 132;  // H100 SXM
constexpr int kGate = 0, kDown = 1;

// Stages of the ring: two CTAs fit an SM at either consumer count.
__host__ __device__ constexpr int stages_for(int nc) {
  return nc == 2 ? 3 : 4;
}
__host__ __device__ constexpr int stage_bytes(int nc) {
  return 64 * nc * 128 + kBN * 128;
}
__host__ __device__ constexpr int smem_for(int nc) {
  return stages_for(nc) * stage_bytes(nc) + 16 * stages_for(nc) + 16 + 1024;
}

// D (64 x 128, fp32) (+)= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float geglu(float v, float g) {
  return v * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
}

struct FFArgs {
  const bf16* bias;      // b0 (2*inner,) for kGate, b2 (C,) for kDown
  const bf16* residual;  // (N, C), kDown
  bf16* out;             // h (N, inner) for kGate, out (N, C) for kDown
  float* ws;             // the split tiles, fp32 (kDown)
  int* counters;         // one per output tile when split (kDown)
  int N, C, inner;
  int chunks, per_split, splits;
};

template <int MODE, int NC>
__global__ void __launch_bounds__(128 * NC + 32, 2)
ff_gemm_sm90(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, const FFArgs a) {
  constexpr int kCT = 128 * NC;  // consumer threads
  constexpr int kS = stages_for(NC);
  constexpr int kABytes = 64 * NC * 128;
  constexpr int kStage = stage_bytes(NC);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  auto a_st = [&](int s) { return base + s * kStage; };
  auto b_st = [&](int s) { return base + s * kStage + kABytes; };
  const uint32_t bars = base + kS * kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };
  int* const flag =
      reinterpret_cast<int*>(gbase + kS * kStage + 16 * kS);

  const int nt = blockIdx.x;  // the N tile
  const int m0 = blockIdx.y * 64 * NC;
  const int split = blockIdx.z;
  const int c_begin = split * a.per_split;
  const int nch = min(a.per_split, a.chunks - c_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCT) {
    // ---- the producer warp after the consumer warpgroups ----
    if (threadIdx.x == kCT) {
#pragma unroll 1
      for (int k = 0; k < nch; ++k) {
        const int s = k % kS;
        mbar_wait(empty(s), ((k / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), kStage);
        const int k0 = (c_begin + k) * kAtom;
        tma_load(a_st(s), &ta, full(s), k0, m0, 0, 0);
        if (MODE == kGate) {
          tma_load(b_st(s), &tb, full(s), k0, nt * kIT, 0, 0);
          tma_load(b_st(s) + kIT * 128, &tb, full(s), k0,
                   a.inner + nt * kIT, 0, 0);
        } else {
          tma_load(b_st(s), &tb, full(s), k0, nt * kBN, 0, 0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;

  // the first product overwrites acc: no instruction but wgmma defines it
  // before the pipeline's end, which ptxas would answer by serialising
  float acc[64];
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const int s = k % kS;
    mbar_wait(full(s), (k / kS) & 1);
    wg_fence();
    const uint32_t ad = a_st(s) + wg * 64 * 128, bd = b_st(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, desc128(ad + 32 * kk, 16), desc128(bd + 32 * kk, 16),
               k > 0 || kk > 0);
    wg_commit();
    // the previous step's products are done: its stage goes back
    wg_wait<1>();
    fence_regs(acc);
    if (k > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((k - 1) % kS));
    }
  }
  wg_wait<0>();
  fence_regs(acc);

  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  const int r0 = 16 * warp + g;

  if (MODE == kGate) {
    // h = v * gelu(g) + one rounding, staged in this warpgroup's A region
    // of stage 0 (its own products are done; no other warp reads it)
    uint8_t* const st = gbase + wg * 64 * 128;
    const int i0 = nt * kIT;
#pragma unroll
    for (int i = 0; i < kIT / 8; ++i) {
      const int j = i0 + 8 * i + 2 * tq4;
      float bv0 = 0.0f, bv1 = 0.0f, bg0 = 0.0f, bg1 = 0.0f;
      if (j < a.inner) {
        bv0 = __bfloat162float(a.bias[j]);
        bg0 = __bfloat162float(a.bias[a.inner + j]);
      }
      if (j + 1 < a.inner) {
        bv1 = __bfloat162float(a.bias[j + 1]);
        bg1 = __bfloat162float(a.bias[a.inner + j + 1]);
      }
      // value column j at accumulator 4i + e, its gate at 4(i + 8) + e
      constexpr int kG = 4 * (kIT / 8);
      *reinterpret_cast<uint32_t*>(st + r0 * 128 + ((i ^ g) << 4) +
                                   4 * tq4) =
          pack_bf16(geglu(acc[4 * i] + bv0, acc[kG + 4 * i] + bg0),
                    geglu(acc[4 * i + 1] + bv1, acc[kG + 4 * i + 1] + bg1));
      *reinterpret_cast<uint32_t*>(st + (r0 + 8) * 128 + ((i ^ g) << 4) +
                                   4 * tq4) =
          pack_bf16(geglu(acc[4 * i + 2] + bv0, acc[kG + 4 * i + 2] + bg0),
                    geglu(acc[4 * i + 3] + bv1, acc[kG + 4 * i + 3] + bg1));
    }
    bar_sync(2 + wg, 128);
#pragma unroll 1
    for (int v = threadIdx.x % 128; v < 64 * 8; v += 128) {
      const int r = v / 8, c = v % 8;
      const int m = m0 + wg * 64 + r, col = i0 + 8 * c;
      if (m < a.N && col < a.inner)
        *reinterpret_cast<uint4*>(a.out + static_cast<long long>(m) *
                                              a.inner + col) =
            *reinterpret_cast<const uint4*>(st + r * 128 + ((c ^ (r & 7))
                                                             << 4));
    }
    return;
  }

  // ---- kDown: split K, the last split of the tile adds all in order ----
  const long long tile_mn =
      static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  if (a.splits > 1) {
    float2* mine = reinterpret_cast<float2*>(
        a.ws + (tile_mn * a.splits + split) * 64 * NC * kBN);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      __stcg(mine + i * kCT + ct, make_float2(acc[2 * i], acc[2 * i + 1]));
    __threadfence();
    bar_sync(1, kCT);
    if (ct == 0) *flag = atomicAdd(a.counters + tile_mn, 1);
    bar_sync(1, kCT);
    if (*flag != a.splits - 1) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < a.splits; ++s) {
      const float2* part = reinterpret_cast<const float2*>(
          a.ws + (tile_mn * a.splits + s) * 64 * NC * kBN);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 v = __ldcg(part + i * kCT + ct);
        acc[2 * i] += v.x;
        acc[2 * i + 1] += v.y;
      }
    }
  }

  // the residual, then the output, staged over the ring (rows of 128
  // channels, 16-byte chunks XOR-swizzled by row)
  const int n0 = nt * kBN;
  uint8_t* const stage = gbase;
  bar_sync(1, kCT);  // every warpgroup's products are done
#pragma unroll 1
  for (int v = ct; v < 64 * NC * (kBN / 8); v += kCT) {
    const int p = v / (kBN / 8), c = v % (kBN / 8);
    const int m = m0 + p, n = n0 + 8 * c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < a.N && n < a.C)
      val = *reinterpret_cast<const uint4*>(
          a.residual + static_cast<long long>(m) * a.C + n);
    *reinterpret_cast<uint4*>(stage + p * kBN * 2 + ((c ^ (p & 7)) << 4)) =
        val;
  }
  bar_sync(1, kCT);
  uint8_t* const st = stage + wg * 64 * kBN * 2;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * tq4;
    const float bv0 = n < a.C ? __bfloat162float(a.bias[n]) : 0.0f;
    const float bv1 = n + 1 < a.C ? __bfloat162float(a.bias[n + 1]) : 0.0f;
    uint32_t* const p0 = reinterpret_cast<uint32_t*>(
        st + r0 * kBN * 2 + ((i ^ g) << 4) + 4 * tq4);
    uint32_t* const p1 = reinterpret_cast<uint32_t*>(
        st + (r0 + 8) * kBN * 2 + ((i ^ g) << 4) + 4 * tq4);
    const uint32_t ra = *p0, rb = *p1;
    *p0 = pack_bf16(acc[4 * i] + bv0 + lo_bf16(ra),
                    acc[4 * i + 1] + bv1 + hi_bf16(ra));
    *p1 = pack_bf16(acc[4 * i + 2] + bv0 + lo_bf16(rb),
                    acc[4 * i + 3] + bv1 + hi_bf16(rb));
  }
  bar_sync(1, kCT);
#pragma unroll 1
  for (int v = ct; v < 64 * NC * (kBN / 8); v += kCT) {
    const int p = v / (kBN / 8), c = v % (kBN / 8);
    const int m = m0 + p, n = n0 + 8 * c;
    if (m < a.N && n < a.C)
      *reinterpret_cast<uint4*>(a.out + static_cast<long long>(m) * a.C +
                                n) =
          *reinterpret_cast<const uint4*>(stage + p * kBN * 2 +
                                          ((c ^ (p & 7)) << 4));
  }
}

struct FFPlan {
  int nc1, m1, i_tiles;                             // kGate
  int nc2, m2, n_tiles, chunks, splits, per_split;  // kDown
  long long h_floats, work_floats;
};

// kGate: two consumer warpgroups (128-token tiles) where that grid gives
// two CTAs to every SM (two fit one), else one (64); kDown: two where
// that grid fills the SMs once, else one, and then its steps split over
// as many CTAs as fill the SMs once, each split a run of whole steps. `nc` 1 or 2 and
// `splits` > 0 force the choices (mirrored by ops/ff_geglu.py
// ff_sm90_plan).
FFPlan plan(int N, int C, int inner, int nc, int splits) {
  FFPlan p{};
  auto m_tiles = [&](int c) { return (N + 64 * c - 1) / (64 * c); };
  p.i_tiles = (inner + kIT - 1) / kIT;
  p.n_tiles = (C + kBN - 1) / kBN;
  p.nc1 = nc ? nc : 1LL * m_tiles(2) * p.i_tiles >= 2 * kSMs ? 2 : 1;
  p.nc2 = nc ? nc : 1LL * m_tiles(2) * p.n_tiles >= kSMs ? 2 : 1;
  p.m1 = m_tiles(p.nc1);
  p.m2 = m_tiles(p.nc2);
  p.chunks = (inner + kAtom - 1) / kAtom;
  const long long tiles = 1LL * p.m2 * p.n_tiles;
  long long s = splits > 0 ? splits : tiles >= kSMs ? 1 : kSMs / tiles;
  if (s > p.chunks) s = p.chunks;
  p.per_split = static_cast<int>((p.chunks + s - 1) / s);
  p.splits = (p.chunks + p.per_split - 1) / p.per_split;
  // h in bf16, whole 16 bytes; the split tiles; the counters
  p.h_floats = (1LL * N * inner + 7) / 8 * 4;
  p.work_floats =
      p.h_floats +
      (p.splits > 1 ? tiles * p.splits * 64 * p.nc2 * kBN + tiles : 0);
  return p;
}

template <int MODE, int NC>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const FFArgs& a, dim3 grid, cudaStream_t stream) {
  auto kern = ff_gemm_sm90<MODE, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_for(NC));
  if (err != cudaSuccess) return err;
  kern<<<grid, 128 * NC + 32, smem_for(NC), stream>>>(ta, tb, a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_nc(int nc, const CUtensorMap& ta, const CUtensorMap& tb,
                      const FFArgs& a, dim3 grid, cudaStream_t stream) {
  return nc == 2 ? launch<MODE, 2>(ta, tb, a, grid, stream)
                 : launch<MODE, 1>(ta, tb, a, grid, stream);
}

// A 2-D bf16 (rows, cols) row-major matrix as a tensor map of boxes of
// 64 columns (128 bytes, swizzled) by `box_rows` rows.
bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t bytes = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[3] = {bytes, bytes * rows, bytes * rows};
  const cuuint32_t box[4] = {kAtom, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, base, dims, strides, box, unit);
}

}  // namespace
}  // namespace dtp

// The plan of a call into out[11]: {kGate's consumer warpgroups, M tiles
// and inner tiles; kDown's consumer warpgroups, M tiles, N tiles, K
// steps, splits, steps a split; h's floats; the work buffer's floats}
// (ops/ff_geglu.py ff_sm90_plan mirrors it); `nc` and `splits` as for the
// entry.
extern "C" int dtp_ff_geglu_sm90_plan(int N, int C, int inner, int nc,
                                      int splits, long long* out) {
  if (N <= 0 || C <= 0 || inner <= 0 || nc < 0 || nc > 2 || splits < 0)
    return -1;
  const dtp::FFPlan p = dtp::plan(N, C, inner, nc, splits);
  const long long v[11] = {p.nc1,    p.m1,     p.i_tiles,   p.nc2,
                           p.m2,     p.n_tiles, p.chunks,   p.splits,
                           p.per_split, p.h_floats, p.work_floats};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// K3 in bf16: x (N,C), w0 (2*inner,C), b0 (2*inner,), w2 (C,inner), b2
// (C,), residual (N,C), out (N,C). C and inner multiples of 8; x, w0, w2,
// residual and out 16-byte aligned (TMA's 16-byte strides, the epilogue's
// 16-byte rows). `work`: the plan's work floats (h first, 16-byte
// aligned). `nc` 0 for the plan's tiles, 1 or 2 to force the consumer
// warpgroups of both GEMMs; `splits` 0 for the plan's split of the second
// GEMM's K, > 0 to force one (probes).
extern "C" cudaError_t dtp_ff_geglu_sm90(const void* x, const void* w0,
                                         const void* b0, const void* w2,
                                         const void* b2,
                                         const void* residual, void* out,
                                         void* work, int N, int C, int inner,
                                         int nc, int splits, void* stream) {
  using namespace dtp;
  if (N <= 0 || C <= 0 || inner <= 0 || C % 8 || inner % 8 || nc < 0 ||
      nc > 2 || splits < 0 || work == nullptr || !aligned16(x) ||
      !aligned16(w0) || !aligned16(w2) || !aligned16(residual) ||
      !aligned16(out) || !aligned16(work))
    return cudaErrorInvalidValue;
  const FFPlan p = plan(N, C, inner, nc, splits);
  if (p.m1 > 65535 || p.m2 > 65535) return cudaErrorInvalidValue;
  bf16* const h = static_cast<bf16*>(work);
  float* const wf = static_cast<float*>(work);
  CUtensorMap tx, tw0, th, tw2;
  if (!matrix_map(&tx, x, N, C, 64 * p.nc1) ||
      !matrix_map(&tw0, w0, 2 * inner, C, kIT) ||
      !matrix_map(&th, h, N, inner, 64 * p.nc2) ||
      !matrix_map(&tw2, w2, C, inner, kBN))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FFArgs g{};
  g.bias = static_cast<const bf16*>(b0);
  g.out = h;
  g.N = N, g.C = C, g.inner = inner;
  g.chunks = (C + kAtom - 1) / kAtom;
  g.per_split = g.chunks, g.splits = 1;
  cudaError_t err = launch_nc<kGate>(
      p.nc1, tx, tw0, g, dim3(p.i_tiles, p.m1, 1), s);
  if (err != cudaSuccess) return err;
  FFArgs d{};
  d.bias = static_cast<const bf16*>(b2);
  d.residual = static_cast<const bf16*>(residual);
  d.out = static_cast<bf16*>(out);
  d.N = N, d.C = C, d.inner = inner;
  d.chunks = p.chunks, d.per_split = p.per_split, d.splits = p.splits;
  if (p.splits > 1) {
    const long long tiles = 1LL * p.m2 * p.n_tiles;
    d.ws = wf + p.h_floats;
    d.counters =
        reinterpret_cast<int*>(d.ws + tiles * p.splits * 64 * p.nc2 * kBN);
    err = cudaMemsetAsync(d.counters, 0, sizeof(int) * tiles, s);
    if (err != cudaSuccess) return err;
  }
  return launch_nc<kDown>(p.nc2, th, tw2, d,
                          dim3(p.n_tiles, p.m2, p.splits), s);
}
