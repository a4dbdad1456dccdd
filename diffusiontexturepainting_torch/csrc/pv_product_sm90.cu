// T10 in bf16 for Hopper (sm_90a): the P V product, `iters` passes, as a
// split wgmma GEMM whose operands TMA brings into shared memory once.
//
//   dtp_pv_product_sm90  T10 <- tools/bench_pv_transpose.py bench_shape /
//       _pv_kernel (pallas_call :66): out = round_bf16(sum_{i < iters} e v)
//       with each pass's product accumulated in fp32 and the passes summed
//       in fp32, as e v or as (v^T e^T)^T. e (bh, bq, Lk), v (bh, Lk, hd),
//       out (bh, bq, hd). The tool's perturbation of v per pass, (1 +
//       i*1e-9) rounded to v's type, is exactly 1 in bf16 and is not part
//       of the function. Every pass is issued: the tool times the product
//       in each orientation, so the kernel neither hoists it out of the
//       loop nor multiplies by iters. fp32 stays on attn_transposed.cu's
//       FMA twin (dispatch by dtype in ops/attention_variants.py
//       pv_product).
//
// What bounds it on the H100: 2*bq*Lk*hd*iters operations on the tensor
// cores against bq*Lk + Lk*hd + bq*hd elements moved once. On the TPU e
// stays in VMEM for all passes (4 MB at the tool's largest shape); an SM
// holds 227 KB, so here the work is cut until each piece's operands fit
// and stay.
//
// Design. A CTA owns one 64-row query tile x one key chunk of KC keys (64,
// 128 or 256) x two groups of passes, one a consumer warpgroup:
//   - one thread issues TMA loads of the e block (64 x KC, in 64-key
//     boxes) and the v block (KC x hd, in 64-column boxes) into shared
//     memory, 128-byte swizzle, once; rows past bq, keys past Lk and v's
//     columns past hd arrive as zeros. Both warpgroups then run all their
//     passes from those tiles: nothing is read from L2 a pass.
//   - e v: wgmma m64nNk16, N = hd rounded up into {40, 80, 160} (every one
//     a valid wgmma N), A = the e block (K-major), B = the v block
//     (MN-major through the transpose bit).
//   - (v^T e^T)^T: M = hd in m64 tiles (40 -> 64, 80 -> 128, 160 -> 192),
//     A = v^T, MN-major from the same v block through the transpose bit,
//     B = e^T, K-major straight from e's rows, N = the 64 queries; the
//     store transposes back. Both orientations are real wgmma layouts.
//   - A pass issues only the k16 steps that hold real keys; its first
//     wgmma starts from zero (scale-d 0), so no instruction but wgmma
//     defines the accumulator (zeroed accumulators made ptxas serialise
//     wgmma), and the pass is added to the warpgroup's fp32 total.
//   - The CTA's partial, warpgroup 0's total + warpgroup 1's, fp32 in the
//     accumulator layout, goes to one work buffer; the last CTA of a query
//     tile (an integer counter per tile, reset in the call) adds all of
//     the tile's partials in a fixed order, key chunk then CTA group, with
//     many loads in flight, and rounds once: no float atomics, a replay is
//     bit-identical.
// The plan (plan, mirrored by ops/attention_variants.py pv_sm90_plan)
// halves the key chunk from 256 while the grid stays within one wave of the
// 132 SMs, then splits the passes over as many CTAs as fill it: at the
// tool's bh 1, (512, 4096, 40) runs 8 tiles x 16 chunks of 256 keys, (512,
// 1024, 80) 8 x 16 chunks of 64, (256, 256, 160) 4 tiles x 4 chunks of 64 x
// 8 pass splits, 128 CTAs each, against bq / 64 blocks before.
#include <algorithm>

#include "sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kAtom = 64;       // bf16 columns of one 128-byte swizzle atom
constexpr int kRows = 64;       // query rows of a tile
constexpr int kMaxChunk = 256;  // keys of a chunk: TMA's box rows at most
constexpr int kMinChunk = 64;
constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kMaxHd = 160;
constexpr int kSMs = 132;       // H100 SXM

// D (64 x 40, fp32) (+)= A (smem, K-major) * B (smem, MN-major)
__device__ __forceinline__ void mma_ev40(float (&d)[20], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 80, fp32) (+)= A (smem, K-major) * B (smem, MN-major)
__device__ __forceinline__ void mma_ev80(float (&d)[40], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 160, fp32) (+)= A (smem, K-major) * B (smem, MN-major)
__device__ __forceinline__ void mma_ev160(float (&d)[80], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) (+)= A (smem, MN-major) * B (smem, K-major)
__device__ __forceinline__ void mma_vt(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct PvArgs {
  bf16* out;
  float* ws;      // partials: (tile, chunk, CTA group) x 128 x kAcc
  int* counters;  // one per query tile
  int bq, Lk, hd, iters;
  int n_q, chunk, nk, gc;  // query tiles an image, keys a chunk, chunks,
                           // CTAs a (tile, chunk)
};

// e v: N = hd rounded up into {40, 80, 160}; (v^T e^T)^T: m64 tiles of hd
__host__ __device__ constexpr int n_bucket(int hd) {
  return hd <= 40 ? 40 : hd <= 80 ? 80 : 160;
}
// NB: N (e v) or the m64 tiles (transposed). The accumulator is kTiles x
// kPer floats a thread (one m64 tile's registers a row); the v block is
// kVAtoms 64-column atoms.
template <bool TRANSPOSED, int NB>
struct Tile {
  static constexpr int kTiles = TRANSPOSED ? NB : 1;
  static constexpr int kPer = TRANSPOSED ? 32 : NB / 2;
  static constexpr int kAcc = kTiles * kPer;
  static constexpr int kVAtoms = TRANSPOSED ? NB : (NB + kAtom - 1) / kAtom;
};

template <bool TRANSPOSED, int NB>
__global__ void __launch_bounds__(kThreads, 1)
pv_sm90(const __grid_constant__ CUtensorMap te,
        const __grid_constant__ CUtensorMap tv, const PvArgs a) {
  using T = Tile<TRANSPOSED, NB>;
  constexpr int kAcc = T::kAcc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t vbytes = a.chunk * 128;  // one 64-column atom of v
  const uint32_t sE = base, sV = base + vbytes;
  const uint32_t bar_off = vbytes * (1 + T::kVAtoms);
  const uint32_t bar = base + bar_off;
  int* const flag = reinterpret_cast<int*>(gbase + bar_off + 8);

  const int cg = blockIdx.x % a.gc;
  const int c = (blockIdx.x / a.gc) % a.nk;
  const long long tile = blockIdx.x / (a.gc * a.nk);
  const int b = static_cast<int>(tile / a.n_q);
  const int q0 = static_cast<int>(tile % a.n_q) * kRows;
  const int k0 = c * a.chunk;
  const int keys = min(a.chunk, a.Lk - k0);
  const int steps = (keys + 15) / 16;  // k16 steps that hold real keys

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int e_atoms = (keys + kAtom - 1) / kAtom;
    const int v_atoms = (a.hd + kAtom - 1) / kAtom;
    mbar_expect_tx(bar, e_atoms * kRows * 128 + v_atoms * vbytes);
#pragma unroll 1
    for (int i = 0; i < e_atoms; ++i)
      tma_load(sE + i * kRows * 128, &te, bar, k0 + i * kAtom, q0, b, 0);
#pragma unroll 1
    for (int i = 0; i < v_atoms; ++i)
      tma_load(sV + i * vbytes, &tv, bar, i * kAtom, k0, b, 0);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int groups = 2 * a.gc;
  const int group = 2 * cg + wg;
  const int passes = a.iters / groups + (group < a.iters % groups);
  // v atoms past hd are never loaded: they reach only output columns (e v)
  // or rows (transposed) past hd, which are never stored
  mbar_wait(bar, 0);

  float acc[T::kTiles][T::kPer], tot[T::kTiles][T::kPer];
#pragma unroll
  for (int m = 0; m < T::kTiles; ++m)
#pragma unroll
    for (int i = 0; i < T::kPer; ++i) tot[m][i] = 0.0f;
#pragma unroll 1
  for (int p = 0; p < passes; ++p) {
    wg_fence();
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      // the e block's k16 step s: its 64-key atom, 32 bytes a step within
      const uint64_t de =
          desc128(sE + (s / 4) * kRows * 128 + (s % 4) * 32, 16);
      if constexpr (TRANSPOSED) {
#pragma unroll
        for (int m = 0; m < NB; ++m)
          mma_vt(acc[m], desc128(sV + m * vbytes + s * 16 * 128, vbytes), de,
                 s);
      } else {
        const uint64_t dv = desc128(sV + s * 16 * 128, vbytes);
        if constexpr (NB == 40)
          mma_ev40(acc[0], de, dv, s);
        else if constexpr (NB == 80)
          mma_ev80(acc[0], de, dv, s);
        else
          mma_ev160(acc[0], de, dv, s);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int m = 0; m < T::kTiles; ++m) {
      fence_regs(acc[m]);
#pragma unroll
      for (int i = 0; i < T::kPer; ++i) tot[m][i] += acc[m][i];
    }
  }

  // ---- the CTA's partial, wg 0's total + wg 1's, into the work buffer;
  // the tile's last CTA adds every partial in order (key chunk, then CTA
  // group) ----
  float2* const mine = reinterpret_cast<float2*>(
      a.ws + ((tile * a.nk + c) * a.gc + cg) * 128 * kAcc);
  if (wg == 0) {
#pragma unroll
    for (int m = 0; m < T::kTiles; ++m)
#pragma unroll
      for (int i = 0; i < T::kPer / 2; ++i)
        __stcg(mine + (m * T::kPer / 2 + i) * 128 + t,
               make_float2(tot[m][2 * i], tot[m][2 * i + 1]));
  }
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int m = 0; m < T::kTiles; ++m)
#pragma unroll
      for (int i = 0; i < T::kPer / 2; ++i) {
        float2* const dst = mine + (m * T::kPer / 2 + i) * 128 + t;
        const float2 f = __ldcg(dst);
        __stcg(dst, make_float2(f.x + tot[m][2 * i], f.y + tot[m][2 * i + 1]));
      }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(a.counters + tile, 1);
  __syncthreads();
  if (*flag != a.nk * a.gc - 1) return;
  __threadfence();

  // each thread: kHalf accumulator pairs of layout thread t (warpgroup wg
  // takes the pairs [wg * kHalf, (wg + 1) * kHalf)), the partials read
  // kBatch at a time so that many loads are in flight, added in order
  constexpr int kHalf = kAcc / 4;
  constexpr int kBatch = kHalf >= 48 ? 1 : 48 / kHalf;
  const float2* const parts =
      reinterpret_cast<const float2*>(a.ws + tile * a.nk * a.gc * 128 *
                                                 kAcc) +
      wg * kHalf * 128 + t;
  const int nparts = a.nk * a.gc;
  float2 sum[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) sum[j] = make_float2(0.0f, 0.0f);
#pragma unroll 1
  for (int k0 = 0; k0 < nparts; k0 += kBatch) {
    float2 v[kBatch][kHalf];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
        v[u][j] = k0 + u < nparts
                      ? __ldcg(parts + ((k0 + u) * kAcc / 2 + j) * 128)
                      : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        sum[j].x += v[u][j].x;
        sum[j].y += v[u][j].y;
      }
  }

  // pair wg * kHalf + j: accumulators 2p, 2p + 1 of m64 tile p / 16
  // (transposed) or n8 tile p / 2 (e v), row r0 or r0 + 8 of the tile
  const int warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  bf16* const ob = a.out + static_cast<long long>(b) * a.bq * a.hd;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int pr = wg * kHalf + j;
    const int pp = TRANSPOSED ? pr % 16 : pr;
    const int row = r0 + 8 * (pp % 2), col = 8 * (pp / 2) + c2;
    const float x = sum[j].x, y = sum[j].y;
    if constexpr (TRANSPOSED) {
      const int h = 64 * (pr / 16) + row, q = q0 + col;
      if (h < a.hd) {
        if (q < a.bq)
          ob[static_cast<long long>(q) * a.hd + h] = __float2bfloat16(x);
        if (q + 1 < a.bq)
          ob[static_cast<long long>(q + 1) * a.hd + h] = __float2bfloat16(y);
      }
    } else if (q0 + row < a.bq && col < a.hd) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(q0 + row) * a.hd + col) =
          __floats2bfloat162_rn(x, y);
    }
  }
}

struct PvPlan {
  int n_q, chunk, nk, gc, groups, nb, acc, smem;
  long long tiles, ctas, ws_floats, work_floats;
};

// The split of a call (mirrored by ops/attention_variants.py
// pv_sm90_plan): the key chunk halves from kMaxChunk while the grid of
// (query tile, chunk) CTAs stays within one wave of the SMs; then the
// passes split over as many CTAs as fill the wave, two pass groups a CTA
// (one a warpgroup), at most one pass a group. `chunk` > 0 and `gc` > 0
// force the choices (probes).
PvPlan plan(int bh, int bq, int Lk, int hd, int iters, bool transposed,
            int chunk, int gc) {
  PvPlan p{};
  p.n_q = (bq + kRows - 1) / kRows;
  p.tiles = 1LL * bh * p.n_q;
  auto chunks = [&](int c) { return (Lk + c - 1) / c; };
  p.chunk = kMaxChunk;
  if (chunk > 0)
    p.chunk = chunk;
  else
    while (p.chunk > kMinChunk && p.tiles * chunks(p.chunk / 2) <= kSMs)
      p.chunk /= 2;
  p.nk = chunks(p.chunk);
  const long long fill = kSMs / (p.tiles * p.nk);
  p.gc = gc > 0 ? gc
                : static_cast<int>(
                      std::max(1LL, std::min<long long>((iters + 1) / 2,
                                                        fill)));
  p.groups = 2 * p.gc;
  p.nb = transposed ? (hd + kAtom - 1) / kAtom : n_bucket(hd);
  p.acc = transposed ? 32 * p.nb : p.nb / 2;
  const int v_atoms = transposed ? p.nb : (p.nb + kAtom - 1) / kAtom;
  p.smem = p.chunk * 128 * (1 + v_atoms) + 16 + 1024;
  p.ctas = p.tiles * p.nk * p.gc;
  p.ws_floats = p.tiles * p.nk * p.gc * 128 * p.acc;
  p.work_floats = p.ws_floats + p.tiles;  // then one int counter a tile
  return p;
}

template <bool TRANSPOSED, int NB>
cudaError_t launch(const CUtensorMap& te, const CUtensorMap& tv,
                   const PvArgs& a, const PvPlan& p, cudaStream_t stream) {
  auto kern = pv_sm90<TRANSPOSED, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(p.ctas), kThreads, p.smem, stream>>>(te, tv,
                                                                    a);
  return cudaGetLastError();
}

// A (rows, cols) row-major bf16 matrix of each of `images` images as a
// tensor map of boxes of 64 columns (128 bytes, swizzled) by `box_rows`.
bool matrix_map(CUtensorMap* map, const void* base, int images, int rows,
                int cols, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(images), 1};
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * images};
  const cuuint32_t box[4] = {kAtom, static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, base, dims, strides, box, unit);
}

bool bad(int bh, int bq, int Lk, int hd, int iters, int chunk, int gc) {
  return bh <= 0 || bq <= 0 || Lk <= 0 || hd <= 0 || hd > kMaxHd ||
         hd % 8 || Lk % 8 || iters <= 0 || gc < 0 ||
         (chunk != 0 && chunk != 64 && chunk != 128 && chunk != 256);
}

}  // namespace
}  // namespace dtp

// The plan of a call into out[12]: {query tiles an image, keys a chunk,
// chunks, CTAs a (tile, chunk), pass groups a (tile, chunk), N (e v) or
// m64 tiles (transposed), accumulator floats a thread, dynamic shared
// memory bytes, query tiles, CTAs, partial floats, work floats}
// (ops/attention_variants.py pv_sm90_plan mirrors it); `chunk` and `gc`
// as for the entry.
extern "C" int dtp_pv_product_sm90_plan(int bh, int bq, int Lk, int hd,
                                        int iters, int transposed, int chunk,
                                        int gc, long long* out) {
  if (dtp::bad(bh, bq, Lk, hd, iters, chunk, gc)) return -1;
  const dtp::PvPlan p =
      dtp::plan(bh, bq, Lk, hd, iters, transposed != 0, chunk, gc);
  const long long v[12] = {p.n_q,   p.chunk, p.nk,    p.gc,
                           p.groups, p.nb,   p.acc,   p.smem,
                           p.tiles, p.ctas,  p.ws_floats, p.work_floats};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// T10 in bf16: e (bh,bq,Lk), v (bh,Lk,hd), out (bh,bq,hd), contiguous and
// 16-byte aligned; hd <= 160; hd and Lk multiples of 8 (TMA's 16-byte
// rows); iters >= 1 passes, each the whole product, summed in fp32;
// transposed: computed as (v^T e^T)^T. `work`: `work_floats` floats,
// 16-byte aligned, at least the plan's work floats (else
// cudaErrorInvalidValue). `chunk` 0 (the plan's) or 64, 128, 256 keys; `gc`
// 0 (the plan's) or the CTAs a (tile, chunk) (probes).
extern "C" cudaError_t dtp_pv_product_sm90(const void* e, const void* v,
                                           void* out, void* work,
                                           long long work_floats, int bh,
                                           int bq, int Lk, int hd, int iters,
                                           int transposed, int chunk, int gc,
                                           void* stream) {
  using namespace dtp;
  if (bad(bh, bq, Lk, hd, iters, chunk, gc) || work == nullptr ||
      !aligned16(e) || !aligned16(v) || !aligned16(out) || !aligned16(work))
    return cudaErrorInvalidValue;
  const PvPlan p = plan(bh, bq, Lk, hd, iters, transposed != 0, chunk, gc);
  if (work_floats < p.work_floats) return cudaErrorInvalidValue;
  if (p.ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  CUtensorMap te, tv;
  if (!matrix_map(&te, e, bh, bq, Lk, kRows) ||
      !matrix_map(&tv, v, bh, Lk, hd, p.chunk))
    return cudaErrorInvalidValue;
  PvArgs a{};
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(work);
  a.counters = reinterpret_cast<int*>(a.ws + p.ws_floats);
  a.bq = bq, a.Lk = Lk, a.hd = hd, a.iters = iters;
  a.n_q = p.n_q, a.chunk = p.chunk, a.nk = p.nk, a.gc = p.gc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.counters, 0, sizeof(int) * p.tiles, s);
  if (err != cudaSuccess) return err;
  if (transposed) {
    switch (p.nb) {
      case 1: return launch<true, 1>(te, tv, a, p, s);
      case 2: return launch<true, 2>(te, tv, a, p, s);
      default: return launch<true, 3>(te, tv, a, p, s);
    }
  }
  switch (p.nb) {
    case 40: return launch<false, 40>(te, tv, a, p, s);
    case 80: return launch<false, 80>(te, tv, a, p, s);
    default: return launch<false, 160>(te, tv, a, p, s);
  }
}
