// The transposed-product arms of the attention kernels: the last two A/B
// variants of the attention tools, both asking what it costs to put the
// head dim on the M axis of the tensor-core products instead of the N axis.
//
//   dtp_sublane_attention  T1 <- tools/bench_attn_sublane.py
//       sublane_attention / _sublane_kernel (pallas_call :84): the exact
//       row-max softmax with BOTH products transposed. q is multiplied by
//       scale*log2(e) and rounded to its type; S^T = K Q^T (keys x
//       queries); m and the sum over the keys; e = exp2(S^T - m) in fp32,
//       rounded to v's type for O^T = V^T E^T; then O^T / sum, transposed
//       back on the store. (B, L, H*hd) tensors read and written in place,
//       hd <= 160, every query length computed (the TPU wrapper pads Lq to
//       its block and returns the padded rows).
//   dtp_pv_product         T10 <- tools/bench_pv_transpose.py bench_shape /
//       _pv_kernel (pallas_call :66): the P V product alone, `iters` times:
//       out = T(sum_{i < iters} e v) with each pass's product accumulated in
//       fp32 from zero and the passes summed in fp32, as e v or as
//       (v^T e^T)^T. e (bh, bq, Lk), v (bh, Lk, hd), out (bh, bq, hd). The
//       tool's perturbation of v per pass, (1 + i*1e-9) rounded to v's
//       type, is exactly 1 in bf16 and is not part of the function here.
//
// T1, bf16: a block is 4 warps and 64 queries, a warp 16 queries: the N
// axis (two n8 tiles) of both products. K rows are the A operand of
// S^T = K Q^T (ldmatrix of the K tile), the warp's pre-scaled Q rows its B
// fragments, kept in registers. A thread then holds S^T at keys g, g+8 and
// queries 2t, 2t+1 of each 16 x 8 tile, so the maximum and the sum over the
// keys reduce over the tiles in the thread and over the eight g lanes
// (shuffles 4, 8, 16), once per pass. Two passes over K, as kRowmax of
// attn_arms.cuh takes them: the first for the exact max (K alone staged),
// the second recomputes S^T bit for bit and takes exp2(S^T - m), so e is
// rounded once against the final max, as the TPU kernel rounds it. The C
// fragment of S^T is not the B fragment of V^T E^T (which wants key pairs
// 2t, 2t+1 in a thread and the query on g): each 8 x 8 block of bf16 e is
// transposed across the warp by movmatrix. V^T is the A operand
// (ldmatrix.trans of the V tile, hd padded to m16 tiles: 40 -> 48). O^T
// lives in registers; its columns' sums are already in the threads that
// hold them. K/V tiles of 64 keys are staged by cp.async, double-buffered.
// fp32 inputs run attn_arms.cuh's FMA twin of the row-max softmax (one
// thread a query row: a transposed product is a tensor-core notion).
//
// T10, bf16: a block is 4 warps and a 64-row slab of bq for one bh. On the
// TPU e is VMEM-resident for all passes (4 MB at the tool's largest
// shape); here it does not fit 227 KB of shared memory, so the 64 x 64 e
// tile and the 64 x hd v tile of every step stream through two cp.async
// stages on EVERY pass, from L2 after the first: the time measures the
// product fed from L2, not from a resident operand. (A third stage, tried on
// the card, changed the time of a step by under 1%: the copy is not what a
// step waits for.) Re-staging each pass
// is also what keeps the passes from being hoisted. As e v: A = e rows, B
// = v by ldmatrix.trans over n8 tiles of hd itself (40 = 5 x 8). As
// (v^T e^T)^T: A = v^T over m16 tiles (40 pads to 48), B = e^T straight
// from the e rows, the result transposed on the store. Each pass
// accumulates from zero and is added to the running fp32 sum, as the TPU
// loop's acc + o. The fp32 twin is one thread an output element (the
// orientation picks which index runs fastest across threads).
//
// What bounds them on the H100: the tensor cores (T1 4*Lq*Lk*hd flops a
// head; T10 2*bq*Lk*hd a pass against bq*Lk + Lk*hd + bq*hd elements moved
// once). mma.sync reaches a fraction of the wgmma rate; the arms measure
// the orientation of the products, not the product rate. With the tool's
// bh = 1, T10 runs bq/64 blocks on 132 SMs: the caller chooses bh.
#include "attn_arms.cuh"

namespace dtp {
namespace {

// Transposes an 8 x 8 matrix of b16 held across the warp in ldmatrix's
// fragment layout (lane 4g + t holds row g, columns 2t and 2t + 1).
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// S^T (BK keys x 16 queries per warp) = K Q^T: ST[mi][nt] is the C fragment
// of keys mi*16.. and the warp's queries nt*8...
template <int NK, int BK, int LD>
__device__ __forceinline__ void scores_t(float (*ST)[2][4],
                                         const uint32_t (*qb)[4],
                                         const bf16* Kt, int nk16, int lane) {
  const int mat = lane >> 3;
#pragma unroll
  for (int mi = 0; mi < BK / 16; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ST[mi][nt][e] = 0.0f;
    const bf16* row =
        Kt + (mi * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk < nk16) {
        uint32_t ka[4];
        ldsm_x4(ka[0], ka[1], ka[2], ka[3], row + kk * 16);
        mma(ST[mi][0], ka, qb[kk][0], qb[kk][1]);
        mma(ST[mi][1], ka, qb[kk][2], qb[kk][3]);
      }
    }
  }
}

template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads)
sublane_kernel(const ArmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HDP + 8;
  constexpr int NK = HDP / 16;  // k16 steps of S^T, m16 tiles of O^T
  constexpr int MI = BK / 16;   // m16 tiles of a K/V tile's keys
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * LD;   // two stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;  // two stages of BK x LD

  long long b, h;
  int q0;
  block_work<kHeadMajor>(a, kRows, &b, &h, &q0);
  const long long D = (long long)a.H * a.hd;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.Lq * D + h * a.hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.Lk * D + h * a.hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.Lk * D + h * a.hd;
  bf16* ob = static_cast<bf16*>(a.out) + b * a.Lq * D + h * a.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int w16 = warp * 16;
  const int hd = a.hd, Lk = a.Lk;
  const int nk16 = (hd + 15) >> 4;
  const int ntiles = (Lk + BK - 1) / BK;

  stage_q<HDP, LD>(Qs, qg, D, q0, a);
  stage_rows<HDP, LD>(Ks, kb, D, 0, BK, Lk, hd, a.vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Q^T's B fragments of the warp's 16 queries: [kk] = (b0, b1) of queries
  // 0-7, (b0, b1) of queries 8-15
  uint32_t qb[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    if (kk < nk16)
      ldsm_x4(qb[kk][0], qb[kk][1], qb[kk][2], qb[kk][3],
              Qs + (w16 + (mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8 +
                  kk * 16);

  // element e of ST[mi][nt]: key kv0 + mi*16 + g + 8*(e>>1), query
  // nt*8 + 2t + (e&1); a thread's four query columns are (nt, e&1)
  float ST[MI][2][4];
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};

  // pass 1: the exact max over the keys; K_{j+1} copies while S^T_j runs
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    const int kv0 = j * BK;
    if (j + 1 < ntiles)
      stage_rows<HDP, LD>(Ks + ((j + 1) & 1) * BK * LD, kb, D, kv0 + BK, BK,
                          Lk, hd, a.vec);
    cp_async_commit();
    scores_t<NK, BK, LD>(ST, qb, Ks + (j & 1) * BK * LD, nk16, lane);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + mi * 16 + g + 8 * (e >> 1) < Lk)
            m[nt][e & 1] = fmaxf(m[nt][e & 1], ST[mi][nt][e]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[nt][c] = fmaxf(m[nt][c], __shfl_xor_sync(0xffffffffu, m[nt][c], 4));
      m[nt][c] = fmaxf(m[nt][c], __shfl_xor_sync(0xffffffffu, m[nt][c], 8));
      m[nt][c] = fmaxf(m[nt][c], __shfl_xor_sync(0xffffffffu, m[nt][c], 16));
    }
  __syncthreads();  // every warp is done with the last K tile
  stage_rows<HDP, LD>(Ks, kb, D, 0, BK, Lk, hd, a.vec);
  stage_rows<HDP, LD>(Vs, vb, D, 0, BK, Lk, hd, a.vec);
  cp_async_commit();

  // pass 2: e = exp2(S^T - m), its sum, O^T += V^T E^T.
  // element e of OT[2*mt + nt]: column mt*16 + g + 8*(e>>1) of the head,
  // query nt*8 + 2t + (e&1)
  float OT[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) OT[n][e] = 0.0f;
  float l[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    const int kv0 = j * BK;
    if (j + 1 < ntiles) {
      stage_rows<HDP, LD>(Ks + ((j + 1) & 1) * BK * LD, kb, D, kv0 + BK, BK,
                          Lk, hd, a.vec);
      stage_rows<HDP, LD>(Vs + ((j + 1) & 1) * BK * LD, vb, D, kv0 + BK, BK,
                          Lk, hd, a.vec);
    }
    cp_async_commit();
    scores_t<NK, BK, LD>(ST, qb, Ks + (j & 1) * BK * LD, nk16, lane);
    const bf16* Vt = Vs + (j & 1) * BK * LD;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      // E^T's B fragments of this k16 slice of keys: the bf16 e of each
      // 8 x 8 block (keys g x queries 2t..) transposed to (keys 2t.. x
      // query g)
      uint32_t eb[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = 0.0f;
          if (kv0 + mi * 16 + g + 8 * (e >> 1) < Lk)
            p[e] = exp2f(ST[mi][nt][e] - m[nt][e & 1]);
          l[nt][e & 1] += p[e];
        }
        eb[nt][0] = movmatrix_t(pack_bf16(p[0], p[1]));
        eb[nt][1] = movmatrix_t(pack_bf16(p[2], p[3]));
      }
      const bf16* vrow =
          Vt + (mi * 16 + (mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < NK; ++mt) {
        if (mt < nk16) {
          uint32_t va[4];
          ldsm_x4_t(va[0], va[1], va[2], va[3], vrow + mt * 16);
          mma(OT[2 * mt], va, eb[0][0], eb[0][1]);
          mma(OT[2 * mt + 1], va, eb[1][0], eb[1][1]);
        }
      }
    }
  }

  // the sums over the g lanes: each thread then holds the sums of exactly
  // the query columns its O^T elements belong to
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 4);
      l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 8);
      l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], 16);
    }
  // O^T / l transposed back into the warp's own Q rows (no other warp
  // reads them; this warp's fragments are in registers), then row stores
  __syncwarp();
  bf16* stage = Qs + w16 * LD;
#pragma unroll
  for (int mt = 0; mt < NK; ++mt)
    if (mt < nk16)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stage[(nt * 8 + 2 * t + (e & 1)) * LD + mt * 16 + g +
                8 * (e >> 1)] =
              __float2bfloat16(OT[2 * mt + nt][e] / l[nt][e & 1]);
  __syncwarp();
  store_warp_rows<LD>(ob, stage, D, q0 + w16, a, lane);
}

template <int HDP>
cudaError_t launch_sublane(ArmArgs a, cudaStream_t s) {
  constexpr int BK = 64;
  constexpr size_t bytes = sizeof(bf16) * (HDP + 8) * (kRows + 4 * BK);
  auto kern = sublane_kernel<HDP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  long long blocks;
  if ((err = check_grid<kHeadMajor>(a, kRows, &blocks)) != cudaSuccess)
    return err;
  kern<<<(unsigned)blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// --- T10 ---

constexpr int kPvBK = 64;           // keys a step
constexpr int kPvLDE = kPvBK + 8;   // the e tile's row pitch
constexpr int kPvF32Threads = 256;

struct PvArgs {
  const void* e;
  const void* v;
  void* out;
  int bh, bq, Lk, hd, iters;
  bool vec_e, vec_v;  // 16-byte copies of e's and v's rows are aligned
};

// Columns [k0, k0 + 64) of rows [row0, row0 + 64) of the (bq, Lk) matrix e
// into a (64, kPvLDE) shared tile; rows >= bq and columns >= Lk are zero.
__device__ void stage_e(bf16* dst, const bf16* e, int row0, int k0, int bq,
                        int Lk, bool vec) {
  constexpr int CPR = kPvBK / 8;
  for (int c = threadIdx.x; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int gr = row0 + r, gc = k0 + col;
    bf16* d = dst + r * kPvLDE + col;
    if (vec) {
      const bool ok = gr < bq && gc < Lk;
      cp_async16(d, ok ? e + (long long)gr * Lk + gc : e, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = (gr < bq && gc + i < Lk) ? e[(long long)gr * Lk + gc + i]
                                        : __float2bfloat16(0.0f);
    }
  }
}

template <int HDP, bool TRANSPOSED>
__global__ void __launch_bounds__(kThreads)
pv_kernel(const PvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HDP + 8;
  constexpr int NO = HDP / 8;   // n8 tiles of e v, or 2 x m16 tiles of v^T e^T
  constexpr int NM = HDP / 16;
  bf16* Es = reinterpret_cast<bf16*>(smem);  // two stages of 64 x kPvLDE
  bf16* Vs = Es + 2 * kRows * kPvLDE;        // two stages of 64 x LD

  const int nq = (a.bq + kRows - 1) / kRows;
  const long long bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kRows;
  const bf16* eg = static_cast<const bf16*>(a.e) + bh * a.bq * a.Lk;
  const bf16* vg = static_cast<const bf16*>(a.v) + bh * a.Lk * a.hd;
  bf16* og = static_cast<bf16*>(a.out) + bh * a.bq * a.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int w16 = warp * 16;
  const int hd = a.hd, Lk = a.Lk;
  const int no8 = (hd + 7) >> 3, nm16 = (hd + 15) >> 4;
  const int ntiles = (Lk + kPvBK - 1) / kPvBK;
  const long long steps = (long long)a.iters * ntiles;

  float acc[NO][4], tot[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = tot[n][i] = 0.0f;

  stage_e(Es, eg, q0, 0, a.bq, Lk, a.vec_e);
  stage_rows<HDP, LD>(Vs, vg, hd, 0, kPvBK, Lk, hd, a.vec_v);
  cp_async_commit();
  int j = 0;  // the K tile of step s
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) {
      const int jn = j + 1 < ntiles ? j + 1 : 0;
      const int buf = (int)((s + 1) & 1);
      stage_e(Es + buf * kRows * kPvLDE, eg, q0, jn * kPvBK, a.bq, Lk,
              a.vec_e);
      stage_rows<HDP, LD>(Vs + buf * kPvBK * LD, vg, hd, jn * kPvBK, kPvBK,
                          Lk, hd, a.vec_v);
    }
    cp_async_commit();
    const bf16* Et = Es + (int)(s & 1) * kRows * kPvLDE;
    const bf16* Vt = Vs + (int)(s & 1) * kPvBK * LD;
#pragma unroll
    for (int kk = 0; kk < kPvBK / 16; ++kk) {
      if (TRANSPOSED) {
        // (hd x 16 queries per warp) += v^T e^T: A = v^T by ldmatrix.trans,
        // B = e^T, whose fragments are plain ldmatrix loads of the e rows
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                Et + (w16 + (mat >> 1) * 8 + (lane & 7)) * kPvLDE +
                    (mat & 1) * 8 + kk * 16);
        const bf16* vrow =
            Vt + (kk * 16 + (mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) {
          if (mt < nm16) {
            uint32_t va[4];
            ldsm_x4_t(va[0], va[1], va[2], va[3], vrow + mt * 16);
            mma(acc[2 * mt], va, b0, b1);
            mma(acc[2 * mt + 1], va, b2, b3);
          }
        }
      } else {
        // (16 queries per warp x hd) += e v over n8 tiles of hd itself
        uint32_t ea[4];
        ldsm_x4(ea[0], ea[1], ea[2], ea[3],
                Et + (w16 + (mat & 1) * 8 + (lane & 7)) * kPvLDE + kk * 16 +
                    (mat >> 1) * 8);
        const bf16* vrow =
            Vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          if (2 * np + 1 < no8) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(b0, b1, b2, b3, vrow + np * 16);
            mma(acc[2 * np], ea, b0, b1);
            mma(acc[2 * np + 1], ea, b2, b3);
          } else if (2 * np < no8) {
            // the odd last n8 tile (hd 40: columns 32-39)
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1,
                      Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               LD + np * 16);
            mma(acc[2 * np], ea, b0, b1);
          }
        }
      }
    }
    if (++j == ntiles) {
      // the pass's product is complete: add it to the running sum
      j = 0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[n][i] += acc[n][i];
          acc[n][i] = 0.0f;
        }
    }
  }

  if (TRANSPOSED) {
    // element i of tot[2*mt + nt]: column mt*16 + g + 8*(i>>1), query
    // nt*8 + 2t + (i&1): transposed back on the store
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = mt * 16 + g + 8 * (i >> 1);
          const int row = q0 + w16 + nt * 8 + 2 * t + (i & 1);
          if (row < a.bq && col < hd)
            og[(long long)row * hd + col] =
                __float2bfloat16(tot[2 * mt + nt][i]);
        }
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n * 8 + 2 * t + (i & 1);
        const int row = q0 + w16 + g + 8 * (i >> 1);
        if (row < a.bq && col < hd)
          og[(long long)row * hd + col] = __float2bfloat16(tot[n][i]);
      }
  }
}

// fp32 twin: one thread an output element; as e v the head column runs
// fastest across threads, as (v^T e^T)^T the query does. The compiler
// barrier makes every pass read its operands again.
template <bool TRANSPOSED>
__global__ void __launch_bounds__(kPvF32Threads)
pv_kernel_f32(const PvArgs a) {
  const long long per = (long long)a.bq * a.hd;
  const long long idx = (long long)blockIdx.x * kPvF32Threads + threadIdx.x;
  if (idx >= per * a.bh) return;
  const long long bh = idx / per;
  const int rem = (int)(idx - bh * per);
  const int q = TRANSPOSED ? rem % a.bq : rem / a.hd;
  const int c = TRANSPOSED ? rem / a.bq : rem % a.hd;
  const float* er =
      static_cast<const float*>(a.e) + (bh * a.bq + q) * (long long)a.Lk;
  const float* vc = static_cast<const float*>(a.v) + bh * a.Lk * a.hd + c;
  float tot = 0.0f;
  for (int it = 0; it < a.iters; ++it) {
    asm volatile("" ::: "memory");
    float acc = 0.0f;
    for (int k = 0; k < a.Lk; ++k)
      acc = fmaf(er[k], vc[(long long)k * a.hd], acc);
    tot += acc;
  }
  static_cast<float*>(a.out)[(bh * a.bq + q) * (long long)a.hd + c] = tot;
}

template <int HDP, bool TRANSPOSED>
cudaError_t launch_pv(PvArgs a, cudaStream_t s) {
  constexpr size_t bytes =
      sizeof(bf16) * 2 * (kRows * kPvLDE + kPvBK * (HDP + 8));
  auto kern = pv_kernel<HDP, TRANSPOSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.bh * ((a.bq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool TRANSPOSED>
cudaError_t dispatch_pv(PvArgs a, bool is_bf16, cudaStream_t s) {
  if (!is_bf16) {
    const long long blocks =
        ((long long)a.bh * a.bq * a.hd + kPvF32Threads - 1) / kPvF32Threads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    pv_kernel_f32<TRANSPOSED><<<(unsigned)blocks, kPvF32Threads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (a.hd <= 48) return launch_pv<48, TRANSPOSED>(a, s);
  if (a.hd <= 80) return launch_pv<80, TRANSPOSED>(a, s);
  return launch_pv<160, TRANSPOSED>(a, s);
}

}  // namespace
}  // namespace dtp

// T1: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd), contiguous, bf16
// (is_bf16) or fp32; hd <= 160; scale_log2 = scale * log2(e), applied to q
// (rounded to its type) before K Q^T.
extern "C" cudaError_t dtp_sublane_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int H, int Lq, int Lk, int hd,
                                             float scale_log2, int is_bf16,
                                             void* stream) {
  if (dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, 0.0f,
                          is_bf16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (hd <= 48)
      return dtp::launch_f32<48, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
    if (hd <= 80)
      return dtp::launch_f32<80, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
    return dtp::launch_f32<160, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
  }
  if (hd <= 48) return dtp::launch_sublane<48>(a, s);
  if (hd <= 80) return dtp::launch_sublane<80>(a, s);
  return dtp::launch_sublane<160>(a, s);
}

// T10: e (bh,bq,Lk), v (bh,Lk,hd), out (bh,bq,hd), contiguous, bf16
// (is_bf16) or fp32; hd <= 160; iters >= 1 passes, each the whole product,
// summed in fp32; transposed: computed as (v^T e^T)^T.
extern "C" cudaError_t dtp_pv_product(const void* e, const void* v, void* out,
                                      int bh, int bq, int Lk, int hd,
                                      int iters, int transposed, int is_bf16,
                                      void* stream) {
  if (bh <= 0 || bq <= 0 || Lk <= 0 || hd <= 0 || hd > dtp::kMaxHd ||
      iters <= 0)
    return cudaErrorInvalidValue;
  dtp::PvArgs a{};
  a.e = e, a.v = v, a.out = out;
  a.bh = bh, a.bq = bq, a.Lk = Lk, a.hd = hd, a.iters = iters;
  a.vec_e = is_bf16 && Lk % 8 == 0 && dtp::aligned16(e);
  a.vec_v = is_bf16 && hd % 8 == 0 && dtp::aligned16(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) return dtp::dispatch_pv<true>(a, is_bf16 != 0, s);
  return dtp::dispatch_pv<false>(a, is_bf16 != 0, s);
}
