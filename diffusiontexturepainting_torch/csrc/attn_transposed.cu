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
//       _pv_kernel (pallas_call :66) in fp32: the P V product alone,
//       `iters` times: out = sum_{i < iters} e v with each pass's product
//       accumulated from zero and the passes summed, as e v or as
//       (v^T e^T)^T. e (bh, bq, Lk), v (bh, Lk, hd), out (bh, bq, hd). bf16
//       T10 runs csrc/pv_product_sm90.cu (a split wgmma/TMA GEMM whose
//       operands stay in shared memory for all passes); this entry
//       refuses bf16.
//
// T1, bf16: a block is 4 warps and 64 queries, a warp 16 queries: the N
// axis (two n8 tiles) of both products. K rows are the A operand of
// S^T = K Q^T (ldmatrix of the K tile), the warp's pre-scaled Q rows its B
// fragments, kept in registers. A thread then holds S^T at keys g, g+8 and
// queries 2t, 2t+1 of each 16 x 8 tile, so the maximum and the sum over the
// keys reduce over the tiles in the thread and over the eight g lanes
// (shuffles 4, 8, 16), once per pass. Two passes over K, as K13's kernel
// (flash_attention_sm90.cu) takes them: the first for the exact max (K alone staged),
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
// T10, fp32: one thread an output element (the orientation picks which
// index runs fastest across threads).
//
// What bounds T1 on the H100: the tensor cores (4*Lq*Lk*hd flops a head).
// mma.sync reaches a fraction of the wgmma rate; the arm measures the
// orientation of the products, not the product rate.
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

constexpr int kPvF32Threads = 256;

struct PvArgs {
  const void* e;
  const void* v;
  void* out;
  int bh, bq, Lk, hd, iters;
};

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

template <bool TRANSPOSED>
cudaError_t launch_pv_f32(const PvArgs& a, cudaStream_t s) {
  const long long blocks =
      ((long long)a.bh * a.bq * a.hd + kPvF32Threads - 1) / kPvF32Threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pv_kernel_f32<TRANSPOSED><<<(unsigned)blocks, kPvF32Threads, 0, s>>>(a);
  return cudaGetLastError();
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

// T10 in fp32: e (bh,bq,Lk), v (bh,Lk,hd), out (bh,bq,hd), contiguous;
// hd <= 160; iters >= 1 passes, each the whole product, summed in fp32;
// transposed: computed as (v^T e^T)^T. is_bf16 must be 0: bf16 T10 is
// dtp_pv_product_sm90 (csrc/pv_product_sm90.cu).
extern "C" cudaError_t dtp_pv_product(const void* e, const void* v, void* out,
                                      int bh, int bq, int Lk, int hd,
                                      int iters, int transposed, int is_bf16,
                                      void* stream) {
  if (is_bf16 || bh <= 0 || bq <= 0 || Lk <= 0 || hd <= 0 ||
      hd > dtp::kMaxHd || iters <= 0)
    return cudaErrorInvalidValue;
  dtp::PvArgs a{};
  a.e = e, a.v = v, a.out = out;
  a.bh = bh, a.bq = bq, a.Lk = Lk, a.hd = hd, a.iters = iters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transposed) return dtp::launch_pv_f32<true>(a, s);
  return dtp::launch_pv_f32<false>(a, s);
}
