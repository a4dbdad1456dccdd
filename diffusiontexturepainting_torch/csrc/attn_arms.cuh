// The register-resident body shared by the softmax arms (attn_arms.cu) and
// the layout arms (attn_layouts.cu): one templated kernel, FA2-style.
//
// Every arm pre-scales q by scale*log2(e) and rounds it to its type before
// Q K^T, so s is the fp32 base-2 logit. Layout: (B, L, H*hd) tensors read
// and written in place (heads hd lanes apart), 64-bit offsets, hd <= 160
// (the 16 x hd fp32 accumulator in a warp's registers).
//
// The softmax, a template parameter (ARM):
//   kNomax    exp2(s - shift) with a static shift and no max pass; `safe`
//             clamps s at shift + 88 and adds 1e-30 to the row sum;
//             `bf16_p` takes exp2 of bf16-rounded logits.
//   kChunked  online softmax, the running max updated once per K/V tile.
//   kUnpadded kNomax with `safe` and fp32 p fixed at compile time; P V
//             over n8 tiles of hd itself (hd 40 = 5 x 8) instead of hd
//             padded to 16.
//   kPvt      kUnpadded's softmax, P V computed transposed as
//             O^T = V^T P^T with p split into bf16 hi + lo.
//   kRowmax   the row-max softmax: two passes over K, the first for the
//             exact row max m, the second for exp2(s - m) (of bf16-rounded
//             s - m with `bf16_p`) and P V; the fp32 twin's only (T1 and
//             T4 in fp32; bf16 T4 runs flash_attention_sm90.cu).
//
// The block-to-work mapping, a template parameter (MAP):
//   kHeadMajor   one block per (batch, head, query tile), the query tiles
//                of a head consecutive: concurrent blocks share one head's
//                K/V in L2.
//   kHeadFastest one block per (batch, query tile, head), the head
//                fastest: the H blocks of a query tile run together and
//                share its q and output rows' cache lines and every head's
//                K/V rows in L2.
//   kAllHeads    one block per (batch, query tile), looping over the H
//                heads inside: Q is staged one head at a time (a 64-row
//                all-heads panel at D 1280 is 160 KB, beside two K/V stages
//                it would not fit in 227 KB), O lives in registers for one
//                head at a time, and each head's output columns are written
//                before the next head starts. The grid is H times smaller.
//
// bf16 kernel: a block is 4 warps, each warp 16 query rows. K/V tiles of BK
// keys are staged in shared memory by cp.async, double-buffered (the next
// tile's copy overlaps this tile's compute). Both products are mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix. The accumulator
// layout of m16n8k16 (a thread holds S[g][2t..2t+1] and S[g+8][2t..2t+1],
// g = lane/4, t = lane%4) is the A-operand layout of the next m16n8k16, so P
// goes from S's registers into P V without a trip through shared memory;
// for kPvt the same registers are P^T's B fragments. Row maxima and row
// sums reduce over the 4 threads of a quad (shuffles 1, 2). kChunked starts
// S_{j+1} = Q K_{j+1}^T before the softmax of S_j (K one tile ahead of V in
// the copy pipeline, two S register tiles) where hd <= 80; at hd 160 the
// second S tile would not fit beside O, so it runs serially. The output is
// staged through the warp's own Q rows in shared memory and stored with
// 16-byte writes.
//
// fp32 inputs run an FMA twin, one thread per query row (speed not
// measured: it exists for fp32 parity with the plain versions).
//
// What bounds it on the H100: 4*L^2*hd flops a head, far above the bytes
// (q, k, v, out once each), so the tensor cores: 1.04 ms for the UNet's
// level-0 self-attention at 1024^2 (3 x 16384 tokens, 8 heads of 40). The
// mma.sync path reaches a fraction of the wgmma rate; the arms measure the
// softmax between the products and the mapping of work to blocks, not the
// product rate.
#pragma once

#include <cmath>

#include "common.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kMaxHd = 160;
constexpr int kF32Threads = 64;     // fp32 twin: query rows a block

enum Arm : int {
  kNomax = 0,
  kChunked = 1,
  kUnpadded = 2,
  kPvt = 3,
  kRowmax = 4
};
enum Map : int { kHeadMajor = 0, kHeadFastest = 1, kAllHeads = 2 };

struct ArmArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, Lq, Lk, hd;
  float scale_log2;  // applied to q, rounded to its type
  float shift;       // static shift of the no-max arms
  bool safe;         // clamp s at shift + 88, add 1e-30 to l
  bool bf16_p;       // exp2 of bf16 logits, p bf16
  bool vec;          // 16-byte copies are aligned
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// d += a b: m16n8k16, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [row0, row0 + nrows) of an (L, hd) operand, rows `stride`
// elements apart, into an (nrows, LD) shared tile of HDP columns; rows
// >= L and columns >= hd are zero. cp.async when `vec` (hd % 8 == 0,
// aligned), plain element loads otherwise.
template <int HDP, int LD>
__device__ void stage_rows(bf16* dst, const bf16* src, long long stride,
                           int row0, int nrows, int L, int hd, bool vec) {
  constexpr int CPR = HDP / 8;
  for (int c = threadIdx.x; c < nrows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int gr = row0 + r;
    bf16* d = dst + r * LD + col;
    if (vec) {
      const bool ok = gr < L && col < hd;
      cp_async16(d, ok ? src + gr * stride + col : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < L && col + e < hd) ? src[gr * stride + col + e]
                                        : __float2bfloat16(0.0f);
    }
  }
}

// The block's kRows query rows from q0 on, multiplied by scale_log2 in fp32
// and rounded to bf16, into a (kRows, LD) shared tile of HDP columns; rows
// >= Lq and columns >= hd are zero.
template <int HDP, int LD>
__device__ void stage_q(bf16* Qs, const bf16* qb, long long D, int q0,
                        const ArmArgs& a) {
  constexpr int CPR = HDP / 8;
  const int hd = a.hd;
  for (int c = threadIdx.x; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int gr = q0 + r;
    float x[8];
    if (a.vec && gr < a.Lq && col < hd) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qb + gr * D + col);
      const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(e8[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = (gr < a.Lq && col + e < hd)
                   ? __bfloat162float(qb[gr * D + col + e])
                   : 0.0f;
    }
    bf16* d = Qs + r * LD + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = __float2bfloat16(x[e] * a.scale_log2);
  }
}

// Writes a warp's 16 staged output rows (LD apart, hd columns) to rows
// row0.. of the (Lq, hd) output, rows D elements apart: 16-byte stores
// when `vec`.
template <int LD>
__device__ __forceinline__ void store_warp_rows(bf16* ob, const bf16* stage,
                                                long long D, int row0,
                                                const ArmArgs& a, int lane) {
  const int hd = a.hd;
  if (a.vec) {
    const int cpr = hd / 8;
    for (int c = lane; c < 16 * cpr; c += 32) {
      const int r = c / cpr, col = (c % cpr) * 8;
      const int gr = row0 + r;
      if (gr < a.Lq)
        *reinterpret_cast<uint4*>(ob + gr * D + col) =
            *reinterpret_cast<const uint4*>(stage + r * LD + col);
    }
  } else {
    for (int c = lane; c < 16 * hd; c += 32) {
      const int r = c / hd, col = c % hd;
      const int gr = row0 + r;
      if (gr < a.Lq) ob[gr * D + col] = stage[r * LD + col];
    }
  }
}

// S (16 x BK per warp, fp32 C fragments) = Q K^T over nk16 slices of 16.
template <int NK, int BK, int LD>
__device__ __forceinline__ void scores(float (*S)[4], const uint32_t (*qf)[4],
                                       const bf16* Ks, int nk16, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[n][e] = 0.0f;
  const int mat = lane >> 3;
#pragma unroll
  for (int np = 0; np < BK / 16; ++np) {
    const bf16* row = Ks + (np * 16 + (mat >> 1) * 8 + (lane & 7)) * LD +
                      (mat & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk < nk16) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, row + kk * 16);
        mma(S[2 * np], qf[kk], b0, b1);
        mma(S[2 * np + 1], qf[kk], b2, b3);
      }
    }
  }
}

// One block's work on one (batch b, head h, query tile from q0): the whole
// attention of its kRows query rows, the output written.
template <int HDP, int BK, int ARM, bool OVERLAP>
__device__ __forceinline__ void arm_tile(const ArmArgs& a,
                                         unsigned char* smem, long long b,
                                         long long h, int q0) {
  constexpr int LD = HDP + 8;  // 16-byte pad: ldmatrix rows hit 8 bank groups
  constexpr int NK = HDP / 16;
  constexpr int NS = BK / 8;
  constexpr int NO = HDP / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * LD;       // two stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;      // two stages of BK x LD

  const long long D = (long long)a.H * a.hd;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.Lq * D + h * a.hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.Lk * D + h * a.hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.Lk * D + h * a.hd;
  bf16* ob = static_cast<bf16*>(a.out) + b * a.Lq * D + h * a.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3;
  const int w16 = warp * 16;
  const int hd = a.hd, Lk = a.Lk;
  const int nk16 = (hd + 15) >> 4;
  // n8 tiles of P V: hd padded to 16, or (kUnpadded) hd itself
  const int no8 = ARM == kUnpadded ? (hd + 7) >> 3 : 2 * nk16;
  const int ntiles = (Lk + BK - 1) / BK;

  // Q, pre-scaled and rounded to bf16, then the first tiles. Without the
  // overlap a copy group holds tile j of K and V; with it, K_{j+1} and V_j.
  static_assert(ARM != kRowmax, "the row-max arm runs in fp32 only");
  stage_q<HDP, LD>(Qs, qb, D, q0, a);
  stage_rows<HDP, LD>(Ks, kb, D, 0, BK, Lk, hd, a.vec);
  if (!OVERLAP)
    stage_rows<HDP, LD>(Vs, vb, D, 0, BK, Lk, hd, a.vec);
  cp_async_commit();
  if (OVERLAP) {
    if (ntiles > 1)
      stage_rows<HDP, LD>(Ks + BK * LD, kb, D, BK, BK, Lk, hd, a.vec);
    stage_rows<HDP, LD>(Vs, vb, D, 0, BK, Lk, hd, a.vec);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait_all();
  }
  __syncthreads();

  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    if (kk < nk16)
      ldsm_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
              Qs + (w16 + (mat & 1) * 8 + (lane & 7)) * LD + kk * 16 +
                  (mat >> 1) * 8);

  float O[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.0f;
  float l[2] = {0.0f, 0.0f};
  float m[2] = {-1e30f, -1e30f};  // kChunked's running max (the TPU init)
  float S[NS][4];
  float Sn[OVERLAP ? NS : 1][4];
  if (OVERLAP) scores<NK, BK, LD>(S, qf, Ks, nk16, lane);

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    const int kv0 = j * BK;
    if (OVERLAP) {
      // K_{j+2} where K_j was, V_{j+1} where V_{j-1} was; then S_{j+1},
      // whose MMAs run while this tile's softmax executes
      if (j + 2 < ntiles)
        stage_rows<HDP, LD>(Ks + (j & 1) * BK * LD, kb, D, kv0 + 2 * BK, BK,
                            Lk, hd, a.vec);
      if (j + 1 < ntiles)
        stage_rows<HDP, LD>(Vs + ((j + 1) & 1) * BK * LD, vb, D, kv0 + BK,
                            BK, Lk, hd, a.vec);
      cp_async_commit();
      if (j + 1 < ntiles)
        scores<NK, BK, LD>(Sn, qf, Ks + ((j + 1) & 1) * BK * LD, nk16, lane);
    } else {
      if (j + 1 < ntiles) {
        stage_rows<HDP, LD>(Ks + ((j + 1) & 1) * BK * LD, kb, D, kv0 + BK,
                            BK, Lk, hd, a.vec);
        stage_rows<HDP, LD>(Vs + ((j + 1) & 1) * BK * LD, vb, D, kv0 + BK,
                            BK, Lk, hd, a.vec);
      }
      cp_async_commit();
      scores<NK, BK, LD>(S, qf, Ks + (j & 1) * BK * LD, nk16, lane);
    }
    const bf16* Vt = Vs + (j & 1) * BK * LD;

    // --- softmax on the C fragments: element e of tile n is row
    // g + 8*(e>>1), key kv0 + 8n + 2t + (e&1) ---
    if (ARM == kChunked) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + n * 8 + 2 * t + (e & 1) < Lk)
            mx[e >> 1] = fmaxf(mx[e >> 1], S[n][e]);
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = 0.0f;
          if (kv0 + n * 8 + 2 * t + (e & 1) < Lk)
            p = a.bf16_p ? round_bf16(exp2f(round_bf16(S[n][e] - m[e >> 1])))
                         : exp2f(S[n][e] - m[e >> 1]);
          psum[e >> 1] += p;
          S[n][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        O[n][0] *= corr[0], O[n][1] *= corr[0];
        O[n][2] *= corr[1], O[n][3] *= corr[1];
      }
    } else {
      // no max pass: a static shift (T2's options; T5 and T9 safe, fp32 p)
      const bool safe = ARM == kNomax ? a.safe : true;
      const bool bf16_p = ARM == kNomax && a.bf16_p;
      const float cap = a.shift + 88.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = 0.0f;
          if (kv0 + n * 8 + 2 * t + (e & 1) < Lk) {
            const float d = (safe ? fminf(S[n][e], cap) : S[n][e]) - a.shift;
            p = bf16_p ? round_bf16(exp2f(round_bf16(d))) : exp2f(d);
          }
          l[e >> 1] += p;
          S[n][e] = p;
        }
    }

    // --- P V ---
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (ARM == kPvt) {
        // O^T (hd x 16 per warp) += V^T P^T. A = V^T from ldmatrix.trans of
        // the V tile; B = P^T, whose fragments for query columns 0-7 and
        // 8-15 are S's C registers of rows g and g+8. p = hi + lo in bf16.
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = S[2 * kk + half][2 * nt];
            const float p1 = S[2 * kk + half][2 * nt + 1];
            const float h0 = round_bf16(p0), h1 = round_bf16(p1);
            bh[nt][half] = pack_bf16(h0, h1);
            bl[nt][half] = pack_bf16(p0 - h0, p1 - h1);
          }
        const bf16* vrow =
            Vt + (kk * 16 + (mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
#pragma unroll
        for (int mt = 0; mt < NK; ++mt) {
          if (mt < nk16) {
            uint32_t va[4];
            ldsm_x4_t(va[0], va[1], va[2], va[3], vrow + mt * 16);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma(O[2 * mt + nt], va, bh[nt][0], bh[nt][1]);
              mma(O[2 * mt + nt], va, bl[nt][0], bl[nt][1]);
            }
          }
        }
      } else {
        const uint32_t pa[4] = {pack_bf16(S[2 * kk][0], S[2 * kk][1]),
                                pack_bf16(S[2 * kk][2], S[2 * kk][3]),
                                pack_bf16(S[2 * kk + 1][0], S[2 * kk + 1][1]),
                                pack_bf16(S[2 * kk + 1][2], S[2 * kk + 1][3])};
        const bf16* vrow =
            Vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (mat >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          if (2 * np + 1 < no8) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(b0, b1, b2, b3, vrow + np * 16);
            mma(O[2 * np], pa, b0, b1);
            mma(O[2 * np + 1], pa, b2, b3);
          } else if (2 * np < no8) {
            // kUnpadded's odd last n8 tile (hd 40: columns 32-39); lanes
            // 16-31 repeat lanes 0-15's addresses, which x2 ignores
            uint32_t b0, b1;
            ldsm_x2_t(b0, b1,
                      Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               LD + np * 16);
            mma(O[2 * np], pa, b0, b1);
          }
        }
      }
    }
    if (OVERLAP) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[n][e] = Sn[n][e];
    }
  }

  // --- epilogue: the row sums over the quad, O / l rounded once into the
  // warp's own Q rows (no other warp reads them), then 16-byte stores ---
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (ARM == kUnpadded || ARM == kPvt || (ARM == kNomax && a.safe))
      l[i] += 1e-30f;
  }
  __syncwarp();
  bf16* stage = Qs + w16 * LD;
  if (ARM == kPvt) {
    // O^T's element e of tile (mt, nt) is query nt*8 + 2t + (e&1), column
    // mt*16 + g + 8*(e>>1). Its row sum lives in the row layout (rows g,
    // g+8 of the quad of lane 4*row), so it is fetched per query column:
    // rows 2t and 2t+1 from lanes 8t and 8t+4, slot 0 for queries 0-7 and
    // slot 1 for queries 8-15.
    float lq[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      lq[nt][0] = __shfl_sync(0xffffffffu, l[nt], 8 * t);
      lq[nt][1] = __shfl_sync(0xffffffffu, l[nt], 8 * t + 4);
    }
#pragma unroll
    for (int mt = 0; mt < NK; ++mt)
      if (mt < nk16)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            stage[(nt * 8 + 2 * t + (e & 1)) * LD + mt * 16 + g +
                  8 * (e >> 1)] =
                __float2bfloat16(O[2 * mt + nt][e] / lq[nt][e & 1]);
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n < no8) {
        *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + n * 8 + 2 * t) =
            __floats2bfloat162_rn(O[n][0] / l[0], O[n][1] / l[0]);
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + n * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(O[n][2] / l[1], O[n][3] / l[1]);
      }
  }
  __syncwarp();
  store_warp_rows<LD>(ob, stage, D, q0 + w16, a, lane);
}

// The (batch, head, first query row) of block `blk` under MAP, for query
// tiles of `rows`; kAllHeads gives head 0 (the block loops over heads).
template <int MAP>
__device__ __forceinline__ void block_work(const ArmArgs& a, int rows,
                                           long long* b, long long* h,
                                           int* q0) {
  const int nq = (a.Lq + rows - 1) / rows;
  const int blk = blockIdx.x;
  int qt;
  if (MAP == kAllHeads) {
    *b = blk / nq, *h = 0, qt = blk % nq;
  } else if (MAP == kHeadFastest) {
    const int bq = blk / a.H;
    *h = blk - bq * a.H, *b = bq / nq, qt = bq % nq;
  } else {
    const int bh = blk / nq;
    *b = bh / a.H, *h = bh % a.H, qt = blk - bh * nq;
  }
  *q0 = qt * rows;
}

template <int HDP, int BK, int ARM, bool OVERLAP, int MAP>
__global__ void __launch_bounds__(kThreads)
arms_kernel(const ArmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long b, h;
  int q0;
  block_work<MAP>(a, kRows, &b, &h, &q0);
  if (MAP == kAllHeads) {
    for (int hh = 0; hh < a.H; ++hh) {
      if (hh) __syncthreads();  // the last head's tiles and stage are free
      arm_tile<HDP, BK, ARM, OVERLAP>(a, smem, b, hh, q0);
    }
  } else {
    arm_tile<HDP, BK, ARM, OVERLAP>(a, smem, b, h, q0);
  }
}

// fp32 twin of one query row of one (b, h): its pre-scaled q in the
// thread's slice of shared memory, K and V rows read from global memory
// (every thread of a block reads the same key: broadcast). T5, T9 and the
// layout arms are T2 with `safe` here: with fp32 v, rounding p to v's type
// or keeping it fp32 is the same. kChunked keeps a chunk of logits in
// shared memory for its max; kRowmax computes each logit twice.
template <int HDP, int BK, int ARM>
__device__ __forceinline__ void row_f32(const ArmArgs& a, float* fsm,
                                        long long b, long long h, int row) {
  const long long D = (long long)a.H * a.hd;
  const int hd = a.hd, Lk = a.Lk;
  const float* kb = static_cast<const float*>(a.k) + b * Lk * D + h * hd;
  const float* vb = static_cast<const float*>(a.v) + b * Lk * D + h * hd;
  float* qs = fsm + threadIdx.x * (HDP + 1);
  float* ss = fsm + kF32Threads * (HDP + 1) + threadIdx.x * (BK + 1);
  {
    const float* qr =
        static_cast<const float*>(a.q) + b * a.Lq * D + row * D + h * hd;
    for (int d = 0; d < hd; ++d) qs[d] = qr[d] * a.scale_log2;
  }
  float acc[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) acc[d] = 0.0f;
  auto logit = [&](int j) {
    const float* kr = kb + j * D;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) s = fmaf(qs[d], __ldg(kr + d), s);
    return s;
  };
  auto add_pv = [&](int j, float p) {
    const float* vr = vb + j * D;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) acc[d] = fmaf(p, __ldg(vr + d), acc[d]);
  };
  float l = 0.0f;
  if (ARM == kChunked) {
    float m = -1e30f;
    for (int c0 = 0; c0 < Lk; c0 += BK) {
      float mx = -INFINITY;
      for (int jj = 0; jj < BK && c0 + jj < Lk; ++jj) {
        ss[jj] = logit(c0 + jj);
        mx = fmaxf(mx, ss[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] *= corr;
      float psum = 0.0f;
      for (int jj = 0; jj < BK && c0 + jj < Lk; ++jj) {
        const float p = a.bf16_p ? round_bf16(exp2f(round_bf16(ss[jj] - m_new)))
                                 : exp2f(ss[jj] - m_new);
        psum += p;
        add_pv(c0 + jj, p);
      }
      l = l * corr + psum;
      m = m_new;
    }
  } else if (ARM == kRowmax) {
    float m = -INFINITY;
    for (int j = 0; j < Lk; ++j) m = fmaxf(m, logit(j));
    for (int j = 0; j < Lk; ++j) {
      const float d = logit(j) - m;
      const float p = a.bf16_p ? round_bf16(exp2f(round_bf16(d))) : exp2f(d);
      l += p;
      add_pv(j, p);
    }
  } else {
    const float cap = a.shift + 88.0f;
    for (int j = 0; j < Lk; ++j) {
      const float s = logit(j);
      const float d = (a.safe ? fminf(s, cap) : s) - a.shift;
      const float p = a.bf16_p ? round_bf16(exp2f(round_bf16(d))) : exp2f(d);
      l += p;
      add_pv(j, p);
    }
    if (a.safe) l += 1e-30f;
  }
  float* orow = static_cast<float*>(a.out) + b * a.Lq * D + row * D + h * hd;
#pragma unroll
  for (int d = 0; d < HDP; ++d)
    if (d < hd) orow[d] = acc[d] / l;
}

// ARM here is one of kNomax (every static-shift arm), kChunked, kRowmax.
template <int HDP, int BK, int ARM, int MAP>
__global__ void __launch_bounds__(kF32Threads)
arms_kernel_f32(const ArmArgs a) {
  extern __shared__ __align__(16) float fsm[];
  long long b, h;
  int q0;
  block_work<MAP>(a, kF32Threads, &b, &h, &q0);
  const int row = q0 + threadIdx.x;
  if (row >= a.Lq) return;  // no barriers below
  if (MAP == kAllHeads) {
    for (int hh = 0; hh < a.H; ++hh) row_f32<HDP, BK, ARM>(a, fsm, b, hh, row);
  } else {
    row_f32<HDP, BK, ARM>(a, fsm, b, h, row);
  }
}

template <int MAP>
cudaError_t check_grid(const ArmArgs& a, int rows, long long* blocks) {
  *blocks = (long long)a.B * (MAP == kAllHeads ? 1 : a.H) *
            ((a.Lq + rows - 1) / rows);
  return *blocks > 0x7fffffffLL ? cudaErrorInvalidConfiguration
                                : cudaSuccess;
}

template <int HDP, int BK, int ARM, int MAP>
cudaError_t launch_bf16(ArmArgs a, cudaStream_t s) {
  // T3 overlaps Q K^T of the next tile with this tile's softmax where the
  // second S tile fits beside O in registers
  constexpr bool OVERLAP = ARM == kChunked && HDP <= 80;
  constexpr size_t bytes = sizeof(bf16) * (HDP + 8) * (kRows + 4 * BK);
  auto kern = arms_kernel<HDP, BK, ARM, OVERLAP, MAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  long long blocks;
  if ((err = check_grid<MAP>(a, kRows, &blocks)) != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int HDP, int BK, int ARM, int MAP>
cudaError_t launch_f32(ArmArgs a, cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * kF32Threads *
                           (HDP + 1 + (ARM == kChunked ? BK + 1 : 0));
  auto kern = arms_kernel_f32<HDP, BK, ARM, MAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  long long blocks;
  if ((err = check_grid<MAP>(a, kF32Threads, &blocks)) != cudaSuccess)
    return err;
  kern<<<(unsigned)blocks, kF32Threads, bytes, s>>>(a);
  return cudaGetLastError();
}

// hd padded to one of the register tiles: 48 (hd 40), 80, 160.
template <int ARM, int BK, int MAP = kHeadMajor>
cudaError_t dispatch(ArmArgs a, bool is_bf16, cudaStream_t s) {
  // the fp32 twin's static-shift arms share one body
  constexpr int F = ARM == kChunked ? ARM : kNomax;
  if (is_bf16) {
    if (a.hd <= 48) return launch_bf16<48, BK, ARM, MAP>(a, s);
    if (a.hd <= 80) return launch_bf16<80, BK, ARM, MAP>(a, s);
    return launch_bf16<160, BK, ARM, MAP>(a, s);
  }
  if (a.hd <= 48) return launch_f32<48, BK, F, MAP>(a, s);
  if (a.hd <= 80) return launch_f32<80, BK, F, MAP>(a, s);
  return launch_f32<160, BK, F, MAP>(a, s);
}

ArmArgs make_args(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int Lq, int Lk, int hd, float scale_log2,
                  float shift, bool is_bf16) {
  ArmArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
  a.scale_log2 = scale_log2, a.shift = shift;
  a.vec = is_bf16 && hd % 8 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(out);
  return a;
}

bool bad(int B, int H, int Lq, int Lk, int hd) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || hd <= 0 || hd > kMaxHd;
}

}  // namespace
}  // namespace dtp
