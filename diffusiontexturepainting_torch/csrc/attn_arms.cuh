// The FMA twin of every attention arm in fp32 (attn_arms.cu,
// attn_layouts.cu, attn_transposed.cu): one templated kernel, one thread a
// query row. Every arm runs in bf16 on csrc/flash_attention_sm90.cu (the
// wgmma/TMA kernel), whose fp32 parity this twin gives; its speed is not
// measured.
//
// Every arm pre-scales q by scale*log2(e) before Q K^T, so s is the fp32
// base-2 logit. Layout: (B, L, H*hd) tensors read and written in place
// (heads hd lanes apart), 64-bit offsets, hd <= 160 (a query row's hd fp32
// accumulators in a thread's registers).
//
// The softmax, a template parameter (ARM):
//   kNomax    exp2(s - shift) with a static shift and no max pass; `safe`
//             clamps s at shift + 88 and adds 1e-30 to the row sum;
//             `bf16_p` takes exp2 of bf16-rounded logits (T2; T5 to T9 with
//             `safe`: with fp32 v, rounding p to v's type or keeping it
//             fp32 is the same).
//   kChunked  online softmax, the running max updated once per chunk of
//             BK keys (T3).
//   kRowmax   the row-max softmax: two passes over K, the first for the
//             exact row max m, the second for exp2(s - m) (of bf16-rounded
//             s - m with `bf16_p`) and P V (T1, T4).
//
// The block-to-work mapping, a template parameter (MAP):
//   kHeadMajor   one block per (batch, head, query tile), the query tiles
//                of a head consecutive (T6 and the softmax arms).
//   kHeadFastest one block per (batch, query tile, head), the head
//                fastest (T8).
//   kAllHeads    one block per (batch, query tile), looping over the H
//                heads inside (T7).
#pragma once

#include <cmath>

#include "common.cuh"

namespace dtp {
namespace {

constexpr int kMaxHd = 160;
constexpr int kF32Threads = 64;  // query rows a block

enum Arm : int { kNomax = 0, kChunked = 1, kRowmax = 2 };
enum Map : int { kHeadMajor = 0, kHeadFastest = 1, kAllHeads = 2 };

struct ArmArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, Lq, Lk, hd;
  float scale_log2;  // applied to q
  float shift;       // static shift of the no-max arms
  bool safe;         // clamp s at shift + 88, add 1e-30 to l
  bool bf16_p;       // exp2 of bf16 logits, p bf16
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// One query row of one (b, h): its pre-scaled q in the thread's slice of
// shared memory, K and V rows read from global memory (every thread of a
// block reads the same key: broadcast). kChunked keeps a chunk of logits in
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

// hd padded to one of the row tiles: 48 (hd 40), 80, 160.
template <int ARM, int BK, int MAP = kHeadMajor>
cudaError_t dispatch_f32(ArmArgs a, cudaStream_t s) {
  if (a.hd <= 48) return launch_f32<48, BK, ARM, MAP>(a, s);
  if (a.hd <= 80) return launch_f32<80, BK, ARM, MAP>(a, s);
  return launch_f32<160, BK, ARM, MAP>(a, s);
}

ArmArgs make_args(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int Lq, int Lk, int hd, float scale_log2,
                  float shift) {
  ArmArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.B = B, a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd;
  a.scale_log2 = scale_log2, a.shift = shift;
  return a;
}

bool bad(int B, int H, int Lq, int Lk, int hd) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || hd <= 0 || hd > kMaxHd;
}

}  // namespace
}  // namespace dtp
