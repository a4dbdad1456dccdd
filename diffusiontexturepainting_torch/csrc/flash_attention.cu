// Fused attention softmax(Q K^T * scale) V per head, online softmax over
// K/V tiles in shared memory; the (Lq, Lk) score matrix is never written
// to device memory.
//
// Replaces (TPU): diffusiontexturepainting_tpu/ops/flash_attention.py
//   flash_attention / _attn_kernel (whole K/V resident in VMEM, static-shift
//   "nomax" softmax). Here the softmax is the exact running-max form
//   (Milakov & Gimelshein online softmax), so the K/V panel need not be
//   resident: a block walks K/V in tiles, as the TPU's streaming variant
//   does, and any L works.
//
// Layout: q (BH, Lq, hd), k and v (BH, Lk, hd), out (BH, Lq, hd); the head
// split and merge stay torch reshapes outside. hd <= 512 is padded to a
// multiple of 16 in shared memory (zeros add nothing to Q K^T or P V).
//
// What bounds it on the H100: at the slice's shapes (L = 1024; hd 40 with
// 24 heads-x-batch, hd 512 with 1-2) the work is small: the UNet case is
// bounded by the serial softmax between the two products and by the
// 4-warp blocks; the VAE case (hd 512) by shared-memory traffic of the
// 32-row tiles. This first version keeps one (BQ x hd) fp32 output
// accumulator per block in shared memory, bf16 WMMA (mma.sync) for both
// products and an fp32 FMA twin; a register-resident FA2/FA3-style
// pipeline is later work.
#include <mma.h>

#include <cmath>

#include "common.cuh"

using namespace nvcuda;

namespace dtp {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> { static constexpr int value = 8; };
template <>
struct Pad<float> { static constexpr int value = 4; };

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Shared-memory carve-up, computed identically on host and device.
template <typename T, int BQ, int BKV>
struct Layout {
  int hdp, ldh, ldo, lds, ldp;
  size_t q, k, v, o, s, p, stats, total;
  __host__ __device__ explicit Layout(int hd) {
    hdp = (hd + 15) / 16 * 16;
    ldh = hdp + Pad<T>::value;
    ldo = hdp + 4;
    lds = BKV + 4;
    ldp = BKV + Pad<T>::value;
    q = 0;
    k = q + align128(sizeof(T) * BQ * ldh);
    v = k + align128(sizeof(T) * BKV * ldh);
    o = v + align128(sizeof(T) * BKV * ldh);
    s = o + align128(sizeof(float) * BQ * ldo);
    p = s + align128(sizeof(float) * BQ * lds);
    stats = p + align128(sizeof(T) * BQ * ldp);
    total = stats + align128(sizeof(float) * 2 * BQ);
  }
};

// Loads rows [row0, row0+nrows) of a (L, hd) matrix into a (nrows, ldh)
// shared tile, zero-filling rows >= L and columns >= hd.
template <typename T>
__device__ void load_rows(T* dst, const T* src, int row0, int nrows, int L,
                          int hd, int hdp, int ldh, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = hdp / V;
  for (int c = threadIdx.x; c < nrows * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * V;
    const int g = row0 + r;
    const bool ok = g < L;
    load_chunk(dst + r * ldh + col, ok ? src + (size_t)g * hd + col : src,
               ok ? hd - col : 0, vec);
  }
}

// S (BQ x BKV, fp32) = Q K^T.
template <int BQ, int BKV>
__device__ void scores(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
                       float* Ss, int hdp, int ldh, int lds) {
  const int warp = threadIdx.x >> 5;
  constexpr int TJ = BKV / 16;
  for (int t = warp; t < (BQ / 16) * TJ; t += kWarps) {
    const int ti = t / TJ, tj = t % TJ;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int d0 = 0; d0 < hdp; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + ti * 16 * ldh + d0, ldh);
      wmma::load_matrix_sync(b, Ks + tj * 16 * ldh + d0, ldh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + ti * 16 * lds + tj * 16, acc, lds,
                            wmma::mem_row_major);
  }
}

template <int BQ, int BKV>
__device__ void scores(const float* Qs, const float* Ks, float* Ss, int hdp,
                       int ldh, int lds) {
  for (int idx = threadIdx.x; idx < BQ * BKV; idx += kThreads) {
    const int r = idx / BKV, j = idx % BKV;
    const float* qr = Qs + r * ldh;
    const float* kr = Ks + j * ldh;
    float s = 0.0f;
    for (int d = 0; d < hdp; ++d) s = fmaf(qr[d], kr[d], s);
    Ss[r * lds + j] = s;
  }
}

// O (BQ x hdp, fp32, in shared memory) += P V.
template <int BQ, int BKV>
__device__ void accumulate_pv(const __nv_bfloat16* Ps,
                              const __nv_bfloat16* Vs, float* Os, int hdp,
                              int ldh, int ldo, int ldp) {
  const int warp = threadIdx.x >> 5;
  const int tc_n = hdp / 16;
  for (int t = warp; t < (BQ / 16) * tc_n; t += kWarps) {
    const int ti = t / tc_n, tc = t % tc_n;
    float* o = Os + ti * 16 * ldo + tc * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, ldo, wmma::mem_row_major);
#pragma unroll
    for (int j0 = 0; j0 < BKV; j0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + ti * 16 * ldp + j0, ldp);
      wmma::load_matrix_sync(b, Vs + j0 * ldh + tc * 16, ldh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, ldo, wmma::mem_row_major);
  }
}

template <int BQ, int BKV>
__device__ void accumulate_pv(const float* Ps, const float* Vs, float* Os,
                              int hdp, int ldh, int ldo, int ldp) {
  for (int idx = threadIdx.x; idx < BQ * hdp; idx += kThreads) {
    const int r = idx / hdp, c = idx % hdp;
    const float* pr = Ps + r * ldp;
    float s = 0.0f;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) s = fmaf(pr[j], Vs[j * ldh + c], s);
    Os[r * ldo + c] += s;
  }
}

template <typename T, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int Lq, int Lk,
            int hd, float scale_log2, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, BQ, BKV> lay(hd);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  float* Os = reinterpret_cast<float*>(smem + lay.o);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  T* Ps = reinterpret_cast<T*>(smem + lay.p);
  float* row_max = reinterpret_cast<float*>(smem + lay.stats);
  float* row_sum = row_max + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * Lq * hd;
  const T* kb = k + (size_t)bh * Lk * hd;
  const T* vb = v + (size_t)bh * Lk * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows(Qs, qb, q0, BQ, Lq, hd, lay.hdp, lay.ldh, vec);
  for (int i = threadIdx.x; i < BQ * lay.ldo; i += kThreads) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
  }

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    load_rows(Ks, kb, kv0, BKV, Lk, hd, lay.hdp, lay.ldh, vec);
    load_rows(Vs, vb, kv0, BKV, Lk, hd, lay.hdp, lay.ldh, vec);
    __syncthreads();
    scores<BQ, BKV>(Qs, Ks, Ss, lay.hdp, lay.ldh, lay.lds);
    __syncthreads();
    // Online softmax in base 2: one warp per row.
    for (int r = warp; r < BQ; r += kWarps) {
      float* srow = Ss + r * lay.lds;
      const float m_old = row_max[r];
      float mx = -INFINITY;
      for (int j = lane; j < BKV; j += 32) {
        const float s = (kv0 + j < Lk) ? srow[j] * scale_log2 : -INFINITY;
        srow[j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_old, mx);
      const float alpha = exp2f(m_old - m_new);
      float sum = 0.0f;
      for (int j = lane; j < BKV; j += 32) {
        const float p = exp2f(srow[j] - m_new);
        Ps[r * lay.ldp + j] = from_float<T>(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int c = lane; c < lay.hdp; c += 32) Os[r * lay.ldo + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_max[r] = m_new;
        row_sum[r] = row_sum[r] * alpha + sum;
      }
    }
    __syncthreads();
    accumulate_pv<BQ, BKV>(Ps, Vs, Os, lay.hdp, lay.ldh, lay.ldo, lay.ldp);
    __syncthreads();
  }

  T* ob = out + (size_t)bh * Lq * hd;
  for (int idx = threadIdx.x; idx < BQ * hd; idx += kThreads) {
    const int r = idx / hd, c = idx % hd;
    const int g = q0 + r;
    if (g < Lq) ob[(size_t)g * hd + c] = from_float<T>(Os[r * lay.ldo + c] /
                                                        row_sum[r]);
  }
}

template <typename T, int BQ, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Lq, int Lk, int hd, float scale,
                   cudaStream_t stream) {
  const Layout<T, BQ, BKV> lay(hd);
  auto kern = attn_kernel<T, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  const bool vec = hd % V == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v);
  dim3 grid((unsigned)((Lq + BQ - 1) / BQ), (unsigned)BH);
  kern<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, hd,
      scale * 1.4426950408889634f, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtp

// q (BH,Lq,hd), k and v (BH,Lk,hd), out (BH,Lq,hd); hd <= 512.
extern "C" cudaError_t dtp_flash_attention(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int Lq, int Lk, int hd,
                                           float scale, int is_bf16,
                                           void* stream) {
  if (BH <= 0 || Lq <= 0 || Lk <= 0 || hd <= 0 || hd > 512)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 160;
  if (is_bf16) {
    if (wide)
      return dtp::launch<__nv_bfloat16, 32, 32>(q, k, v, out, BH, Lq, Lk, hd,
                                                scale, s);
    return dtp::launch<__nv_bfloat16, 64, 64>(q, k, v, out, BH, Lq, Lk, hd,
                                              scale, s);
  }
  if (wide)
    return dtp::launch<float, 32, 16>(q, k, v, out, BH, Lq, Lk, hd, scale, s);
  return dtp::launch<float, 64, 32>(q, k, v, out, BH, Lq, Lk, hd, scale, s);
}
