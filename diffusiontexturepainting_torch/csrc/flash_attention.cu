// Fused attention softmax(Q K^T * scale) V per head in fp32, online softmax
// over K/V tiles in shared memory; the (Lq, Lk) score matrix is never
// written to device memory. The FMA twin of flash_attention_sm90.cu: K2,
// K8 and K13 take fp32 only here (bf16 returns cudaErrorInvalidValue:
// their bf16 body is flash_attention_sm90.cu's wgmma/TMA kernel, chosen by
// dtype in ops/attention.py). Three entries share the device code:
//
//   dtp_flash_attention            K2 <- diffusiontexturepainting_tpu/ops/
//       flash_attention.py flash_attention / _attn_kernel (whole K/V
//       resident in VMEM, static-shift "nomax" softmax). Here the softmax is
//       the exact running-max form (Milakov & Gimelshein online softmax),
//       so the K/V panel need not be resident and any L works; q is
//       pre-scaled by scale*log2(e) and rounded to its type, as the TPU
//       kernel does (_attn_kernel's qs), so K2 computes K8's function.
//   dtp_flash_attention_streaming  K8 <- flash_attention.py
//       flash_attention_streaming / _stream_kernel: the same function for
//       the sequences whose K/V panel overflows VMEM (16384 tokens at the
//       1024^2 point: UNet level 0 with hd 40 and BH 24, the VAE mid-block
//       with hd 512 and BH 1-2).
//       K2 and K8 read and write the (B, L, heads*hd) projections in place.
//   dtp_flash_attention_slotted    K13 <- flash_attention.py
//       flash_attention_slotted / _attn_kernel(exp2_bf16=True): head h of
//       the (B, L, heads*128) layout in lanes [h*128, h*128+hd); only the
//       hd real lanes are read, the output's pad lanes are written zero.
//       exp2 runs on bf16-rounded logits against the ROW max, and the
//       probabilities are bf16 whatever the input type: an online softmax
//       would round against a running max instead, so this entry takes two
//       passes over K (the row max, then exp2 and P V).
//
// hd <= 512 is padded to a multiple of 16 in shared memory (zeros add
// nothing to Q K^T or P V). Offsets are 64-bit; the grid is one dimension
// (query tiles of each (batch, head) consecutive, so blocks running at
// once share a head's K/V in L2).
//
// What bounds it on the H100: 4*L^2*hd flops a head, far above the bytes
// (q, k, v, out read or written once), so the FP32 pipes at 67 TFLOP/s.
// This version is not near that bound: one (BQ x hd) fp32 output
// accumulator per block lives in shared memory and is reloaded around
// every P V product, the softmax between the products is serial, and
// there is no copy/compute overlap. What the tiles do about it: at
// hd <= 64 K8 takes 128 query rows a block, so K/V tiles are reused 128
// times from shared memory; at hd 512 the output accumulator alone is
// 128 KB for 64 rows, so K and V share one 16-row buffer and Q stays
// resident, which halves the passes over the K/V panel against 32-row
// tiles.
#include <cmath>

#include "common.cuh"

namespace dtp {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Pad;
template <>
struct Pad<float> { static constexpr int value = 4; };

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Shared-memory carve-up, computed identically on host and device. With
// SHARE_KV the V tile reuses the K tile's buffer (loaded after Q K^T).
template <typename T, int BQ, int BKV, bool SHARE_KV>
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
    o = SHARE_KV ? v : v + align128(sizeof(T) * BKV * ldh);
    if (SHARE_KV) v = k;
    s = o + align128(sizeof(float) * BQ * ldo);
    p = s + align128(sizeof(float) * BQ * lds);
    stats = p + align128(sizeof(T) * BQ * ldp);
    total = stats + align128(sizeof(float) * 2 * BQ);
  }
};

// Everything one launch reads. Element (b, h, row, c) of an operand lies at
// base + b*batch + h*head + row*row_stride + c.
template <typename T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long q_batch, q_row, k_batch, k_row, v_batch, v_row, o_batch, o_row;
  long long head;  // lane offset between heads, all four operands
  int H, Lq, Lk, hd;
  int out_cols;      // columns written per row: hd, or the slot width
  float scale_log2;  // applied to the logits, or to q with prescale_q
  bool prescale_q;   // q := round(q * scale_log2) before Q K^T
  bool two_pass;     // row max first; bf16 logits into exp2 (K13)
  bool vec;          // 16-byte loads are aligned
};

// Loads rows [row0, row0+nrows) of an (L, hd) matrix with rows `stride`
// elements apart into a (nrows, ldh) shared tile, zero-filling rows >= L
// and columns >= hd. With `scale` != 1 each loaded element is multiplied
// by it and rounded to T (by the thread that loaded it).
template <typename T>
__device__ void load_rows(T* dst, const T* src, long long stride, int row0,
                          int nrows, int L, int hd, int hdp, int ldh,
                          bool vec, float scale = 1.0f) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = hdp / V;
  for (int c = threadIdx.x; c < nrows * cpr; c += kThreads) {
    const int r = c / cpr, col = (c % cpr) * V;
    const int g = row0 + r;
    const bool ok = g < L;
    T* d = dst + r * ldh + col;
    load_chunk(d, ok ? src + g * stride + col : src, ok ? hd - col : 0, vec);
    if (scale != 1.0f) {
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = from_float<T>(to_float(d[e]) * scale);
    }
  }
}

// S (BQ x BKV, fp32) = Q K^T.
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int BQ, int BKV, bool SHARE_KV>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const AttnArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, BQ, BKV, SHARE_KV> lay(a.hd);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Ks = reinterpret_cast<T*>(smem + lay.k);
  T* Vs = reinterpret_cast<T*>(smem + lay.v);
  float* Os = reinterpret_cast<float*>(smem + lay.o);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  T* Ps = reinterpret_cast<T*>(smem + lay.p);
  float* row_max = reinterpret_cast<float*>(smem + lay.stats);
  float* row_sum = row_max + BQ;

  const int nq = (a.Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const long long b = bh / a.H, h = bh % a.H;
  const T* qb = a.q + b * a.q_batch + h * a.head;
  const T* kb = a.k + b * a.k_batch + h * a.head;
  const T* vb = a.v + b * a.v_batch + h * a.head;
  const int Lk = a.Lk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float s_scale = a.prescale_q ? 1.0f : a.scale_log2;

  load_rows(Qs, qb, a.q_row, q0, BQ, a.Lq, a.hd, lay.hdp, lay.ldh, a.vec,
            a.prescale_q ? a.scale_log2 : 1.0f);
  for (int i = threadIdx.x; i < BQ * lay.ldo; i += kThreads) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
  }

  if (a.two_pass) {
    // Pass 1: the exact row max of the base-2 logits, from the same Q K^T
    // tiles pass 2 recomputes bit for bit.
    for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
      load_rows(Ks, kb, a.k_row, kv0, BKV, Lk, a.hd, lay.hdp, lay.ldh, a.vec);
      __syncthreads();
      scores<BQ, BKV>(Qs, Ks, Ss, lay.hdp, lay.ldh, lay.lds);
      __syncthreads();
      for (int r = warp; r < BQ; r += kWarps) {
        float mx = -INFINITY;
        for (int j = lane; j < BKV; j += 32)
          if (kv0 + j < Lk) mx = fmaxf(mx, Ss[r * lay.lds + j] * s_scale);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0) row_max[r] = fmaxf(row_max[r], mx);
      }
      // the next tile's load is followed by a barrier before Ss is reused
    }
  }

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    load_rows(Ks, kb, a.k_row, kv0, BKV, Lk, a.hd, lay.hdp, lay.ldh, a.vec);
    __syncthreads();
    scores<BQ, BKV>(Qs, Ks, Ss, lay.hdp, lay.ldh, lay.lds);
    __syncthreads();
    // V goes where K was (or beside it) while the softmax runs.
    load_rows(Vs, vb, a.v_row, kv0, BKV, Lk, a.hd, lay.hdp, lay.ldh, a.vec);
    // Softmax in base 2: one warp per row.
    for (int r = warp; r < BQ; r += kWarps) {
      float* srow = Ss + r * lay.lds;
      const float m_old = row_max[r];
      float mx = -INFINITY;
      for (int j = lane; j < BKV; j += 32) {
        const float s = (kv0 + j < Lk) ? srow[j] * s_scale : -INFINITY;
        srow[j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one real key, so m_new is finite; with
      // two passes it is the row max already and alpha is 1
      const float m_new = fmaxf(m_old, mx);
      const float alpha = exp2f(m_old - m_new);
      float sum = 0.0f;
      for (int j = lane; j < BKV; j += 32) {
        float p;
        if (a.two_pass)
          p = round_bf16(exp2f(round_bf16(srow[j] - m_new)));
        else
          p = exp2f(srow[j] - m_new);
        Ps[r * lay.ldp + j] = from_float<T>(p);
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (!a.two_pass)
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

  T* ob = a.out + b * a.o_batch + h * a.head;
  for (int idx = threadIdx.x; idx < BQ * a.out_cols; idx += kThreads) {
    const int r = idx / a.out_cols, c = idx % a.out_cols;
    const int g = q0 + r;
    if (g < a.Lq)
      ob[g * a.o_row + c] = from_float<T>(
          c < a.hd ? Os[r * lay.ldo + c] / row_sum[r] : 0.0f);
  }
}

template <typename T, int BQ, int BKV, bool SHARE_KV>
cudaError_t launch(AttnArgs<T> a, int B, cudaStream_t stream) {
  const Layout<T, BQ, BKV, SHARE_KV> lay(a.hd);
  auto kern = attn_kernel<T, BQ, BKV, SHARE_KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  const long long strides[] = {a.q_batch, a.q_row, a.k_batch, a.k_row,
                               a.v_batch, a.v_row, a.head};
  a.vec = a.hd % V == 0 && aligned16(a.q) && aligned16(a.k) &&
          aligned16(a.v);
  for (long long s : strides) a.vec = a.vec && s % V == 0;
  const long long blocks =
      (long long)B * a.H * ((a.Lq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, lay.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
AttnArgs<T> make_args(const void* q, const void* k, const void* v, void* out,
                      int H, int Lq, int Lk, int hd, float scale_log2) {
  AttnArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.out_cols = hd;
  a.scale_log2 = scale_log2;
  return a;
}

// The (B, L, H*hd) projections, heads hd lanes apart.
template <typename T>
AttnArgs<T> projection_args(const void* q, const void* k, const void* v,
                            void* out, int B, int H, int Lq, int Lk, int hd,
                            float scale_log2) {
  AttnArgs<T> a = make_args<T>(q, k, v, out, H, Lq, Lk, hd, scale_log2);
  const long long D = (long long)H * hd;
  a.q_row = a.o_row = a.k_row = a.v_row = D;
  a.q_batch = a.o_batch = (long long)Lq * D;
  a.k_batch = a.v_batch = (long long)Lk * D;
  a.head = hd;
  return a;
}

bool bad(int B, int H, int Lq, int Lk, int hd) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || hd <= 0 || hd > 512;
}

}  // namespace
}  // namespace dtp

// K2 in fp32: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd),
// contiguous; hd <= 512; scale_log2 = scale * log2(e), applied to q before
// Q K^T (K8's function).
extern "C" cudaError_t dtp_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, int is_bf16, void* stream) {
  if (dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  // bf16 runs flash_attention_sm90.cu's wgmma kernel
  if (is_bf16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = dtp::projection_args<float>(q, k, v, out, B, H, Lq, Lk, hd,
                                       scale_log2);
  a.prescale_q = true;
  if (hd > 160) return dtp::launch<float, 32, 16, false>(a, B, s);
  return dtp::launch<float, 64, 32, false>(a, B, s);
}

// K8 in fp32: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd),
// contiguous; hd <= 512; scale_log2 = scale * log2(e), applied to q before
// Q K^T.
extern "C" cudaError_t dtp_flash_attention_streaming(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, int is_bf16, void* stream) {
  if (dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  // bf16 runs flash_attention_sm90.cu's wgmma kernel
  if (is_bf16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = dtp::projection_args<float>(q, k, v, out, B, H, Lq, Lk, hd,
                                       scale_log2);
  a.prescale_q = true;
  if (hd <= 64) return dtp::launch<float, 128, 32, false>(a, B, s);
  if (hd <= 160) return dtp::launch<float, 64, 32, false>(a, B, s);
  return dtp::launch<float, 32, 16, true>(a, B, s);
}

// K13 in fp32: q, k, v (B,L,H*slot) with rows q_row / kv_row elements
// apart and images q_batch / kv_batch apart (k and v share strides: views
// of one fused projection); out (B,L,H*slot) contiguous. Head h reads lanes
// [h*slot, h*slot+hd) and writes its pad lanes zero. hd <= slot <= 512.
extern "C" cudaError_t dtp_flash_attention_slotted(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int L, int hd, int slot, long long q_row, long long q_batch,
    long long kv_row, long long kv_batch, float scale_log2, int is_bf16,
    void* stream) {
  if (dtp::bad(B, H, L, L, hd) || slot < hd || slot > 512)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto a) {
    a.q_row = q_row, a.q_batch = q_batch;
    a.k_row = a.v_row = kv_row, a.k_batch = a.v_batch = kv_batch;
    a.o_row = (long long)H * slot, a.o_batch = (long long)L * H * slot;
    a.head = slot, a.out_cols = slot;
    a.prescale_q = a.two_pass = true;
    return a;
  };
  // bf16 runs flash_attention_sm90.cu's wgmma kernel
  if (is_bf16) return cudaErrorInvalidValue;
  return dtp::launch<float, 64, 32, false>(
      fill(dtp::make_args<float>(q, k, v, out, H, L, L, hd, scale_log2)), B,
      s);
}
