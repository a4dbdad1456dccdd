// The fp32 twins of the transposed-product arms of the attention kernels,
// the last two A/B variants of the attention tools, both asking what it
// costs to put the head dim on the M axis of the tensor-core products
// instead of the N axis (bf16 runs the wgmma/TMA kernels, which do not keep
// that orientation: a register-A P V wastes no lanes at hd 40).
//
//   dtp_sublane_attention  T1 <- tools/bench_attn_sublane.py
//       sublane_attention / _sublane_kernel (pallas_call :84) in fp32: the
//       exact row-max softmax. q is multiplied by scale*log2(e); m and the
//       sum over the keys; e = exp2(s - m); then O / sum. (B, L, H*hd)
//       tensors read and written in place, hd <= 160, every query length
//       computed (the TPU wrapper pads Lq to its block and returns the
//       padded rows).
//   dtp_pv_product         T10 <- tools/bench_pv_transpose.py bench_shape /
//       _pv_kernel (pallas_call :66) in fp32: the P V product alone,
//       `iters` times: out = sum_{i < iters} e v with each pass's product
//       accumulated from zero and the passes summed, as e v or as
//       (v^T e^T)^T. e (bh, bq, Lk), v (bh, Lk, hd), out (bh, bq, hd). bf16
//       T10 runs csrc/pv_product_sm90.cu (a split wgmma/TMA GEMM whose
//       operands stay in shared memory for all passes); this entry
//       refuses bf16.
//
// T1 in fp32 runs attn_arms.cuh's FMA twin of the row-max softmax (one
// thread a query row: a transposed product is a tensor-core notion). bf16
// T1 runs csrc/flash_attention_sm90.cu (dtp_sublane_attention_sm90: the
// exact row max in one chunk of every K/V tile of the wgmma/TMA kernel,
// the products in the register-A orientation); this entry refuses bf16.
//
// T10, fp32: one thread an output element (the orientation picks which
// index runs fastest across threads).
#include "attn_arms.cuh"

namespace dtp {
namespace {

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

// T1 in fp32 (is_bf16 must be 0): q (B,Lq,H*hd), k and v (B,Lk,H*hd), out
// (B,Lq,H*hd), contiguous; hd <= 160; scale_log2 = scale * log2(e),
// applied to q before Q K^T.
extern "C" cudaError_t dtp_sublane_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int H, int Lq, int Lk, int hd,
                                             float scale_log2, int is_bf16,
                                             void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, 0.0f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 48)
    return dtp::launch_f32<48, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
  if (hd <= 80)
    return dtp::launch_f32<80, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
  return dtp::launch_f32<160, 64, dtp::kRowmax, dtp::kHeadMajor>(a, s);
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
