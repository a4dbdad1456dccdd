// The softmax arms of the attention kernels in fp32: four A/B variants of
// K8/K2, four C entries over the FMA twin of attn_arms.cuh (its design and
// bounds are described there). Every arm runs in bf16 on
// csrc/flash_attention_sm90.cu, and every entry here refuses bf16:
//
//   dtp_nomax_attention   T2 <- tools/bench_attn_variants.py
//       nomax_attention / _nomax_kernel: p = exp2(s - shift) with a static
//       shift and no max pass; `safe` clamps s at shift + 88 and adds 1e-30
//       to the row sum; `bf16_p` takes exp2 of bf16-rounded logits. bf16 T2
//       runs dtp_nomax_attention_sm90 (one pass of the wgmma/TMA kernel
//       against the static shift, head-major).
//   dtp_chunked_attention T3 <- bench_attn_variants.py chunked_attention /
//       _chunked_kernel in fp32: online softmax, the running max updated
//       once per chunk of bk keys (bk 64 or 128). bf16 T3 runs
//       csrc/flash_attention_sm90.cu (dtp_chunked_attention_sm90: a max
//       pass a chunk of the wgmma/TMA kernel, any chunk the TPU tool runs);
//       this entry refuses bf16.
//   dtp_nomax_unpadded    T5 <- bench_attn_variants.py nomax_unpadded /
//       _nomax_unpadded_kernel: T2 with `safe` and fp32 p. The wrapper
//       splits the heads into contiguous (B*h, L, hd) copies first and
//       launches it with one head, as the TPU tool does; bf16 T5 runs
//       dtp_nomax_unpadded_sm90 (T2's safe launch) on those copies.
//   dtp_pvt_attention     T9 <- tools/bench_attn_round4.py pvt_attention /
//       _pvt_kernel: T5's softmax with P V taking the fp32 p (the TPU
//       kernel promotes v to p's fp32), in fp32 only: with fp32 v that is
//       T5's fp32 twin. bf16 T9 runs csrc/flash_attention_sm90.cu
//       (dtp_pvt_attention_sm90: one pass of the wgmma/TMA kernel, p as
//       bf16 hi + lo into two products); this entry refuses bf16.
//
// Every entry maps blocks head-major (kHeadMajor).
#include "attn_arms.cuh"

// Every entry: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd),
// contiguous fp32 (is_bf16 must be 0); hd <= 160; scale_log2 = scale *
// log2(e), applied to q before Q K^T.

// T2 in fp32: exp2(s - shift), `safe` and `bf16_p` as in the TPU kernel.
extern "C" cudaError_t dtp_nomax_attention(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int H, int Lq, int Lk, int hd,
                                           float scale_log2, float shift,
                                           int safe, int bf16_p, int is_bf16,
                                           void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = safe != 0, a.bf16_p = bf16_p != 0;
  return dtp::dispatch_f32<dtp::kNomax, 64>(
      a, static_cast<cudaStream_t>(stream));
}

// T3 in fp32: the running max per chunk of bk keys; bk in {64, 128}
// divides Lk.
extern "C" cudaError_t dtp_chunked_attention(const void* q, const void* k,
                                             const void* v, void* out, int B,
                                             int H, int Lq, int Lk, int hd,
                                             float scale_log2, int bk,
                                             int bf16_p, int is_bf16,
                                             void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd) || (bk != 64 && bk != 128) ||
      Lk % bk)
    return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, 0.0f);
  a.bf16_p = bf16_p != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk == 64) return dtp::dispatch_f32<dtp::kChunked, 64>(a, s);
  return dtp::dispatch_f32<dtp::kChunked, 128>(a, s);
}

// T5 in fp32: T2 with `safe`.
extern "C" cudaError_t dtp_nomax_unpadded(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Lq, int Lk, int hd,
                                          float scale_log2, float shift,
                                          int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = true;
  return dtp::dispatch_f32<dtp::kNomax, 64>(
      a, static_cast<cudaStream_t>(stream));
}

// T9 in fp32: T5's softmax, P V with the fp32 p.
extern "C" cudaError_t dtp_pvt_attention(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int H, int Lq, int Lk, int hd,
                                         float scale_log2, float shift,
                                         int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = true;
  return dtp::dispatch_f32<dtp::kNomax, 64>(
      a, static_cast<cudaStream_t>(stream));
}
