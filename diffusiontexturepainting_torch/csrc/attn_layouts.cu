// The layout arms of the attention kernels in fp32: the last four A/B
// variants of tools/bench_attn_variants.py, four C entries over the FMA
// twin of attn_arms.cuh (its design is described there). Every arm runs in
// bf16 on csrc/flash_attention_sm90.cu, and every entry here refuses bf16.
// The three head-layout arms compute T5's function (a clamped no-max
// softmax, fp32 p rounded to v's type for P V, + 1e-30) and differ only in
// the block-to-work mapping, the question their TPU kernels asked of the
// grid:
//
//   dtp_nomax_4d         T6 <- bench_attn_variants.py nomax_4d (pallas_call
//       :325): heads read in place from the (B, L, h, hd) view, hd lanes
//       apart; blocks in (b, h, q-block) order (kHeadMajor). bf16 T6 runs
//       dtp_nomax_4d_sm90 (T2's safe launch of the wgmma/TMA kernel's
//       one-pass shifted softmax, head-major).
//   dtp_nomax_allheads   T7 <- nomax_allheads / _nomax_allheads_kernel
//       (:343, pallas_call :379): one block per (b, q-block), every head of
//       it in a loop inside (kAllHeads). bf16 T7 runs
//       dtp_nomax_allheads_sm90 (the same one pass with the heads looped
//       inside a CTA).
//   dtp_nomax_laneslice  T8 <- nomax_laneslice / _nomax_laneslice_kernel
//       (:396, pallas_call :426): blocks in (b, q-block, h) order, the head
//       fastest (kHeadFastest); each block slices its head's hd lanes from
//       the packed (B, L, h*hd) rows, and the h blocks of a query tile run
//       together. bf16 T8 runs dtp_nomax_laneslice_sm90 (T6's launch on a
//       head-fastest grid).
//
// and the slotted-input arm:
//
//   dtp_slotted_attention T4 <- bench_attn_variants.py slotted_kernel_call
//       (:228, pallas_call :235) over ops/flash_attention.py _attn_kernel:
//       the row-max softmax (kRowmax: two passes over K, the row max, then
//       exp2 and P V) with exp2 of bf16 logits (exp2_bf16, p bf16) or of
//       fp32 logits, the row sum in fp32, the division after P V. Its input
//       is (B*h, L, P), heads already split and zero-padded to P <= 160
//       lanes, with an explicit scale: every lane is read. Every query row
//       is computed (the TPU tool's unclamped q-block grid left rows
//       unwritten). bf16 T4 runs K13's two-pass kernel
//       (dtp_slotted_attention_sm90).
#include "attn_arms.cuh"

// T6, T7, T8: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd),
// contiguous fp32 (is_bf16 must be 0); hd <= 160; scale_log2 = scale *
// log2(e), applied to q before Q K^T; shift the static shift (clamp at
// shift + 88).
extern "C" cudaError_t dtp_nomax_4d(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int Lq, int Lk, int hd, float scale_log2,
                                    float shift, int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = true;
  return dtp::dispatch_f32<dtp::kNomax, 64, dtp::kHeadMajor>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t dtp_nomax_allheads(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Lq, int Lk, int hd,
                                          float scale_log2, float shift,
                                          int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = true;
  return dtp::dispatch_f32<dtp::kNomax, 64, dtp::kAllHeads>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t dtp_nomax_laneslice(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int H, int Lq, int Lk, int hd,
                                           float scale_log2, float shift,
                                           int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift);
  a.safe = true;
  return dtp::dispatch_f32<dtp::kNomax, 64, dtp::kHeadFastest>(
      a, static_cast<cudaStream_t>(stream));
}

// T4 in fp32: q (BH,Lq,P), k and v (BH,Lk,P), out (BH,Lq,P), contiguous;
// P <= 160 lanes, all read; scale_log2 = scale * log2(e) with the caller's
// scale; exp2_bf16: exp2 of bf16-rounded logits and a bf16 p. is_bf16 must
// be 0: bf16 T4 is dtp_slotted_attention_sm90 (flash_attention_sm90.cu).
extern "C" cudaError_t dtp_slotted_attention(const void* q, const void* k,
                                             const void* v, void* out,
                                             int BH, int Lq, int Lk, int P,
                                             float scale_log2, int exp2_bf16,
                                             int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad(BH, 1, Lq, Lk, P)) return cudaErrorInvalidValue;
  auto a = dtp::make_args(q, k, v, out, BH, 1, Lq, Lk, P, scale_log2, 0.0f);
  a.bf16_p = exp2_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using dtp::kHeadMajor;
  using dtp::kRowmax;
  if (P <= 48) return dtp::launch_f32<48, 64, kRowmax, kHeadMajor>(a, s);
  if (P <= 80) return dtp::launch_f32<80, 64, kRowmax, kHeadMajor>(a, s);
  if (P <= 128) return dtp::launch_f32<128, 64, kRowmax, kHeadMajor>(a, s);
  return dtp::launch_f32<160, 64, kRowmax, kHeadMajor>(a, s);
}
