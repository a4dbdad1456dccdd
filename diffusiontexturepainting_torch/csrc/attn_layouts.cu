// The layout arms of the attention kernels: the last four A/B variants of
// tools/bench_attn_variants.py, four C entries over the register-resident
// kernel of attn_arms.cuh (its design, bounds and fp32 twin are described
// there). The three head-layout arms compute T5's function (a clamped
// no-max softmax, fp32 p rounded to bf16 for P V, + 1e-30) and differ only
// in the block-to-work mapping, the question their TPU kernels asked of the
// grid:
//
//   dtp_nomax_4d         T6 <- bench_attn_variants.py nomax_4d (pallas_call
//       :325): heads read in place from the (B, L, h, hd) view, hd lanes
//       apart; blocks in (b, h, q-block) order (kHeadMajor), so concurrent
//       blocks share one head's K/V in L2.
//   dtp_nomax_allheads   T7 <- nomax_allheads / _nomax_allheads_kernel
//       (:343, pallas_call :379): one block per (b, q-block), every head of
//       it in a loop inside (kAllHeads): Q staged one head at a time, O in
//       registers for one head at a time, each head's columns of the
//       (rows, h*hd) output panel written before the next head starts. The
//       TPU's q_block (256/512) was a tile knob: the tile here is 64 rows.
//   dtp_nomax_laneslice  T8 <- nomax_laneslice / _nomax_laneslice_kernel
//       (:396, pallas_call :426): blocks in (b, q-block, h) order, the head
//       fastest (kHeadFastest); each block slices its head's hd lanes from
//       the packed (B, L, h*hd) rows, and the h blocks of a query tile run
//       together. On the TPU the output block was revisited across h; here
//       the question is the rasterization order against T6's.
//
// and the slotted-input arm in fp32:
//
//   dtp_slotted_attention T4 <- bench_attn_variants.py slotted_kernel_call
//       (:228, pallas_call :235) over ops/flash_attention.py _attn_kernel:
//       the row-max softmax on the fp32 twin (kRowmax: two passes over K,
//       the row max, then exp2 and P V) with exp2 of bf16 logits
//       (exp2_bf16, p bf16) or of fp32 logits, the row sum in fp32, the
//       division after P V. Its input is (B*h, L, P), heads already split
//       and zero-padded to P <= 160 lanes, with an explicit scale: every
//       lane is read. Every query row is computed (the TPU tool's unclamped
//       q-block grid left rows unwritten). bf16 T4 runs K13's two-pass
//       kernel in csrc/flash_attention_sm90.cu (dtp_slotted_attention_sm90);
//       this entry refuses bf16.
#include "attn_arms.cuh"

namespace dtp {
namespace {

template <int MAP>
cudaError_t layout_arm(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int Lk, int hd,
                       float scale_log2, float shift, int is_bf16,
                       void* stream) {
  if (bad(B, H, Lq, Lk, hd)) return cudaErrorInvalidValue;
  auto a = make_args(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                     is_bf16);
  a.safe = true;
  return dispatch<kUnpadded, 64, MAP>(a, is_bf16,
                                      static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace dtp

// T6, T7, T8: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd),
// contiguous, bf16 (is_bf16) or fp32; hd <= 160; scale_log2 = scale *
// log2(e), applied to q before Q K^T; shift the static shift (clamp at
// shift + 88).
extern "C" cudaError_t dtp_nomax_4d(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int Lq, int Lk, int hd, float scale_log2,
                                    float shift, int is_bf16, void* stream) {
  return dtp::layout_arm<dtp::kHeadMajor>(q, k, v, out, B, H, Lq, Lk, hd,
                                          scale_log2, shift, is_bf16, stream);
}

extern "C" cudaError_t dtp_nomax_allheads(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Lq, int Lk, int hd,
                                          float scale_log2, float shift,
                                          int is_bf16, void* stream) {
  return dtp::layout_arm<dtp::kAllHeads>(q, k, v, out, B, H, Lq, Lk, hd,
                                         scale_log2, shift, is_bf16, stream);
}

extern "C" cudaError_t dtp_nomax_laneslice(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int H, int Lq, int Lk, int hd,
                                           float scale_log2, float shift,
                                           int is_bf16, void* stream) {
  return dtp::layout_arm<dtp::kHeadFastest>(q, k, v, out, B, H, Lq, Lk, hd,
                                            scale_log2, shift, is_bf16,
                                            stream);
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
  auto a = dtp::make_args(q, k, v, out, BH, 1, Lq, Lk, P, scale_log2, 0.0f,
                          false);
  a.bf16_p = exp2_bf16 != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using dtp::kHeadMajor;
  using dtp::kRowmax;
  if (P <= 48) return dtp::launch_f32<48, 64, kRowmax, kHeadMajor>(a, s);
  if (P <= 80) return dtp::launch_f32<80, 64, kRowmax, kHeadMajor>(a, s);
  if (P <= 128) return dtp::launch_f32<128, 64, kRowmax, kHeadMajor>(a, s);
  return dtp::launch_f32<160, 64, kRowmax, kHeadMajor>(a, s);
}
