// K2, K8, K13 and the T1 to T9 arms in bf16 for Hopper
// (sm_90a): one warp-specialised kernel, Q K^T and P V both on wgmma, K/V
// tiles brought in by TMA.
//
//   dtp_flash_attention_sm90            K2 <- diffusiontexturepainting_tpu/
//       ops/flash_attention.py flash_attention / _attn_kernel, and
//   dtp_flash_attention_streaming_sm90  K8 <- flash_attention_streaming /
//       _stream_kernel: one function, softmax over base-2 logits per head,
//       online (running max, alpha rescaling), q pre-scaled by
//       scale*log2(e) and rounded to bf16 before Q K^T, the row sum in
//       fp32, the division after P V (the TPU's K2 takes a static shift
//       where this takes the running max; they agree within the nomax
//       domain). Both read and write the (B, L, H*hd) projections in
//       place; any Lq, Lk; hd <= 512. K2 serves the sequences of 1024 and
//       4096 tokens, K8 those of 16384; a probe may name K2's bucket.
//   dtp_flash_attention_slotted_sm90    K13 <- flash_attention.py
//       flash_attention_slotted / _attn_kernel(exp2_bf16=True): head h of
//       (B, L, H*slot) tensors in lanes [h*slot, h*slot+hd); q, k, v may be
//       strided views of one fused projection (k and v share strides). Pass
//       1 streams K alone for the exact row max m; pass 2 issues the same
//       wgmma sequence (so S is the same bits and p <= 1 holds exactly) and
//       computes p = bf16(exp2(bf16(s - m))), the fp32 sum of those p, and
//       O / l. Only the hd real lanes are read; the pad lanes are written 0.
//   dtp_slotted_attention_sm90          T4 <- tools/bench_attn_variants.py
//       slotted_kernel_call (pallas_call :235 over _attn_kernel): K13's
//       function on heads already split into (B*h, L, P) slots, P <= 160,
//       every lane read, the caller's scale, any Lq and Lk: K13's two
//       passes with H = 1 and hd = P (the bucket from P: 128 -> 128, 160 ->
//       160, K2's two warpgroups on 64-key tiles). exp2_bf16 takes K13's
//       pass 2; without it the last pass is kFixedMaxF32: p = exp2(s - m)
//       in fp32, the row sum of those p, bf16(p) into P V. Both issue pass
//       1's wgmma sequence again, so p <= 1 holds exactly in both.
//   dtp_chunked_attention_sm90          T3 <- tools/bench_attn_variants.py
//       chunked_attention / _chunked_kernel (pallas_call :201): the running
//       max m (from -1e30) updated once per chunk of bk keys. A chunk of
//       several K/V tiles takes a max pass over its tiles (Q K^T alone, the
//       wgmma sequence of the pass after it, so S is the same bits; O
//       waits in shared memory, its registers free for S), then corr =
//       exp2(m - m_new) rescales l and O, then a pass against the fixed
//       m_new: p = exp2(s - m_new) in fp32 (kChunked) or bf16(exp2(bf16(s
//       - m_new))) (kChunked | kBf16P), l += the fp32 sum of those p, O +=
//       bf16(p) V. A chunk of one tile takes the tile's own max first
//       (kOnline's sequence, kBf16P or-ed in for bf16 p). bk: Lk, a
//       multiple of the bucket's BKV dividing Lk, or 64 under a 128-key
//       tile (at hd <= 80 the max per 64-column half of S, the second
//       half's softmax and P V after the first half's P V: kHalves; at hd
//       81..128, where those run out of registers, the bucket on 64-key
//       tiles). At bk = BKV with fp32 p it is K8/K2's kOnline launch
//       itself.
//   dtp_sublane_attention_sm90          T1 <- tools/bench_attn_sublane.py
//       sublane_attention / _sublane_kernel (pallas_call :84): the exact
//       row max, p = exp2(s - m) in fp32, their fp32 sum, bf16(p) into P V,
//       the division after: kFixedMaxF32, T3's kChunked in one chunk of all
//       Lk keys (the ragged last tile masked), which is K13's and T4's
//       order (the chunk loop's one-chunk case, fixed at compile time). The
//       TPU computed S^T = K Q^T and O^T = V^T E^T because hd 40 filled 31%
//       of its MXU's lanes; a register-A P V has no such waste, so the
//       orientation is not kept (as for T9).
//   dtp_pvt_attention_sm90              T9 <- tools/bench_attn_round4.py
//       pvt_attention / _pvt_kernel (pallas_call :89): one pass against a
//       static shift (kShiftSplitP): s clamped at shift + 88, p =
//       exp2(s - shift) in fp32, the row sum of those p + 1e-30, and P V
//       with P unrounded, as the TPU kernel's dot_general(v, e) promotes v
//       to p's fp32: p = hi + lo, hi = bf16(p), lo = bf16(p - hi), two
//       register-A wgmmas a k16 step into one accumulator (v is exact in
//       fp32, so this is p v to about 2^-16 relative). The TPU computed
//       O^T = V^T E^T because hd 40 filled 31% of its MXU's lanes; a
//       register-A P V has no such waste, so the orientation is not kept.
//       The head-major grid and K2's bucket for hd.
//   dtp_nomax_attention_sm90            T2 <- tools/bench_attn_variants.py
//       nomax_attention / _nomax_kernel (pallas_call :157): the one pass
//       against the static shift on T9's head-major grid and K2's bucket,
//       bf16(p) into P V (kShift). `safe` clamps s at shift + 88 and adds
//       1e-30 to l; without it neither (the clamp +inf, the epsilon 0: both
//       are run-time fields, one instantiation), and
//       s - shift above 128 gives p = +inf and NaN rows, as on the TPU.
//       `bf16_p`: p = bf16(exp2(bf16(min(s, cap) - shift))), l the fp32 sum
//       of those p (kShift | kBf16P; the first rounding in integer
//       operations, the second two at a time into P V's operand).
//   dtp_nomax_unpadded_sm90             T5 <- bench_attn_variants.py
//       nomax_unpadded / _nomax_unpadded_kernel (pallas_call :293): T2's
//       safe launch with fp32 p on the wrapper's contiguous (B*h, L, hd)
//       copies of the heads, H = 1 (rows hd * 2 bytes apart: 80, 160, 320
//       at hd 40, 80, 160, all whole 16 bytes). The bucket is T2's (plan
//       sees the same B*H), so the bits are T2's.
//   dtp_nomax_4d_sm90                   T6 <- bench_attn_variants.py
//       nomax_4d (pallas_call :325 over _nomax_unpadded_kernel): T5's
//       function with the heads read in place from the (B, L, h*hd) rows,
//       blocks (b, h, q-block): T2's safe launch itself, its bits.
//   dtp_nomax_laneslice_sm90            T8 <- bench_attn_variants.py
//       nomax_laneslice / _nomax_laneslice_kernel (pallas_call :426): the
//       same CTA body, bucket and tensor maps on a head-fastest grid (head,
//       query tile, image) (kShift | kGridHeadFastest): the H CTAs of a query
//       tile launch together and share the packed rows' 128-byte lines in
//       L2 (80-byte head slices at hd 40). Each CTA computes the (b, h, tile)
//       it would under T6's grid in the same key order, so the bits are
//       T6's. The order is what T8's TPU tool asked of the grid.
//   dtp_nomax_allheads_sm90             T7 <- tools/bench_attn_variants.py
//       nomax_allheads / _nomax_allheads_kernel (pallas_call :379): the same
//       one pass with bf16(p) into P V (kShift), every head of a query tile
//       in one CTA (AH): the grid is (query tile, 1, image), H times
//       smaller, and the heads run in turn inside the CTA. The producer
//       streams (head, K/V tile) pairs through one ring without a break
//       (its stage counter and mbarrier phases carry across heads), so the
//       next head's first tiles load while this head's last products and
//       epilogue run. Q has two buffers: the next head's Q lands in one
//       while this head runs on the other, and a buffer takes a new head's
//       Q once the consumers have stored the head that used it (q_empty),
//       since the epilogue stages O in the warpgroup's own Q rows (one
//       buffer, the next Q loaded after the stores, was 1-8% slower on the
//       card). Consumer warpgroups: allheads_consumers; (KD, NV, BKV):
//       K2's long-sequence bucket for hd.
//
// Dispatch is by dtype in ops/attention.py (K2, K8, K13) and
// ops/attention_variants.py (T1 to T9): bf16 CUDA tensors come here and
// nowhere else; fp32 stays on flash_attention.cu's FMA twin (T4, T6, T7
// and T8: attn_layouts.cu, T2, T3, T5 and T9: attn_arms.cu, T1:
// attn_transposed.cu).
//
// What bounds it on the H100: 4*L^2*hd flops a head against bytes read and
// written once, so the tensor cores: 1.04 ms for a 1024^2 stamp's UNet
// level-0 self-attention (3 x 16384 tokens, 8 heads of 40). At hd 40 the
// softmax between the products (one ex2 per score on 16 MUFU lanes an SM)
// costs as much as the products themselves. At 1024 tokens (K2 at 256^2)
// a call is a few microseconds of work, and filling the 132 SMs matters
// as much as the tile.
//
// Design. A CTA is one producer warpgroup and NC consumer warpgroups of 64
// query rows each: three at hd <= 48 (192 rows; setmaxnreg 24 / 160), two
// at 49..160 (40 / 232), one above (no setmaxnreg: up to 255 registers for
// a 256-column O). The more query rows a CTA holds, the fewer times each
// K/V tile crosses from L2 (at hd 40 three warpgroups ran faster than two
// on the card at 16384 tokens). The grid is head-major, (query tile, head,
// image x slice), so the CTAs in flight share one head's K/V in L2.
//   - Q: one TMA load per 64-column swizzle atom; the consumers scale their
//     rows by scale*log2(e) and round to bf16 in place.
//   - K, V: tiles of BKV keys in a ring of kStages stages with full/empty
//     mbarriers; one producer thread issues the copies, so the next tile's
//     copy overlaps this tile's products. K and V have separate full
//     barriers: Q K^T starts before V lands. A max pass (K13's, T1's, T3's
//     per chunk) streams K only (the producer arrives on the V barrier
//     without a copy, so its phase stays in step with the K barrier's).
//   - S = Q K^T: wgmma m64nBKVk16, A = Q and B = the K tile (K-major), both
//     in shared memory in the 128-byte swizzle TMA writes.
//   - Softmax on the accumulator registers: a row's values sit in the 4
//     threads of a quad (two shuffles); p = ex2.approx(s - m), the logits
//     being base 2 already; only the last tile masks columns >= Lk (full
//     tiles compile the test out); the mode (online, max pass, fixed max,
//     fixed shift) is a template parameter.
//   - O += P V: P converted to bf16 in registers is wgmma's register A
//     operand (the m64nNk16 accumulator layout of S is the A fragment
//     layout, no shuffles); B = the V tile, MN-major (the transpose bit).
//     O stays in registers in fp32.
//   - Epilogue: O / l rounded to bf16, staged in the warpgroup's own Q rows
//     (the 128-byte swizzle, no bank conflicts), then 16-byte stores of hd
//     columns (K13: every lane of the slot, the pad lanes 0).
// Head-dim buckets (kBuckets): hd rounds up to KD in {48, 80, 128, 160,
// 256, 512}. Storage is whole 64-column atoms: TMA describes each operand
// with hd as its innermost dimension and the head stride next, so columns
// [hd, 64*k) arrive as zeros and K13 never reads its slots' pad lanes;
// Q K^T issues only KD/16 k16 steps (hd 40: three steps over a 64-column
// atom, the padding to 64 costs shared memory but no products; hd 160: ten
// steps over three atoms), P V runs N = min(KD, 256) (160 is a valid
// wgmma N). The 160 bucket (K2 at the 1024^2 stamp's UNet level 2) runs
// two warpgroups on 64-key tiles: against the 256 bucket it issues 0.63x
// the products. Above 256 (the VAE mid-block's hd 512) O is split into
// output slices over a grid dimension, each slice recomputing S over the
// full hd, with one consumer warpgroup and 32-key tiles (64 KB of Q,
// 2 x 48 KB of K/V); the 256 bucket runs the same way (two warpgroups at
// 232 registers spill).
// Grid fill (plan): at 1024 tokens the hd-40 grid of three warpgroups is
// 6 x 24 = 144 CTAs, 1.09 waves of 132, so short grids take two
// warpgroups (192 CTAs); the hd-512 grid of two slices is 16 x BH x 2 =
// 32-64 CTAs, so short grids take four 128-column slices.
// Not taken: FA3's ping-pong between consumer warpgroups (named barriers
// ordering their wgmma issue, S_{j+1} = Q K^T issued beside P_j V_j, three
// stages): on the card it barely moved hd 40 and spilled at hd 128 and
// 256. The consumer warpgroups overlap as the warp schedulers interleave
// them.
#include <cmath>
#include <type_traits>

#include "sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;
constexpr int kAtom = 64;  // bf16 columns of one 128-byte swizzle atom
constexpr int kSMs = 132;  // H100 SXM

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D (64 x 32, fp32) (+)= A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<48> {
  // D (64 x 48, fp32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<80> {
  // D (64 x 80, fp32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64, fp32) (+)= A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 64, fp32) = A (smem, K-major) * B (smem, K-major): the first
  // k16 step (scale-d false), D written only: its registers hold nothing
  // live before
  static __device__ __forceinline__ void ss_first(float (&d)[32], uint64_t a,
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "r"(0));
  }
};


template <>
struct Wgmma<128> {
  // D (64 x 128, fp32) (+)= A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D (64 x 128, fp32) = A (smem, K-major) * B (smem, K-major): the first
  // k16 step (scale-d false), D written only: its registers hold nothing
  // live before
  static __device__ __forceinline__ void ss_first(float (&d)[64], uint64_t a,
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
          "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
          "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(a), "l"(b), "r"(0));
  }
  // D (64 x 128, fp32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<160> {
  // D (64 x 160, fp32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[80],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  // D (64 x 256, fp32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to the nearest bf16 (ties to even) in fp32: cvt.rn's bits for
// every x but NaN, in integer operations, off the pipe that ex2 and the
// conversions share.
__device__ __forceinline__ float round_bf16_int(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// ---- the plan of one bucket ----

// KD: the Q K^T depth (KD/16 k16 steps); NV: the P V width of one output
// slice; BKV: keys a K/V tile; NC: consumer warpgroups of 64 query rows;
// AH: every head of a query tile in the CTA (T7), Q in two buffers; STASH:
// O parked in shared memory across each max pass (T3's chunks).
template <int KD, int NV, int BKV, int NC, bool AH = false,
          bool STASH = false>
struct Plan {
  static constexpr int kQBufs = AH ? 2 : 1;
  static constexpr int kQRows = 64 * NC;
  static constexpr int kKAtoms = (KD + kAtom - 1) / kAtom;
  static constexpr int kVAtoms = (NV + kAtom - 1) / kAtom;
  static constexpr int kThreads = 128 * (NC + 1);
  // setmaxnreg where NC > 1: the producer's 128 threads give up registers
  // to the consumers' (65,536 a block at one block an SM)
  static constexpr int kProducerRegs = NC == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = NC == 2 ? 232 : 160;
  static_assert(NC == 1 || 128 * (kProducerRegs + NC * kConsumerRegs) <=
                               65536, "registers");
  static constexpr int kQBytes = kQRows * 128 * kKAtoms;
  static constexpr int kKBytes = BKV * 128 * kKAtoms;
  static constexpr int kVBytes = BKV * 128 * kVAtoms;
  static constexpr int kK = kQBufs * kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  // q_full, full_k[kStages], full_v[kStages], empty[kStages], then (AH)
  // q_full of the second Q buffer and q_empty[2]; then (STASH) NV / 2
  // floats a consumer thread, thread-fastest; 1024 bytes of slack align
  // the base for the swizzle
  static constexpr int kBars = 1 + 3 * kStages + (AH ? 3 : 0);
  static constexpr int kStash = kBar + 8 * kBars;
  static constexpr int kSmem =
      kStash + (STASH ? 4 * 128 * NC * (NV / 2) : 0) + 1024;
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(KD % 16 == 0 && NV % 8 == 0 && BKV % 16 == 0, "tiles");
};

struct Sm90Args {
  bf16* out;
  long long o_row, o_batch;  // elements
  int o_head;                // lanes between heads of the output
  int H, Lq, Lk, hd;
  int out_cols;  // columns written a head: hd (K8) or the slot (K13)
  int nslices;   // output slices of NV columns
  float scale_log2;
  float shift;   // kShift, kShiftSplitP: the static shift
  float clamp;   // head-major kShift: s clamped at shift + clamp, 88 or +inf
  float eps;     // and l's epsilon, 1e-30 or 0 (+inf and 0: T2 unclamped)
  int chunk_tiles;  // kChunked: K/V tiles a chunk
};

// The softmax of a pass: online (running max, alpha rescaling); the max
// pass; against the fixed row max (after a max pass over every tile), p =
// bf16(exp2(bf16(s - m))) (K13, T4 with exp2_bf16) or p = exp2(s - m) in
// fp32, the row sum of the unrounded p and bf16(p) into P V (T4 without,
// T1); against the static shift, s clamped at shift + 88, p = exp2(s -
// shift) in fp32, the row sum of the unrounded p + 1e-30, and bf16(p) into
// P V (T2, T5, T7) or p as bf16 hi + lo (T9); T2 without `safe` runs it
// with the clamp +inf and the epsilon 0 (a.clamp, a.eps). T3's: online
// with the max taken per 64-column half of a 128-key tile (kHalves: 64-key
// chunks); the fixed max per chunk of a.chunk_tiles tiles, each after a
// max pass over the chunk (kChunked). kBf16P, or-ed into kOnline, kHalves
// or kChunked (T3's bf16_p) or kShift (T2's): p = bf16(exp2(bf16(s - m))),
// as kFixedMax's, with the shift for m. kGridHeadFastest, or-ed into the
// head-major kShift (T8): the grid's head and query-tile axes swapped.
enum Mode : int {
  kOnline = 0,
  kMaxPass = 1,
  kFixedMax = 2,
  kFixedMaxF32 = 3,
  kShift = 4,
  kShiftSplitP = 5,
  kHalves = 6,
  kChunked = 7,
  kBf16P = 8,
  kGridHeadFastest = 16
};

// The max policy of a mode, p's precision and the grid's order apart.
__host__ __device__ constexpr int policy_of(int mode) {
  return mode & ~(kBf16P | kGridHeadFastest);
}
// p = bf16(exp2(bf16(s - m))), l the sum of those p.
__host__ __device__ constexpr bool bf16_p_of(int mode) {
  return mode == kFixedMax || (mode & kBf16P) != 0;
}

// S = Q K^T for one warpgroup: qa its Q rows, kt the K tile. FRESH: the
// first step writes S without reading it, so S's old values are dead
// between tiles (T3's chunks, whose loop would otherwise keep them).
template <int KD, int BKV, int NC, bool FRESH = false>
__device__ __forceinline__ void qk(float (&s)[BKV / 2], uint32_t qa,
                                   uint32_t kt) {
  wg_fence();
  if constexpr (FRESH) Wgmma<BKV>::ss_first(s, desc128(qa, 16),
                                            desc128(kt, 16));
#pragma unroll
  for (int kk = FRESH ? 1 : 0; kk < KD / 16; ++kk) {
    const uint32_t atom = kk / 4, step = (kk % 4) * 32;
    Wgmma<BKV>::ss(s, desc128(qa + atom * (64 * NC * 128) + step, 16),
                   desc128(kt + atom * (BKV * 128) + step, 16), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// O += P V for one warpgroup: vt the V tile (key rows, MN-major); the k16
// steps K0 .. K0 + NK - 1 of the tile. pv_issue leaves the products in
// flight (O and those steps of P untouchable) until pv_wait.
template <int NV, int BKV, int K0 = 0, int NK = BKV / 16>
__device__ __forceinline__ void pv_issue(float (&o)[NV / 2],
                                         uint32_t (&p)[BKV / 16][4],
                                         uint32_t vt) {
  wg_fence();
#pragma unroll
  for (int t = K0; t < K0 + NK; ++t)
    Wgmma<NV>::rs(o, p[t], desc128(vt + t * 16 * 128, BKV * 128), 1);
  wg_commit();
}
template <int NV, int BKV, int K0 = 0, int NK = BKV / 16>
__device__ __forceinline__ void pv_wait(float (&o)[NV / 2],
                                        uint32_t (&p)[BKV / 16][4]) {
  wg_wait_all();
  fence_regs(o);
#pragma unroll
  for (int t = K0; t < K0 + NK; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[t][r])::"memory");
}
template <int NV, int BKV>
__device__ __forceinline__ void pv(float (&o)[NV / 2],
                                   uint32_t (&p)[BKV / 16][4], uint32_t vt) {
  pv_issue<NV, BKV>(o, p, vt);
  pv_wait<NV, BKV>(o, p);
}

// O's rows r0 and r0 + 8 times a0 and a1.
template <int N>
__device__ __forceinline__ void scale(float (&o)[N], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i] *= a0;
    o[4 * i + 1] *= a0;
    o[4 * i + 2] *= a1;
    o[4 * i + 3] *= a1;
  }
}

// The softmax against a running (OWN) or fixed max of S's 8-column groups
// I0 .. I0 + G - 1 (a thread's rows r0 and r0 + 8: m0, l0 and m1, l1),
// packed into P's k16 steps I0 / 2 .. (I0 + G) / 2 - 1. OWN: the groups'
// max first, l and (SCALE_O; else the caller, once O is out of flight) O
// rescaled by alpha = exp2(m - m_new). p = exp2(s - m) in fp32, or
// bf16(exp2(bf16(s - m))) (BF16P); l adds the p.
template <int I0, int G, bool OWN, bool BF16P, bool SCALE_O, int NV, int BKV>
__device__ __forceinline__ void softmax_part(float (&s)[BKV / 2],
                                             uint32_t (&pa)[BKV / 16][4],
                                             float (&o)[NV / 2], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  float sum0 = 0.0f, sum1 = 0.0f;
  if constexpr (OWN) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = I0; i < I0 + G; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile holds a real key, so mx is finite; ex2(-inf) and
    // ex2(-1e30 - mx) are 0
    alpha0 = ex2(m0 - mx0);
    alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
  }
  if constexpr (BF16P) {
#pragma unroll
    for (int i = I0; i < I0 + G; ++i) {
      s[4 * i] = round_bf16(ex2(round_bf16(s[4 * i] - m0)));
      s[4 * i + 1] = round_bf16(ex2(round_bf16(s[4 * i + 1] - m0)));
      s[4 * i + 2] = round_bf16(ex2(round_bf16(s[4 * i + 2] - m1)));
      s[4 * i + 3] = round_bf16(ex2(round_bf16(s[4 * i + 3] - m1)));
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
  } else {
    // the sum of the fp32 p; pack_bf16 rounds them for P V
#pragma unroll
    for (int i = I0; i < I0 + G; ++i) {
      s[4 * i] = ex2(s[4 * i] - m0);
      s[4 * i + 1] = ex2(s[4 * i + 1] - m0);
      s[4 * i + 2] = ex2(s[4 * i + 2] - m1);
      s[4 * i + 3] = ex2(s[4 * i + 3] - m1);
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
  }
  if constexpr (OWN) {
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    if constexpr (SCALE_O) scale(o, alpha0, alpha1);
  } else {
    l0 += sum0;
    l1 += sum1;
  }
#pragma unroll
  for (int k = I0 / 2; k < (I0 + G) / 2; ++k) {
    pa[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
    pa[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
    pa[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
    pa[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
  }
}

// O += P V with P = hi + lo, two bf16 parts of the fp32 p: two wgmmas a k16
// step into the one accumulator.
template <int NV, int BKV>
__device__ __forceinline__ void pv_split(float (&o)[NV / 2],
                                         uint32_t (&hi)[BKV / 16][4],
                                         uint32_t (&lo)[BKV / 16][4],
                                         uint32_t vt) {
  wg_fence();
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t) {
    const uint64_t d = desc128(vt + t * 16 * 128, BKV * 128);
    Wgmma<NV>::rs(o, hi[t], d, 1);
    Wgmma<NV>::rs(o, lo[t], d, 1);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(o);
  fence_regs(hi);
  fence_regs(lo);
}

// LAST: the softmax of the last pass, kOnline, kHalves, kShift (each with
// kBf16P or not) or kShiftSplitP for one pass; kFixedMax or kFixedMaxF32
// after a max pass over every tile (one chunk), kChunked (with kBf16P or
// not) the same per chunk of a.chunk_tiles tiles. AH: every head of the
// query tile in this CTA, in turn. kGridHeadFastest in LAST: the head in
// blockIdx.x and the query tile in blockIdx.y.
template <int KD, int NV, int BKV, int NC, int LAST, bool AH = false>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
attn_sm90(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const Sm90Args a) {
  constexpr bool MULTI = policy_of(LAST) == kChunked;
  constexpr bool CHUNKED = MULTI || LAST == kFixedMax || LAST == kFixedMaxF32;
  using P = Plan<KD, NV, BKV, NC, AH, MULTI>;
  constexpr int NQ = P::kQBufs;
  constexpr bool SHIFT = policy_of(LAST) == kShift || LAST == kShiftSplitP;
  static_assert(!AH || policy_of(LAST) == kShift,
                "the all-heads grid is T7's");
  constexpr bool HF = (LAST & kGridHeadFastest) != 0;
  static_assert(!HF || (!AH && policy_of(LAST) == kShift),
                "the head-fastest grid is T8's");
  // The head-major kShift (T2, T5, T6; T8 on its grid) reads its clamp
  // above the shift and its epsilon from a.clamp and a.eps, so that T2's
  // safe and unclamped forms share one instantiation; T7 and T9 keep the
  // constants 88 and 1e-30, their code unchanged: read from the fields,
  // ptxas scheduled them anew and T7 or T9 ran 2-4% slower at L0 on the
  // card (PERF.md)
  constexpr bool FIELDS = policy_of(LAST) == kShift && !AH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + P::kK, sV = base + P::kV;
  const uint32_t q_full = base + P::kBar;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  // Q buffer qb's barriers: full (the first is q_full) and, with AH, empty
  // (released by lane 0 of each consumer warp after its head's stores)
  auto q_full_of = [&](int qb) {
    return qb == 0 ? q_full : q_full + 8 * (3 * kStages + qb);
  };
  auto q_empty = [&](int qb) {
    return q_full + 8 * (3 * kStages + NQ + qb);
  };

  const int q0 = (HF ? blockIdx.y : blockIdx.x) * P::kQRows;
  // the heads this CTA computes: all of them in turn (AH), else blockIdx.y
  // (blockIdx.x on the head-fastest grid)
  const int nheads = AH ? a.H : 1;
  auto head = [&](int hi) {
    return AH ? hi : static_cast<int>(HF ? blockIdx.x : blockIdx.y);
  };
  const int b = blockIdx.z / a.nslices, slice = blockIdx.z % a.nslices;
  const int ntiles = (a.Lk + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NC * 4);  // lane 0 of each consumer warp
    }
    if constexpr (AH) {
      for (int qb = 1; qb < NQ; ++qb) mbar_init(q_full_of(qb), 1);
      for (int qb = 0; qb < NQ; ++qb) mbar_init(q_empty(qb), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                       P::kProducerRegs)
                   : "memory");
    if (threadIdx.x == 0) {
      // Q of the hi-th head into buffer hi % NQ, once the consumers have
      // stored the head that used the buffer before
      auto load_q = [&](int hi) {
        const int qb = hi % NQ;
        if (hi >= NQ) mbar_wait(q_empty(qb), ((hi / NQ) - 1) & 1);
        mbar_expect_tx(q_full_of(qb), P::kQBytes);
#pragma unroll 1
        for (int c = 0; c < P::kKAtoms; ++c)
          tma_load(sQ + qb * P::kQBytes + c * P::kQRows * 128, &tq,
                   q_full_of(qb), c * kAtom, head(hi), q0, b);
      };
      // one head: Q first. All heads: the first NQ - 1 heads' Q, then each
      // head's first kStages tiles go out before the Q of the head NQ - 1
      // later, whose wait for its buffer would hold them back
      if constexpr (!AH) {
        load_q(0);
      } else {
        for (int hi = 0; hi + 1 < NQ && hi < nheads; ++hi) load_q(hi);
      }
      const int pre = min(kStages, ntiles);
      int it = 0;
      // tile j of head h into the next stage, for the chunked modes: K,
      // and V unless a max pass reads the stage (then an arrival without a
      // copy). The one-pass modes keep their own loop below: through this
      // lambda K8 ran 2% slower at L0 on the card (PERF.md).
      auto load_kv = [&](int h, int j, bool with_v) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k(s), P::kKBytes);
#pragma unroll 1
        for (int c = 0; c < P::kKAtoms; ++c)
          tma_load(sK + s * P::kKBytes + c * BKV * 128, &tk, full_k(s),
                   c * kAtom, h, j * BKV, b);
        if (with_v) {
          mbar_expect_tx(full_v(s), P::kVBytes);
#pragma unroll 1
          for (int c = 0; c < P::kVAtoms; ++c)
            tma_load(sV + s * P::kVBytes + c * BKV * 128, &tv, full_v(s),
                     slice * NV + c * kAtom, h, j * BKV, b);
        } else {
          mbar_arrive(full_v(s));
        }
        ++it;
      };
#pragma unroll 1
      for (int hi = 0; hi < nheads; ++hi) {
        const int h = head(hi);
        if constexpr (CHUNKED) {
          // per chunk: its K tiles for the max pass, then its K and V tiles
          const int ct = MULTI ? a.chunk_tiles : ntiles;
#pragma unroll 1
          for (int c0 = 0; c0 < ntiles; c0 += ct) {
            const int c1 = min(c0 + ct, ntiles);
#pragma unroll 1
            for (int pass = 0; pass < 2; ++pass)
#pragma unroll 1
              for (int j = c0; j < c1; ++j) load_kv(h, j, pass == 1);
          }
        } else {
#pragma unroll 1
          for (int j = 0; j < ntiles; ++j, ++it) {
            const int s = it % kStages;
            mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full_k(s), P::kKBytes);
#pragma unroll 1
            for (int c = 0; c < P::kKAtoms; ++c)
              tma_load(sK + s * P::kKBytes + c * BKV * 128, &tk, full_k(s),
                       c * kAtom, h, j * BKV, b);
            mbar_expect_tx(full_v(s), P::kVBytes);
#pragma unroll 1
            for (int c = 0; c < P::kVAtoms; ++c)
              tma_load(sV + s * P::kVBytes + c * BKV * 128, &tv,
                       full_v(s), slice * NV + c * kAtom, h, j * BKV, b);
            if constexpr (AH)
              if (j == pre - 1 && hi + NQ - 1 < nheads) load_q(hi + NQ - 1);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                       P::kConsumerRegs)
                   : "memory");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int r0 = 16 * warp + g;  // this thread's rows: r0 and r0 + 8
    int it = 0;

#pragma unroll 1
    for (int hi = 0; hi < nheads; ++hi) {
      const int h = head(hi);
      const int qb = hi % NQ;
      const uint32_t qbuf = qb * P::kQBytes;

      // Q: scale this warpgroup's rows by scale*log2(e), round to bf16
      mbar_wait(q_full_of(qb), (hi / NQ) & 1);
#pragma unroll 1
      for (int i = t; i < 64 * 8 * P::kKAtoms; i += 128) {
        const int c = i / 512, rem = i % 512;
        uint4* p = reinterpret_cast<uint4*>(gbase + qbuf + c * P::kQRows *
                                            128 + wg * 64 * 128 + rem * 16);
        uint4 v = *p;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.scale_log2);
        *p = v;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);

      const uint32_t qa = sQ + qbuf + wg * 64 * 128;
      float o[NV / 2];
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) o[i] = 0.0f;
      float s[BKV / 2];
      uint32_t pa[BKV / 16][4];
      // kShiftSplitP: the lo parts of p (pa holds the hi parts); unused,
      // and so not allocated, by the other modes
      uint32_t pl[BKV / 16][4];
      // the running max: kOnline's (K8/K2's) from -inf, the others' from
      // -1e30 (the TPU T3 kernel's start); both give exp2 0 at the first
      // tile
      float m0 = LAST == kOnline ? -INFINITY : -1e30f, m1 = m0;
      float l0 = 0.0f, l1 = 0.0f;

      // One K/V tile: S = Q K^T, then the mode's softmax, then (but in the
      // max pass) O += P V; the empty barrier is released after the last
      // product that reads the stage. OWN (kOnline, the halves): the tile's own max first, l and O rescaled by exp2(m -
      // m_new), then p; the halves take it per 64-column half of S.
      auto tile = [&](auto mode_tag, auto mask_tag, int j) {
        constexpr int MODE = decltype(mode_tag)::value;
        constexpr bool MASK = decltype(mask_tag)::value;
        // the halves serve Lk a multiple of 64: a ragged tile is one real
        // half, whose max is the masked tile's, so it takes the whole tile
        constexpr bool HALF = policy_of(MODE) == kHalves;
        constexpr int HALVES = HALF && !MASK ? 2 : 1;
        constexpr bool OWN = policy_of(MODE) == kOnline || HALF;
        constexpr bool BF16P = bf16_p_of(MODE);
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(full_k(st), ph);
        qk<KD, BKV, NC, MULTI>(s, qa, sK + st * P::kKBytes);
        if constexpr (MASK) {
          const int lim = a.Lk - j * BKV - 2 * tq4;
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            if (8 * (i / 4) + (i & 1) >= lim) s[i] = -INFINITY;
        }
        if constexpr (MODE == kMaxPass) {
          // this thread's row maxima; the quad reduction waits for the
          // pass's end
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            m0 = fmaxf(m0, fmaxf(s[4 * i], s[4 * i + 1]));
            m1 = fmaxf(m1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
          }
        } else if constexpr (policy_of(MODE) == kShift ||
                             MODE == kShiftSplitP) {
          // one pass, no max; a masked -inf gives ex2(-inf) = 0. At the
          // clamp (shift + 88) p reaches 2^88, so l stays below 2^103 over
          // 16384 keys; unclamped (a.clamp +inf) s - shift above 128 gives
          // p = +inf, l = +inf and a NaN row, as on the TPU
          float sum0 = 0.0f, sum1 = 0.0f;
          const float cap = a.shift + (FIELDS ? a.clamp : 88.0f);
          if constexpr (BF16P) {
            // T2's bf16 p: exp2 of the difference rounded in integer
            // operations, rounded two at a time by cvt into P V's operand
            // and unpacked for the sum (both roundings by cvt, one value
            // at a time, cost T2 twice its fp32-p time on the card;
            // PERF.md)
#pragma unroll
            for (int k = 0; k < BKV / 16; ++k)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float x = ex2(round_bf16_int(
                    fminf(s[8 * k + 2 * r], cap) - a.shift));
                const float y = ex2(round_bf16_int(
                    fminf(s[8 * k + 2 * r + 1], cap) - a.shift));
                const uint32_t h2 = pack_bf16(x, y);
                pa[k][r] = h2;
                s[8 * k + 2 * r] = __uint_as_float(h2 << 16);
                s[8 * k + 2 * r + 1] = __uint_as_float(h2 & 0xffff0000u);
              }
          } else {
#pragma unroll
            for (int i = 0; i < BKV / 2; ++i)
              s[i] = ex2(fminf(s[i], cap) - a.shift);
          }
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            sum0 += s[4 * i] + s[4 * i + 1];
            sum1 += s[4 * i + 2] + s[4 * i + 3];
          }
          l0 += sum0;
          l1 += sum1;
          if constexpr (MODE == kShiftSplitP) {
            // hi = bf16(p) and lo = bf16(p - hi), a pair at a time
#pragma unroll
            for (int k = 0; k < BKV / 16; ++k)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float x = s[8 * k + 2 * r], y = s[8 * k + 2 * r + 1];
                const uint32_t h2 = pack_bf16(x, y);
                pa[k][r] = h2;
                pl[k][r] = pack_bf16(x - __uint_as_float(h2 << 16),
                                     y - __uint_as_float(h2 & 0xffff0000u));
              }
          } else if constexpr (!BF16P) {
#pragma unroll
            for (int k = 0; k < BKV / 16; ++k) {
              pa[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
              pa[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
              pa[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
              pa[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
            }
          }
          mbar_wait(full_v(st), ph);
          if constexpr (MODE == kShiftSplitP)
            pv_split<NV, BKV>(o, pa, pl, sV + st * P::kVBytes);
          else
            pv<NV, BKV>(o, pa, sV + st * P::kVBytes);
        } else {
          // against a running or fixed max, over the tile or (the halves)
          // each 64-column half: G 8-column groups, KH k16 steps
          // (the halves: the second half's softmax beside the first
          // half's products, its rescale of O after them)
          constexpr int G = BKV / 8 / HALVES, KH = BKV / 16 / HALVES;
          const uint32_t vt = sV + st * P::kVBytes;
          float a0, a1;
          softmax_part<0, G, OWN, BF16P, true, NV, BKV>(s, pa, o, m0, m1,
                                                         l0, l1, a0, a1);
          mbar_wait(full_v(st), ph);
          pv_issue<NV, BKV, 0, KH>(o, pa, vt);
          if constexpr (HALVES == 2) {
            softmax_part<G, G, OWN, BF16P, false, NV, BKV>(s, pa, o, m0, m1,
                                                           l0, l1, a0, a1);
            pv_wait<NV, BKV, 0, KH>(o, pa);
            scale(o, a0, a1);
            pv_issue<NV, BKV, KH, KH>(o, pa, vt);
            pv_wait<NV, BKV, KH, KH>(o, pa);
          } else {
            pv_wait<NV, BKV>(o, pa);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
        ++it;
      };
      // Tiles j0 .. j1 - 1: the full ones, then the ragged tail masked.
      auto span = [&](auto mode_tag, int j0, int j1) {
        const int full = min(j1, a.Lk / BKV);
#pragma unroll 1
        for (int j = j0; j < full; ++j) tile(mode_tag, std::false_type{}, j);
        if (full < j1) tile(mode_tag, std::true_type{}, full);
      };
      constexpr auto last = std::integral_constant<int, LAST>{};
      if constexpr (CHUNKED) {
        // per chunk of ct tiles (one chunk of every tile but for T3's
        // chunks): the max pass, the rescale, the fixed max. Across a max
        // pass of T3's, O waits in shared memory (STASH), its registers
        // free for S
        const int ct = MULTI ? a.chunk_tiles : ntiles;
        float* const stash = reinterpret_cast<float*>(gbase + P::kStash) +
                             wg * 128 + t;
#pragma unroll 1
        for (int c0 = 0; c0 < ntiles; c0 += ct) {
          const int c1 = min(c0 + ct, ntiles);
          const float mo0 = m0, mo1 = m1;
          if constexpr (MULTI) {
#pragma unroll
            for (int i = 0; i < NV / 2; ++i) stash[i * 128 * NC] = o[i];
          }
          span(std::integral_constant<int, kMaxPass>{}, c0, c1);
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          }
          if constexpr (MULTI) {
#pragma unroll
            for (int i = 0; i < NV / 2; ++i) o[i] = stash[i * 128 * NC];
          }
          if (c0 > 0) {
            // the first chunk has nothing to rescale
            const float corr0 = ex2(mo0 - m0), corr1 = ex2(mo1 - m1);
            l0 *= corr0;
            l1 *= corr1;
            scale(o, corr0, corr1);
          }
          span(last, c0, c1);
        }
      } else {
        // one pass over the keys: the full tiles, then the ragged tail
        const int full = a.Lk / BKV;
#pragma unroll 1
        for (int j = 0; j < full; ++j) tile(last, std::false_type{}, j);
        if (full < ntiles) tile(last, std::true_type{}, full);
      }

      // ---- epilogue: O / l to bf16, staged in this warpgroup's Q rows ----
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      if constexpr (SHIFT) {
        // with every p 0 (all logits below shift - 126), O / 1e-30 = 0;
        // unclamped, a.eps is 0 and such a row 0 / 0, as on the TPU
        const float eps = FIELDS ? a.eps : 1e-30f;
        l0 += eps;
        l1 += eps;
      }
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      uint8_t* const stage = gbase + qbuf + wg * 64 * 128;
#pragma unroll
      for (int i = 0; i < NV / 8; ++i) {
        uint8_t* atom = stage + (i / 8) * P::kQRows * 128;
        const int chunk = ((i % 8) ^ g) * 16 + 4 * tq4;
        *reinterpret_cast<uint32_t*>(atom + r0 * 128 + chunk) =
            pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        *reinterpret_cast<uint32_t*>(atom + (r0 + 8) * 128 + chunk) =
            pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      bar_sync(1 + wg, 128);
      const int col0 = slice * NV;
      const int ncols =
          min(a.out_cols - col0, a.nslices > 1 ? NV : a.out_cols);
      const int chunks = (ncols + 7) / 8;
      bf16* const ob = a.out + b * a.o_batch +
                       static_cast<long long>(h) * a.o_head + col0;
#pragma unroll 1
      for (int i = t; i < 64 * chunks; i += 128) {
        const int r = i / chunks, c = i % chunks;
        const int row = q0 + wg * 64 + r;
        if (row >= a.Lq) continue;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (8 * c < NV)
          v = *reinterpret_cast<const uint4*>(
              stage + (c / 8) * P::kQRows * 128 + r * 128 +
              ((c % 8) ^ (r & 7)) * 16);
        *reinterpret_cast<uint4*>(ob + row * a.o_row + 8 * c) = v;
      }
      if constexpr (AH) {
        // this warp's reads of the staged rows are done: the buffer may
        // take a later head's Q (TMA writes through the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty(qb));
      }
    }
  }
}

// ---- host side ----

// An operand as TMA reads it: hd lanes innermost (columns past hd are
// zero-filled), then H heads `head` elements apart, L rows, B images;
// boxes of one 64-column atom by `rows` rows, 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* base, int hd, int H, int L,
                int B, long long head, long long row, long long batch,
                int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(head * 2),
                                 static_cast<cuuint64_t>(row * 2),
                                 static_cast<cuuint64_t>(batch * 2)};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, base, dims, strides, box, unit);
}

// What TMA needs of an operand: a 16-byte-aligned base and strides in
// whole 16 bytes (ops/attention.py tma_describable raises before this).
bool describable(const void* p, long long head, long long row,
                 long long batch) {
  return aligned16(p) && head % 8 == 0 && row % 8 == 0 && batch % 8 == 0 &&
         head > 0 && row > 0 && batch > 0;
}

// The kernel's instantiations, {KD, NV, BKV, NC} (mirrored by
// ops/attention.py SM90_BUCKETS). Head dims round up into 48, 80, 128,
// 160, 256 and 512; 1 and 7 are the 48 and 512 buckets for grids that
// would leave the card short of work (see plan).
constexpr int kBuckets[][4] = {{48, 48, 128, 3},  {48, 48, 128, 2},
                               {80, 80, 128, 2},  {128, 128, 128, 2},
                               {160, 160, 64, 2}, {256, 256, 32, 1},
                               {512, 256, 32, 1}, {512, 128, 32, 1}};
constexpr int kNumBuckets = sizeof(kBuckets) / sizeof(kBuckets[0]);

// The bucket of head dim hd for lq query rows and bh (image, head) pairs
// (mirrored by ops/attention.py sm90_bucket): at hd <= 48 two consumer
// warpgroups instead of three where three would give less than two waves
// of blocks; above 256, four 128-column output slices instead of two
// where two would give less than one wave.
int plan(int hd, int lq, int bh) {
  if (hd <= 48)
    return static_cast<long long>((lq + 191) / 192) * bh < 2 * kSMs ? 1 : 0;
  if (hd <= 80) return 2;
  if (hd <= 128) return 3;
  if (hd <= 160) return 4;
  if (hd <= 256) return 5;
  return static_cast<long long>((lq + 63) / 64) * bh * 2 < kSMs ? 7 : 6;
}

template <int KD, int NV, int BKV, int NC>
int smem_of() {
  return Plan<KD, NV, BKV, NC>::kSmem;
}

int bucket_smem(int i) {
  switch (i) {
    case 0: return smem_of<48, 48, 128, 3>();
    case 1: return smem_of<48, 48, 128, 2>();
    case 2: return smem_of<80, 80, 128, 2>();
    case 3: return smem_of<128, 128, 128, 2>();
    case 4: return smem_of<160, 160, 64, 2>();
    case 5: return smem_of<256, 256, 32, 1>();
    case 6: return smem_of<512, 256, 32, 1>();
    default: return smem_of<512, 128, 32, 1>();
  }
}

// The grid: (query tile, head, image x slice), with AH (query tile, 1,
// image), the CTA looping over the heads, or with kGridHeadFastest in LAST
// (head, query tile, image).
template <int KD, int NV, int BKV, int NC, int LAST, bool AH = false>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Sm90Args& a, int B,
                   cudaStream_t stream) {
  using P = Plan<KD, NV, BKV, NC, AH, policy_of(LAST) == kChunked>;
  auto kern = attn_sm90<KD, NV, BKV, NC, LAST, AH>;
  const unsigned tiles = (a.Lq + P::kQRows - 1) / P::kQRows;
  constexpr bool HF = (LAST & kGridHeadFastest) != 0;
  if (HF && tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid = HF ? dim3(a.H, tiles, B * a.nslices)
                       : dim3(tiles, AH ? 1 : a.H, B * a.nslices);
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// The buckets of hd <= 160 (one output slice) with the last pass's softmax
// LAST: the chunked modes, and the head-major one pass (kShiftSplitP,
// kShift with kBf16P, kGridHeadFastest or neither).
template <int LAST>
cudaError_t launch_two_pass(int bucket, const CUtensorMap& tq,
                            const CUtensorMap& tk, const CUtensorMap& tv,
                            const Sm90Args& a, int B, cudaStream_t stream) {
  switch (bucket) {
    case 0: return launch<48, 48, 128, 3, LAST>(tq, tk, tv, a, B, stream);
    case 1: return launch<48, 48, 128, 2, LAST>(tq, tk, tv, a, B, stream);
    case 2: return launch<80, 80, 128, 2, LAST>(tq, tk, tv, a, B, stream);
    case 3: return launch<128, 128, 128, 2, LAST>(tq, tk, tv, a, B, stream);
    default: return launch<160, 160, 64, 2, LAST>(tq, tk, tv, a, B, stream);
  }
}

// T3 at 64-key chunks under a 128-key tile at hd <= 80 (buckets 0-2): the
// halves, LAST kHalves with or without kBf16P. At hd 81..128 (bucket 3) the
// halves' registers run out (ptxas serializes their wgmmas and spills):
// run() takes the bucket on 64-key tiles there, online.
template <int LAST>
cudaError_t launch_halves(int bucket, const CUtensorMap& tq,
                          const CUtensorMap& tk, const CUtensorMap& tv,
                          const Sm90Args& a, int B, cudaStream_t stream) {
  switch (bucket) {
    case 0: return launch<48, 48, 128, 3, LAST>(tq, tk, tv, a, B, stream);
    case 1: return launch<48, 48, 128, 2, LAST>(tq, tk, tv, a, B, stream);
    default: return launch<80, 80, 128, 2, LAST>(tq, tk, tv, a, B, stream);
  }
}

// The tensor maps of q (boxes of qrows rows), k and v (bkv rows), strides
// in elements: q rows q_row apart, images q_batch apart; k and v rows
// kv_row apart, images kv_batch apart; heads `head` apart. False where TMA
// cannot describe an operand or out is not 16-byte aligned.
bool maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv, const void* q,
          const void* k, const void* v, const Sm90Args& a, int B,
          long long head, long long q_row, long long q_batch,
          long long kv_row, long long kv_batch, int qrows, int bkv) {
  // a stride over a dimension of one is never stepped: any valid value
  if (a.Lq == 1) q_row = a.H * head;
  if (a.Lk == 1) kv_row = a.H * head;
  if (B == 1) q_batch = a.Lq * q_row, kv_batch = a.Lk * kv_row;
  return describable(q, head, q_row, q_batch) &&
         describable(k, head, kv_row, kv_batch) &&
         describable(v, head, kv_row, kv_batch) && aligned16(a.out) &&
         tensor_map(tq, q, a.hd, a.H, a.Lq, B, head, q_row, q_batch,
                    qrows) &&
         tensor_map(tk, k, a.hd, a.H, a.Lk, B, head, kv_row, kv_batch,
                    bkv) &&
         tensor_map(tv, v, a.hd, a.H, a.Lk, B, head, kv_row, kv_batch, bkv);
}

// Strides in elements: q (and out) rows q_row apart, images q_batch apart;
// k and v rows kv_row apart, images kv_batch apart; heads `head` apart.
// `bucket` indexes kBuckets (-1: plan's). `last`: the softmax of the last
// pass (Mode); every mode but kOnline (two_pass: K13's two passes were the
// first) takes the buckets of hd <= 160 only (one output slice), the halves
// those of 128-key tiles at hd <= 80 and Lk a multiple of 64.
// `chunk_tiles`: kChunked's tiles a chunk (0: one chunk of every tile).
// `narrow`: bucket 3 on 64-key tiles (online).
cudaError_t run(const void* q, const void* k, const void* v, Sm90Args a,
                int B, long long head, long long q_row, long long q_batch,
                long long kv_row, long long kv_batch, int last, int bucket,
                cudaStream_t stream, int chunk_tiles = 0,
                bool narrow = false) {
  const bool two_pass = last != kOnline;
  const int policy = policy_of(last);
  const bool bf16_p = (last & kBf16P) != 0;
  const bool halves = policy == kHalves;
  if (B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.hd <= 0 ||
      a.hd > 512 || (two_pass && a.hd > 160) || B > 65535 ||
      a.H > 65535 || chunk_tiles < 0 ||
      !(last == kFixedMax || last == kFixedMaxF32 || policy == kOnline ||
        halves || policy == kChunked) ||
      (narrow && policy != kOnline))
    return cudaErrorInvalidValue;
  if (bucket < 0) bucket = plan(a.hd, a.Lq, B * a.H);
  if (bucket >= kNumBuckets || kBuckets[bucket][0] < a.hd ||
      (two_pass && bucket > 4) || (halves && (bucket > 2 || a.Lk % 64)) ||
      (narrow && bucket != 3))
    return cudaErrorInvalidValue;
  const int nv = kBuckets[bucket][1];
  const int bkv = narrow ? 64 : kBuckets[bucket][2];
  const int nc = kBuckets[bucket][3];
  a.nslices = (a.hd + nv - 1) / nv;
  a.chunk_tiles = chunk_tiles ? chunk_tiles : (a.Lk + bkv - 1) / bkv;
  if (B * a.nslices > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!maps(&tq, &tk, &tv, q, k, v, a, B, head, q_row, q_batch, kv_row,
            kv_batch, 64 * nc, bkv))
    return cudaErrorInvalidValue;
  if (narrow)
    return bf16_p
               ? launch<128, 128, 64, 2, kOnline | kBf16P>(tq, tk, tv, a, B,
                                                           stream)
               : launch<128, 128, 64, 2, kOnline>(tq, tk, tv, a, B, stream);
  if (halves)
    return bf16_p ? launch_halves<kHalves | kBf16P>(bucket, tq, tk, tv, a, B,
                                                    stream)
                  : launch_halves<kHalves>(bucket, tq, tk, tv, a, B, stream);
  if (policy == kChunked)
    return bf16_p ? launch_two_pass<kChunked | kBf16P>(bucket, tq, tk, tv, a,
                                                       B, stream)
                  : launch_two_pass<kChunked>(bucket, tq, tk, tv, a, B,
                                              stream);
  if (bf16_p)
    return launch_two_pass<kOnline | kBf16P>(bucket, tq, tk, tv, a, B,
                                             stream);
  if (last == kFixedMax)
    return launch_two_pass<kFixedMax>(bucket, tq, tk, tv, a, B, stream);
  if (last == kFixedMaxF32)
    return launch_two_pass<kFixedMaxF32>(bucket, tq, tk, tv, a, B, stream);
  switch (bucket) {
    case 0: return launch<48, 48, 128, 3, kOnline>(tq, tk, tv, a, B, stream);
    case 1: return launch<48, 48, 128, 2, kOnline>(tq, tk, tv, a, B, stream);
    case 2: return launch<80, 80, 128, 2, kOnline>(tq, tk, tv, a, B, stream);
    case 3:
      return launch<128, 128, 128, 2, kOnline>(tq, tk, tv, a, B, stream);
    case 4:
      return launch<160, 160, 64, 2, kOnline>(tq, tk, tv, a, B, stream);
    case 5: return launch<256, 256, 32, 1, kOnline>(tq, tk, tv, a, B, stream);
    case 6: return launch<512, 256, 32, 1, kOnline>(tq, tk, tv, a, B, stream);
    default:
      return launch<512, 128, 32, 1, kOnline>(tq, tk, tv, a, B, stream);
  }
}

// K2 and K8 on the (B, L, H*hd) projections.
cudaError_t run_projections(const void* q, const void* k, const void* v,
                            void* out, int B, int H, int Lq, int Lk, int hd,
                            float scale_log2, int bucket,
                            cudaStream_t stream) {
  Sm90Args a{};
  a.out = static_cast<bf16*>(out);
  const long long D = static_cast<long long>(H) * hd;
  a.o_row = D, a.o_batch = Lq * D, a.o_head = hd;
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.out_cols = hd;
  a.scale_log2 = scale_log2;
  return run(q, k, v, a, B, hd, D, Lq * D, D, Lk * D, kOnline, bucket,
             stream);
}

// T3's launch (mirrored by ops/attention_variants.py chunked_sm90_plan):
// K2's bucket for hd <= 160; chunks of bk keys: bk = lk (one chunk of every
// tile, the ragged last one masked), a multiple of the bucket's BKV that
// divides lk, or 64 under a 128-key tile (lk a multiple of 64: the halves
// at hd <= 80, bucket 3 on 64-key tiles at hd 81..128, where the halves
// run out of registers; the L0 times of both designs at hd <= 80 are in
// PERF.md). `last`: a chunk of several tiles takes a max pass then the
// fixed max (`passes` 2), a chunk of one tile the tile's own max (kOnline
// with fp32 p: K8/K2's own launch); kBf16P with bf16_p. False where
// refused.
struct ChunkPlan {
  int bucket, bkv, chunk_tiles, passes, last;
  bool narrow;
};

bool chunk_plan(int hd, int lq, int bh, int lk, int bk, bool bf16_p,
                ChunkPlan* p) {
  if (hd <= 0 || hd > 160 || lq <= 0 || bh <= 0 || lk <= 0 || bk <= 0)
    return false;
  p->bucket = plan(hd, lq, bh);
  p->bkv = kBuckets[p->bucket][2];
  p->narrow = false;
  bool halves = false;
  if (bk == lk) {
    p->chunk_tiles = (lk + p->bkv - 1) / p->bkv;
  } else if (bk % p->bkv == 0 && lk % bk == 0) {
    p->chunk_tiles = bk / p->bkv;
  } else if (bk == 64 && p->bkv == 128 && lk % 64 == 0) {
    p->chunk_tiles = 1;
    p->narrow = p->bucket == 3;
    halves = !p->narrow;
    if (p->narrow) p->bkv = 64;
  } else {
    return false;
  }
  p->passes = p->chunk_tiles > 1 ? 2 : 1;
  p->last = (halves ? kHalves : p->chunk_tiles > 1 ? kChunked : kOnline) |
            (bf16_p ? kBf16P : 0);
  return true;
}

int chunk_smem(const ChunkPlan& p) {
  // a chunk of several tiles parks O across each max pass (Plan's STASH)
  const int* b = kBuckets[p.bucket];
  if (p.passes == 2)
    return bucket_smem(p.bucket) + 4 * 128 * b[3] * (b[1] / 2);
  return p.narrow ? smem_of<128, 128, 64, 2>() : bucket_smem(p.bucket);
}

// T7's consumer warpgroups for head dim hd, lq query rows and B images on
// its all-heads grid of B * ceil(lq / (64 nc)) CTAs (mirrored by
// ops/attention_variants.py allheads_sm90_plan): the fewest waves of CTAs
// over the SMs, ties to fewer warpgroups (the same waves on more SMs); nc
// 1..3 at hd <= 48 (the 48 bucket's setmaxnreg budget), 1..2 above.
int allheads_consumers(int hd, int lq, int B) {
  const int most = hd <= 48 ? 3 : 2;
  int best = 1;
  long long best_waves = -1;
  for (int nc = 1; nc <= most; ++nc) {
    const long long ctas =
        static_cast<long long>((lq + 64 * nc - 1) / (64 * nc)) * B;
    const long long waves = (ctas + kSMs - 1) / kSMs;
    if (best_waves < 0 || waves < best_waves) best = nc, best_waves = waves;
  }
  return best;
}

// T7's bucket (kBuckets' KD, NV, BKV) for hd <= 160, whatever the grid:
// K2's long-sequence bucket.
int allheads_bucket(int hd) { return plan(hd, 1 << 20, 1 << 20); }

template <int KD_, int NV_, int BKV_, int NC_>
struct Inst {
  static constexpr int KD = KD_, NV = NV_, BKV = BKV_, NC = NC_;
};

// f(Inst<...>{}) for T7's instantiation at hd with nc consumer warpgroups.
template <class F>
auto allheads_visit(int hd, int nc, F&& f) {
  switch (allheads_bucket(hd) * 4 + nc) {
    case 1: return f(Inst<48, 48, 128, 1>{});
    case 2: return f(Inst<48, 48, 128, 2>{});
    case 3: return f(Inst<48, 48, 128, 3>{});
    case 9: return f(Inst<80, 80, 128, 1>{});
    case 10: return f(Inst<80, 80, 128, 2>{});
    case 13: return f(Inst<128, 128, 128, 1>{});
    case 14: return f(Inst<128, 128, 128, 2>{});
    case 17: return f(Inst<160, 160, 64, 1>{});
    default: return f(Inst<160, 160, 64, 2>{});
  }
}

// T2, T5 to T7 and T9 on contiguous (B, L, H*hd) projections: the shifted
// softmax in one pass, hd <= 160. `mode` kShiftSplitP (T9) and kShift |
// kBf16P (T2's bf16 p): the head-major grid and K2's bucket; kShift |
// kGridHeadFastest (T8): the same on the head-fastest grid. kShift: the
// head-major grid with `consumers` -1 (T2, T5, T6; T7's probe that parts
// the grid's share of T7 and T9's difference from the second product's),
// else T7's all-heads grid, allheads_bucket's KD, NV, BKV, two Q buffers
// and `consumers` warpgroups (0: allheads_consumers). `safe`: s clamped at
// shift + 88 and 1e-30 added to l; else neither (T2 unclamped).
cudaError_t run_shift(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int Lq, int Lk, int hd, float scale_log2,
                      float shift, int mode, int consumers, bool safe,
                      cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || hd <= 0 || hd > 160 ||
      B > 65535 || H > 65535 || !std::isfinite(shift) || consumers < -1 ||
      consumers > (hd <= 48 ? 3 : 2) ||
      !(mode == kShift || mode == kShiftSplitP ||
        mode == (kShift | kBf16P) || mode == (kShift | kGridHeadFastest)) ||
      (mode != kShift && consumers > 0))
    return cudaErrorInvalidValue;
  const bool all_heads = mode == kShift && consumers >= 0;
  Sm90Args a{};
  a.out = static_cast<bf16*>(out);
  const long long D = static_cast<long long>(H) * hd;
  a.o_row = D, a.o_batch = Lq * D, a.o_head = hd;
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.out_cols = hd, a.nslices = 1;
  a.scale_log2 = scale_log2, a.shift = shift;
  a.clamp = safe ? 88.0f : INFINITY;
  a.eps = safe ? 1e-30f : 0.0f;
  const int bucket = all_heads ? allheads_bucket(hd) : plan(hd, Lq, B * H);
  const int nc = !all_heads ? kBuckets[bucket][3]
                 : consumers ? consumers
                             : allheads_consumers(hd, Lq, B);
  CUtensorMap tq, tk, tv;
  if (!maps(&tq, &tk, &tv, q, k, v, a, B, hd, D, Lq * D, D, Lk * D, 64 * nc,
            kBuckets[bucket][2]))
    return cudaErrorInvalidValue;
  if (mode == kShiftSplitP)
    return launch_two_pass<kShiftSplitP>(bucket, tq, tk, tv, a, B, stream);
  if (mode == (kShift | kBf16P))
    return launch_two_pass<kShift | kBf16P>(bucket, tq, tk, tv, a, B,
                                            stream);
  if (mode == (kShift | kGridHeadFastest))
    return launch_two_pass<kShift | kGridHeadFastest>(bucket, tq, tk, tv, a,
                                                      B, stream);
  if (!all_heads)
    return launch_two_pass<kShift>(bucket, tq, tk, tv, a, B, stream);
  return allheads_visit(hd, nc, [&](auto c) {
    using C = decltype(c);
    return launch<C::KD, C::NV, C::BKV, C::NC, kShift, true>(
        tq, tk, tv, a, B, stream);
  });
}

}  // namespace
}  // namespace dtp

// The bucket of head dim hd for lq query rows and bh (image, head) pairs:
// {bucket index, KD, NV, BKV, consumer warpgroups, output slices, dynamic
// shared memory bytes} into out[7] (the tests hold ops/attention.py
// sm90_plan against it).
extern "C" int dtp_flash_attention_sm90_plan(int hd, int lq, int bh,
                                             int* out) {
  if (hd <= 0 || hd > 512 || lq <= 0 || bh <= 0) return -1;
  const int i = dtp::plan(hd, lq, bh);
  const int* b = dtp::kBuckets[i];
  const int v[7] = {i, b[0], b[1], b[2], b[3], (hd + b[1] - 1) / b[1],
                    dtp::bucket_smem(i)};
  for (int j = 0; j < 7; ++j) out[j] = v[j];
  return 0;
}

// K2: q (B,Lq,H*hd), k and v (B,Lk,H*hd), out (B,Lq,H*hd), contiguous bf16
// (is_bf16 must be 1); hd <= 512 and a multiple of 8 (TMA's 16-byte head
// stride); scale_log2 = scale * log2(e), applied to q before Q K^T (K8's
// function). `bucket` indexes kBuckets, -1 for the plan's (a probe may
// name any bucket at least hd deep).
extern "C" cudaError_t dtp_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, int is_bf16, int bucket,
    void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return dtp::run_projections(q, k, v, out, B, H, Lq, Lk, hd, scale_log2,
                              bucket, static_cast<cudaStream_t>(stream));
}

// K8: as K2, the bucket always the plan's.
extern "C" cudaError_t dtp_flash_attention_streaming_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, int is_bf16, void* stream) {
  if (!is_bf16) return cudaErrorInvalidValue;
  return dtp::run_projections(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, -1,
                              static_cast<cudaStream_t>(stream));
}

// K13: q, k, v (B,L,H*slot) bf16 with rows q_row / kv_row elements apart
// and images q_batch / kv_batch apart (k and v share strides: views of one
// fused projection); out (B,L,H*slot) contiguous. Head h reads lanes
// [h*slot, h*slot+hd) and writes its pad lanes zero. hd <= slot <= 128.
extern "C" cudaError_t dtp_flash_attention_slotted_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int L, int hd, int slot, long long q_row, long long q_batch,
    long long kv_row, long long kv_batch, float scale_log2, int is_bf16,
    void* stream) {
  if (!is_bf16 || slot < hd || slot > 128 || slot % 8)
    return cudaErrorInvalidValue;
  dtp::Sm90Args a{};
  a.out = static_cast<dtp::bf16*>(out);
  const long long D = static_cast<long long>(H) * slot;
  a.o_row = D, a.o_batch = L * D, a.o_head = slot;
  a.H = H, a.Lq = L, a.Lk = L, a.hd = hd, a.out_cols = slot;
  a.scale_log2 = scale_log2;
  return dtp::run(q, k, v, a, B, slot, q_row, q_batch, kv_row, kv_batch,
                  dtp::kFixedMax, -1, static_cast<cudaStream_t>(stream));
}

// T4: q (BH,Lq,P), k and v (BH,Lk,P), out (BH,Lq,P), contiguous bf16 (heads
// already split into P-lane slots, every lane read and written); P <= 160
// and a multiple of 8 (TMA's 16-byte rows); scale_log2 = scale * log2(e)
// with the caller's scale. K13's two passes with H = 1 and hd = P; the
// bucket from P; exp2_bf16: p = bf16(exp2(bf16(s - m))) as K13, else
// p = exp2(s - m) in fp32 (kFixedMaxF32).
extern "C" cudaError_t dtp_slotted_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int BH, int Lq,
    int Lk, int P, float scale_log2, int exp2_bf16, void* stream) {
  if (P <= 0 || P > 160 || P % 8 || Lq <= 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  dtp::Sm90Args a{};
  a.out = static_cast<dtp::bf16*>(out);
  a.o_row = P, a.o_batch = static_cast<long long>(Lq) * P, a.o_head = P;
  a.H = 1, a.Lq = Lq, a.Lk = Lk, a.hd = P, a.out_cols = P;
  a.scale_log2 = scale_log2;
  return dtp::run(q, k, v, a, BH, P, P, static_cast<long long>(Lq) * P, P,
                  static_cast<long long>(Lk) * P,
                  exp2_bf16 ? dtp::kFixedMax : dtp::kFixedMaxF32, -1,
                  static_cast<cudaStream_t>(stream));
}

// T1: q and out (B,Lq,H*hd), k and v (B,Lk,H*hd), contiguous bf16 with
// 16-byte-aligned bases; hd <= 160 and a multiple of 8; scale_log2 =
// scale * log2(e), applied to q before Q K^T. kFixedMaxF32 in one chunk of
// every tile: the exact row max, p = exp2(s - m) in fp32, bf16(p) into P V.
extern "C" cudaError_t dtp_sublane_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, void* stream) {
  dtp::Sm90Args a{};
  a.out = static_cast<dtp::bf16*>(out);
  const long long D = static_cast<long long>(H) * hd;
  a.o_row = D, a.o_batch = Lq * D, a.o_head = hd;
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.out_cols = hd;
  a.scale_log2 = scale_log2;
  return dtp::run(q, k, v, a, B, hd, D, Lq * D, D, Lk * D, dtp::kFixedMaxF32,
                  -1, static_cast<cudaStream_t>(stream));
}

// T3: T1's operands; the running max per chunk of bk keys (chunk_plan's
// rule; any other bk: cudaErrorInvalidValue), bf16_p: p = bf16(exp2(bf16(
// s - m))).
extern "C" cudaError_t dtp_chunked_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, int bk, int bf16_p,
    void* stream) {
  dtp::ChunkPlan p;
  if (B <= 0 || H <= 0 ||
      !dtp::chunk_plan(hd, Lq, B * H, Lk, bk, bf16_p != 0, &p))
    return cudaErrorInvalidValue;
  if (p.last == dtp::kOnline && !p.narrow)
    return dtp::run_projections(q, k, v, out, B, H, Lq, Lk, hd, scale_log2,
                                -1, static_cast<cudaStream_t>(stream));
  dtp::Sm90Args a{};
  a.out = static_cast<dtp::bf16*>(out);
  const long long D = static_cast<long long>(H) * hd;
  a.o_row = D, a.o_batch = Lq * D, a.o_head = hd;
  a.H = H, a.Lq = Lq, a.Lk = Lk, a.hd = hd, a.out_cols = hd;
  a.scale_log2 = scale_log2;
  return dtp::run(q, k, v, a, B, hd, D, Lq * D, D, Lk * D, p.last, p.bucket,
                  static_cast<cudaStream_t>(stream), p.chunk_tiles, p.narrow);
}

// T3's plan for head dim hd, lq query rows, bh (image, head) pairs, lk keys,
// chunks of bk keys: {bucket index, BKV, tiles a chunk, passes over K,
// dynamic shared memory bytes, 1 where it is K8/K2's kOnline launch} into
// out[6]; -1 where the entry refuses (the tests hold
// ops/attention_variants.py chunked_sm90_plan against it).
extern "C" int dtp_chunked_attention_sm90_plan(int hd, int lq, int bh, int lk,
                                               int bk, int bf16_p,
                                               int* out) {
  dtp::ChunkPlan p;
  if (!dtp::chunk_plan(hd, lq, bh, lk, bk, bf16_p != 0, &p))
    return -1;
  const int v[6] = {p.bucket, p.bkv, p.chunk_tiles, p.passes,
                    dtp::chunk_smem(p),
                    p.last == dtp::kOnline && !p.narrow ? 1 : 0};
  for (int j = 0; j < 6; ++j) out[j] = v[j];
  return 0;
}

// T9: q and out (B,Lq,H*hd), k and v (B,Lk,H*hd), contiguous bf16 with
// 16-byte-aligned bases; hd <= 160 and a multiple of 8; scale_log2 =
// scale * log2(e), applied to q before Q K^T; `shift` the static shift
// (the clamp at shift + 88). P V takes the fp32 p as bf16 hi + lo.
extern "C" cudaError_t dtp_pvt_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        dtp::kShiftSplitP, 0, true,
                        static_cast<cudaStream_t>(stream));
}

// T2: T9's arguments, then `safe` (s clamped at shift + 88, 1e-30 added to
// l; else neither, so s - shift above 128 overflows as on the TPU) and
// `bf16_p` (p = bf16(exp2(bf16(min(s, cap) - shift))), l their sum); bf16(p)
// into P V; the head-major grid and K2's bucket.
extern "C" cudaError_t dtp_nomax_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, int safe,
    int bf16_p, void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        bf16_p ? dtp::kShift | dtp::kBf16P : dtp::kShift, -1,
                        safe != 0, static_cast<cudaStream_t>(stream));
}

// T5: T9's arguments on the (B*h, L, hd) copies of the heads, passed as B
// = B*h images of H = 1 head: T2's safe launch with fp32 p.
extern "C" cudaError_t dtp_nomax_unpadded_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        dtp::kShift, -1, true,
                        static_cast<cudaStream_t>(stream));
}

// T6: T9's arguments, the heads read in place: T2's safe launch with fp32
// p (the head-major grid, K2's bucket), on its own entry.
extern "C" cudaError_t dtp_nomax_4d_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        dtp::kShift, -1, true,
                        static_cast<cudaStream_t>(stream));
}

// T8: T6's launch on the head-fastest grid (head, query tile, image).
extern "C" cudaError_t dtp_nomax_laneslice_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        dtp::kShift | dtp::kGridHeadFastest, -1, true,
                        static_cast<cudaStream_t>(stream));
}

// T7: T9's arguments, bf16(p) into P V, every head of a query tile in one
// CTA; `consumers` forces the consumer warpgroups (0: the plan's; 1..3 at
// hd <= 48, 1..2 above; -1: T9's head-major grid and bucket, a probe).
extern "C" cudaError_t dtp_nomax_allheads_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Lq, int Lk, int hd, float scale_log2, float shift, int consumers,
    void* stream) {
  return dtp::run_shift(q, k, v, out, B, H, Lq, Lk, hd, scale_log2, shift,
                        dtp::kShift, consumers, true,
                        static_cast<cudaStream_t>(stream));
}

// T7's plan for head dim hd, lq query rows and B images, `consumers`
// forced (0: the plan's): {KD, NV, BKV, consumer warpgroups, CTAs, dynamic
// shared memory bytes} into out[6] (the tests hold
// ops/attention_variants.py allheads_sm90_plan against it).
extern "C" int dtp_nomax_allheads_sm90_plan(int hd, int lq, int B,
                                            int consumers, int* out) {
  if (hd <= 0 || hd > 160 || lq <= 0 || B <= 0 || consumers < 0 ||
      consumers > (hd <= 48 ? 3 : 2))
    return -1;
  const int* shape = dtp::kBuckets[dtp::allheads_bucket(hd)];
  const int nc = consumers ? consumers : dtp::allheads_consumers(hd, lq, B);
  const int smem = dtp::allheads_visit(hd, nc, [](auto c) {
    using C = decltype(c);
    return dtp::Plan<C::KD, C::NV, C::BKV, C::NC, true>::kSmem;
  });
  const int v[6] = {shape[0], shape[1], shape[2], nc,
                    ((lq + 64 * nc - 1) / (64 * nc)) * B, smem};
  for (int j = 0; j < 6; ++j) out[j] = v[j];
  return 0;
}
