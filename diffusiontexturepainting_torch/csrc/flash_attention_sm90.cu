// K2, K8 and K13 in bf16 for Hopper (sm_90a): one warp-specialised kernel,
// Q K^T and P V both on wgmma, K/V tiles brought in by TMA.
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
//
// Dispatch is by dtype in ops/attention.py (K2, K8, K13) and
// ops/attention_variants.py (T4): bf16 CUDA tensors come here and nowhere
// else; fp32 stays on flash_attention.cu's FMA twin (T4: attn_layouts.cu).
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
//     barriers: Q K^T starts before V lands. K13's pass 1 streams K only
//     (the producer arrives on the V barrier without a copy, so its phase
//     stays in step with the K barrier's).
//   - S = Q K^T: wgmma m64nBKVk16, A = Q and B = the K tile (K-major), both
//     in shared memory in the 128-byte swizzle TMA writes.
//   - Softmax on the accumulator registers: a row's values sit in the 4
//     threads of a quad (two shuffles); p = ex2.approx(s - m), the logits
//     being base 2 already; only the last tile masks columns >= Lk (full
//     tiles compile the test out); the mode (online, max pass, fixed max)
//     is a template parameter.
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

// ---- the plan of one bucket ----

// KD: the Q K^T depth (KD/16 k16 steps); NV: the P V width of one output
// slice; BKV: keys a K/V tile; NC: consumer warpgroups of 64 query rows.
template <int KD, int NV, int BKV, int NC>
struct Plan {
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
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  // q_full, full_k[kStages], full_v[kStages], empty[kStages]; 1024 bytes
  // of slack align the base for the swizzle
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
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
};

// The softmax of a pass: online (running max, alpha rescaling); the max
// pass; against the fixed row max, p = bf16(exp2(bf16(s - m))) (K13, T4 with
// exp2_bf16) or p = exp2(s - m) in fp32, the row sum of the unrounded p
// and bf16(p) into P V (T4 without).
enum Mode : int {
  kOnline = 0,
  kMaxPass = 1,
  kFixedMax = 2,
  kFixedMaxF32 = 3
};

// S = Q K^T for one warpgroup: qa its Q rows, kt the K tile.
template <int KD, int BKV, int NC>
__device__ __forceinline__ void qk(float (&s)[BKV / 2], uint32_t qa,
                                   uint32_t kt) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t atom = kk / 4, step = (kk % 4) * 32;
    Wgmma<BKV>::ss(s, desc128(qa + atom * (64 * NC * 128) + step, 16),
                   desc128(kt + atom * (BKV * 128) + step, 16), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// O += P V for one warpgroup: vt the V tile (key rows, MN-major).
template <int NV, int BKV>
__device__ __forceinline__ void pv(float (&o)[NV / 2],
                                   uint32_t (&p)[BKV / 16][4], uint32_t vt) {
  wg_fence();
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t)
    Wgmma<NV>::rs(o, p[t], desc128(vt + t * 16 * 128, BKV * 128), 1);
  wg_commit();
  wg_wait_all();
  fence_regs(o);
  fence_regs(p);
}

// LAST: the softmax of the last pass, kOnline for one pass, kFixedMax or
// kFixedMaxF32 after a max pass.
template <int KD, int NV, int BKV, int NC, int LAST>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
attn_sm90(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const Sm90Args a) {
  using P = Plan<KD, NV, BKV, NC>;
  constexpr bool TWO_PASS = LAST != kOnline;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + P::kK, sV = base + P::kV;
  const uint32_t q_full = base + P::kBar;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

  const int q0 = blockIdx.x * P::kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.nslices, slice = blockIdx.z % a.nslices;
  const int ntiles = (a.Lk + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NC * 4);  // lane 0 of each consumer warp
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
      mbar_expect_tx(q_full, P::kQBytes);
#pragma unroll 1
      for (int c = 0; c < P::kKAtoms; ++c)
        tma_load(sQ + c * P::kQRows * 128, &tq, q_full, c * kAtom, h, q0, b);
      int it = 0;
#pragma unroll 1
      for (int pass = TWO_PASS ? 0 : 1; pass < 2; ++pass) {
#pragma unroll 1
        for (int j = 0; j < ntiles; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full_k(s), P::kKBytes);
#pragma unroll 1
          for (int c = 0; c < P::kKAtoms; ++c)
            tma_load(sK + s * P::kKBytes + c * BKV * 128, &tk, full_k(s),
                     c * kAtom, h, j * BKV, b);
          if (pass == 1) {
            mbar_expect_tx(full_v(s), P::kVBytes);
#pragma unroll 1
            for (int c = 0; c < P::kVAtoms; ++c)
              tma_load(sV + s * P::kVBytes + c * BKV * 128, &tv, full_v(s),
                       slice * NV + c * kAtom, h, j * BKV, b);
          } else {
            mbar_arrive(full_v(s));
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

    // Q: scale this warpgroup's rows by scale*log2(e), round to bf16
    mbar_wait(q_full, 0);
#pragma unroll 1
    for (int i = t; i < 64 * 8 * P::kKAtoms; i += 128) {
      const int c = i / 512, rem = i % 512;
      uint4* p = reinterpret_cast<uint4*>(gbase + c * P::kQRows * 128 +
                                          wg * 64 * 128 + rem * 16);
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.scale_log2);
      *p = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, 128);

    const uint32_t qa = sQ + wg * 64 * 128;
    float o[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.0f;
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    int it = 0;

    // One K/V tile: S = Q K^T, then the mode's softmax, then (but in the
    // max pass) O += P V; the empty barrier is released after the last
    // product that reads the stage.
    auto tile = [&](auto mode_tag, auto mask_tag, int j) {
      constexpr int MODE = decltype(mode_tag)::value;
      constexpr bool MASK = decltype(mask_tag)::value;
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      mbar_wait(full_k(st), ph);
      qk<KD, BKV, NC>(s, qa, sK + st * P::kKBytes);
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
      } else {
        float sum0 = 0.0f, sum1 = 0.0f;
        if constexpr (MODE == kOnline) {
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
          }
          // every tile holds a real key, so mx is finite; ex2(-inf) = 0
          const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
          m0 = mx0;
          m1 = mx1;
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            s[4 * i] = ex2(s[4 * i] - m0);
            s[4 * i + 1] = ex2(s[4 * i + 1] - m0);
            s[4 * i + 2] = ex2(s[4 * i + 2] - m1);
            s[4 * i + 3] = ex2(s[4 * i + 3] - m1);
            sum0 += s[4 * i] + s[4 * i + 1];
            sum1 += s[4 * i + 2] + s[4 * i + 3];
          }
          l0 = l0 * alpha0 + sum0;
          l1 = l1 * alpha1 + sum1;
#pragma unroll
          for (int i = 0; i < NV / 8; ++i) {
            o[4 * i] *= alpha0;
            o[4 * i + 1] *= alpha0;
            o[4 * i + 2] *= alpha1;
            o[4 * i + 3] *= alpha1;
          }
        } else if constexpr (MODE == kFixedMax) {
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            s[4 * i] = round_bf16(ex2(round_bf16(s[4 * i] - m0)));
            s[4 * i + 1] = round_bf16(ex2(round_bf16(s[4 * i + 1] - m0)));
            s[4 * i + 2] = round_bf16(ex2(round_bf16(s[4 * i + 2] - m1)));
            s[4 * i + 3] = round_bf16(ex2(round_bf16(s[4 * i + 3] - m1)));
            sum0 += s[4 * i] + s[4 * i + 1];
            sum1 += s[4 * i + 2] + s[4 * i + 3];
          }
          l0 += sum0;
          l1 += sum1;
        } else {
          // kFixedMaxF32: the sum of the fp32 p; pack_bf16 rounds them for
          // P V
#pragma unroll
          for (int i = 0; i < BKV / 8; ++i) {
            s[4 * i] = ex2(s[4 * i] - m0);
            s[4 * i + 1] = ex2(s[4 * i + 1] - m0);
            s[4 * i + 2] = ex2(s[4 * i + 2] - m1);
            s[4 * i + 3] = ex2(s[4 * i + 3] - m1);
            sum0 += s[4 * i] + s[4 * i + 1];
            sum1 += s[4 * i + 2] + s[4 * i + 3];
          }
          l0 += sum0;
          l1 += sum1;
        }
#pragma unroll
        for (int k = 0; k < BKV / 16; ++k) {
          pa[k][0] = pack_bf16(s[8 * k], s[8 * k + 1]);
          pa[k][1] = pack_bf16(s[8 * k + 2], s[8 * k + 3]);
          pa[k][2] = pack_bf16(s[8 * k + 4], s[8 * k + 5]);
          pa[k][3] = pack_bf16(s[8 * k + 6], s[8 * k + 7]);
        }
        mbar_wait(full_v(st), ph);
        pv<NV, BKV>(o, pa, sV + st * P::kVBytes);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      ++it;
    };
    // One pass over the keys: the full tiles, then the ragged tail masked.
    auto pass = [&](auto mode_tag) {
      const int full = a.Lk / BKV;
#pragma unroll 1
      for (int j = 0; j < full; ++j) tile(mode_tag, std::false_type{}, j);
      if (full < ntiles) tile(mode_tag, std::true_type{}, full);
    };
    if constexpr (TWO_PASS) {
      pass(std::integral_constant<int, kMaxPass>{});
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      pass(std::integral_constant<int, LAST>{});
    } else {
      pass(std::integral_constant<int, kOnline>{});
    }

    // ---- epilogue: O / l to bf16, staged in this warpgroup's Q rows ----
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    uint8_t* const stage = gbase + wg * 64 * 128;
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
    const int ncols = min(a.out_cols - col0, a.nslices > 1 ? NV : a.out_cols);
    const int chunks = (ncols + 7) / 8;
    bf16* const ob = a.out + b * a.o_batch + static_cast<long long>(h) *
                                                 a.o_head + col0;
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

template <int KD, int NV, int BKV, int NC, int LAST>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Sm90Args& a, int B,
                   cudaStream_t stream) {
  using P = Plan<KD, NV, BKV, NC>;
  auto kern = attn_sm90<KD, NV, BKV, NC, LAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + P::kQRows - 1) / P::kQRows, a.H, B * a.nslices);
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// The two-pass buckets (hd <= 160) with the last pass's softmax LAST.
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

// Strides in elements: q (and out) rows q_row apart, images q_batch apart;
// k and v rows kv_row apart, images kv_batch apart; heads `head` apart.
// `bucket` indexes kBuckets (-1: plan's). `last`: the softmax of the last
// pass (Mode), kOnline for one pass; two passes take the buckets of
// hd <= 160 only (one output slice).
cudaError_t run(const void* q, const void* k, const void* v, Sm90Args a,
                int B, long long head, long long q_row, long long q_batch,
                long long kv_row, long long kv_batch, int last, int bucket,
                cudaStream_t stream) {
  const bool two_pass = last != kOnline;
  if (B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.hd <= 0 ||
      a.hd > 512 || (two_pass && a.hd > 160) || B > 65535 ||
      a.H > 65535 || (last != kOnline && last != kFixedMax &&
                      last != kFixedMaxF32))
    return cudaErrorInvalidValue;
  if (bucket < 0) bucket = plan(a.hd, a.Lq, B * a.H);
  if (bucket >= kNumBuckets || kBuckets[bucket][0] < a.hd ||
      (two_pass && bucket > 4))
    return cudaErrorInvalidValue;
  // a stride over a dimension of one is never stepped: any valid value
  if (a.Lq == 1) q_row = a.H * head;
  if (a.Lk == 1) kv_row = a.H * head;
  if (B == 1) q_batch = a.Lq * q_row, kv_batch = a.Lk * kv_row;
  if (!describable(q, head, q_row, q_batch) ||
      !describable(k, head, kv_row, kv_batch) ||
      !describable(v, head, kv_row, kv_batch) || !aligned16(a.out))
    return cudaErrorInvalidValue;
  const int nv = kBuckets[bucket][1], bkv = kBuckets[bucket][2];
  const int nc = kBuckets[bucket][3];
  a.nslices = (a.hd + nv - 1) / nv;
  if (B * a.nslices > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, a.hd, a.H, a.Lq, B, head, q_row, q_batch,
                  64 * nc) ||
      !tensor_map(&tk, k, a.hd, a.H, a.Lk, B, head, kv_row, kv_batch, bkv) ||
      !tensor_map(&tv, v, a.hd, a.H, a.Lk, B, head, kv_row, kv_batch, bkv))
    return cudaErrorInvalidValue;
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
