// K1/K5 in bf16 for Hopper (sm_90a): GroupNorm -> SiLU -> 3x3 SAME conv
// with bias, residual and statistics epilogues, as a warp-specialised
// implicit GEMM, wgmma fed by TMA; and on the same body K4 and K6 (the x2
// upsample conv, K6 with statistics) and K7 (the plain 3x3 conv).
//
//   dtp_gn_conv3x3_sm90  K1 <- diffusiontexturepainting_tpu/ops/conv3x3.py
//       _gn_conv_resident_pallas / _gn_res_kernel, and K5 <- ops/
//       gn_conv_stream.py _stream_fused_pallas / _kernel: one function,
//       resident or streamed on the TPU:
//         v = silu(x*a[b,c] + c[b,c]) inside the image, 0 outside (the
//             conv's SAME border is zero AFTER the prologue); a and c
//             rounded to bf16, the affine and the SiLU each rounded to bf16
//         y = round(bias[n] + sum_{di,dj,c} v[b,y+di-1,x+dj-1,c] w[di,dj,c,n])
//         y = round(y + residual)
//       and fp32 (sum, sumsq) per (b, n) of that final y. Without a
//       prologue v = x. fp32 stays on conv3x3.cu's FMA twin (dispatch by
//       dtype in ops/gn_conv.py gn_conv3x3).
//
// What bounds it on the H100: at the VAE's and the 1024^2 UNet's levels
// (M up to 2^21 output pixels, K = 9*Cin) the tensor cores; at the UNet's
// 8x8 and 4x4 levels (M = 192 and 48 pixels against K up to 9*1280 and
// Cout 1280) the weight bytes, which every SM has to help stream.
//
// Design. A CTA computes a tile of 64*NC output pixels (NB images x R rows
// x TW columns, TW 4, 8 or 16 from the image width) by 128 output
// channels: NC consumer warpgroups of 64 pixels, then two producer warps
// (one issues the weights, the other the windows). The consumers fit
// ptxas's 168 registers a thread at NC = 2 without spilling because the
// tap loop is not unrolled (else all nine taps' shifted addresses stay
// live) and a, c are held as bf16 pairs.
//   - The K loop runs over ceil(Cin/64) channel chunks x 9 taps. For a
//     chunk, one TMA box over x viewed as (C, W, H, B) brings the tile's
//     input window, NB x (R+2) x (TW+2) pixels by 64 channels, 128-byte
//     swizzle; pixels outside the image (the halo and the ragged tile) lie
//     out of bounds and arrive as zeros, and so do channels past Cin.
//   - The prologue runs once per staged element: the consumers read the
//     window, apply silu(x*a + c) to the pixels inside the image, write 0
//     for those outside (TMA's zeros are zeros of x, not of the prologue),
//     and store the result in one of two buffers V, in the same layout; the
//     window's stage then goes back to the producer. Chunk k + 1's
//     prologue runs in nine slices, one after each of chunk k's taps is
//     issued, so it overlaps the tensor cores' work; one consumer barrier a
//     chunk hands the V buffers over.
//   - A tap (di, dj) is the window shifted by (di, dj): its rows are no
//     uniform-stride view of V, so the A operand comes from registers:
//     each lane ldmatrix's its pixel's 16-byte channel groups at the
//     shifted line, which gives wgmma's register A fragment (the register
//     form of m64n128k16, as P is fed in flash_attention_sm90.cu). A tap's
//     loads wait for the previous tap's products: ptxas serialises register-
//     A wgmma whose next fragments are loaded while one is in flight.
//   - B, the tap's weights w[di, dj, c0:c0+64, n0:n0+128], come through a
//     ring of stages with full/empty mbarriers: two 64-column TMA boxes
//     over w viewed as (Cout, Cin, 9) with the taps w_tap elements apart,
//     so a slice w_full[:, :, lo:hi] of a wider weight is read in place;
//     N contiguous, MN-major (the transpose bit).
//   - Small grids split the chunks over blockIdx.z; each split stores its
//     fp32 tile, and the last to finish (an integer counter per tile, reset
//     by the host before the launch) adds all splits in split order: no
//     float atomics, a replay is bit-identical.
//   - Epilogue: + bias, rounding, + residual (staged through shared memory
//     by 16-byte loads), rounding, in registers; (sum, sumsq) of the
//     rounded values of the pixels inside the image, added across the 8
//     row groups of a warp by shuffles and across warps in a fixed order,
//     per image of the tile; the values staged in shared memory (16-byte
//     chunks XOR-swizzled by row) and stored as 16-byte rows of channels,
//     or one element at a time where Cs, the stored channels, is off 8 (the
//     VAE decoder's 3-channel head computes a zero-padded 8-channel weight
//     and stores 3). Where a tile holds whole images, its sums are the
//     images' statistics; otherwise each tile writes a partial and a
//     second kernel adds each image's tiles in tile order.
//
//   dtp_upsample2x_conv3x3_sm90  K4 <- ops/conv3x3.py _upconv_pallas /
//       _upconv_kernel_padded: conv3x3(nearest_x2(x)) + bias, one rounding,
//       as four parity planes (ry, rx) of 2x2 folded taps over the source:
//         out[b,2y+ry,2x+rx,n] = round(bias[n] + sum_{ai,bi,c}
//             x[b,y+ry+ai-1,x+rx+bi-1,c] taps[((ry*2+rx)*2+ai)*2+bi,c,n])
//       with the module's taps (ops/conv3x3.py fold_upsample_weights); no
//       prologue (v = x), residual or statistics. fp32 stays on
//       conv3x3.cu's twin (dispatch by dtype in ops/conv3x3.py
//       upsample2x_conv3x3).
//   Design, on the K1/K5 body: a CTA takes 64 source pixels (the same
//   tiles as one consumer warpgroup of K1/K5) by 128 output channels and
//   all four planes: four warpgroups, one a plane, so the window is staged
//   once per chunk for the four (and read straight from the TMA stage:
//   without a prologue TMA's zeros are the conv's). A plane's tap (ai, bi)
//   is the window shifted by (ry+ai, rx+bi) in {0,1,2}^2, the shifted
//   ldmatrix reads into wgmma's register A of K1/K5. Four planes' fp32
//   accumulators are half the register file, so the block has no producer
//   warps (512 threads keep 128 registers a thread; with producer warps
//   ptxas allowed 96 and it spilled): each warpgroup's lane 0 issues its
//   own plane's weight stages (p, p + 4, ...) as its taps free them, thread
//   0 the windows. Small grids split K in whole chunks as K1/K5 do. The
//   epilogue stages the four planes' rounded tiles over the ring and stores
//   16-byte rows, (2x, 2x+1) of a row next to each other. What bounds it:
//   the operations at the 1024^2 UNet's levels; at the 256^2 UNet's 4x4
//   and 8x8 levels the folded weights (16/9 of the 3x3 weights' bytes),
//   which every SM has to help stream.
//
//   dtp_upsample2x_conv3x3_stats_sm90  K6 <- ops/gn_conv_stream.py
//       _upconv_stream_pallas / _upconv_stream_kernel: K4's function and
//       fp32 (sum, sumsq) per (b, n) over the 4*H*W output pixels of y
//       BEFORE its rounding (the TPU kernel's order; K9 takes its
//       statistics so too). K4's kernel with STATS: each plane's
//       warpgroup reduces y one 8-column group of accumulators at a time,
//       over a thread's two rows, then the warp's 8 row groups by
//       shuffles, straight into shared memory past the staged tiles (no
//       second array of sums stays live: 128 registers a thread); then the
//       4 warps x 4 planes are added in that fixed order per image of the
//       tile. An image spanning tiles gets one partial a tile, added in
//       tile order by K1/K5's tile_stats_reduce; under a split of K the
//       split that adds all splits takes the statistics. No float atomics.
//       What bounds it: the operations (2 * 16 * Cin * Cout a source
//       pixel) at the VAE decoder's 128^2 to 512^2 sources.
//
//   dtp_conv3x3_sm90  K7 <- ops/conv3x3.py _conv3x3_pallas / _conv_kernel:
//       the 3x3 SAME conv + bias in fp32, one rounding; no prologue,
//       residual or statistics. Also K12a <- _conv_kernel_inpad (the same
//       function under _IN_PAD, its zero border made in VMEM) and K11 <-
//       _conv3x3_stream / _conv_stream_kernel (the same function over
//       DMA'd windows of H_T + 2 rows): TMA's out-of-bounds zeros are
//       K12a's on-chip padding and its windows K11's streamed rows, so the
//       wrappers launch this entry and count apart. The K1/K5 kernel's
//       PLAIN mode, with K1/K5's tile, consumer warpgroups and split of K,
//       except where K1/K5's plan takes one consumer warpgroup to split K
//       and two consumers can split deeper over as many CTAs with full
//       tiles and at least 4 chunks a split (same_plan: the UNet's 16^2
//       level at Cin >= 960); without a prologue TMA's out-of-bounds zeros
//       are the conv's padding, so A is ldmatrix'ed straight from the TMA
//       window stage, as K4 reads it; the V buffers and the consumers'
//       per-chunk hand-over go, and their shared memory gives three window
//       stages and up to 12 B stages. What bounds it: the operations at
//       the UNet's 16^2 and 32^2 levels and the VAE's; the weight bytes at
//       the 4x4 and 8x8 levels. A cluster mode (two CTAs on neighbouring M
//       tiles, each B stage brought once to both by TMA multicast) was
//       measured slower at every shape and removed.
//
//   dtp_gn_silu_conv3x3_sm90  K10 <- ops/conv3x3.py gn_silu_conv3x3 /
//       _gn_conv_pallas / _gn_conv_kernel (after csrc/moments.cu's fp32
//       sums S1, S2 of x per (image, channel)):
//         per group g of Cin/G channels, n = H*W*Cin/G: mean = S1_g/n,
//           inv = rsqrt(S2_g/n - mean^2 + eps), a = inv*scale[c],
//           c = shift[c] - mean*a, all fp32
//         v = round(silu(x*a + c)), the affine and the SiLU in fp32, inside
//             the image; 0 outside (the border skips the prologue)
//         y = round(acc + bias[n] + temb[b,n] + residual[b,y,x,n]), the
//             sum in fp32, one rounding; no statistics
//       fp32 stays on conv_staged.cu's FMA twin.
//   dtp_gn_conv_pipelined_sm90  T12 <- tools/bench_stream_pipeline.py
//       pipelined / _pipe_kernel: the VALID conv of silu(pad(x)*a + c) + b,
//       a, c (B, Cin) fp32 given; v = round(silu(x*a + c)) in fp32 on every
//       window pixel, the zero padding included (its border is silu(c));
//       y = round(acc + bias[n]), one rounding. fp32 stays on conv_arms.cu.
//   Design: one affine mode of the K1/K5 kernel, compile-time bits of its
//   template (AFF; 0 for K1/K5 and K7), instantiated by the two entries
//   only; the kernel tests the bits in if constexpr conditions and keeps
//   the mode's work in the Affine helper, built where it is used, so the
//   other instantiations compile to their parent's SASS instruction for
//   instruction (tools/sass_diff.py): kF32Affine (a, c, the affine and the SiLU in fp32, v rounded
//   once), kMask (K10: 0 outside the image; without it, T12, the prologue
//   runs on TMA's out-of-bounds zeros, which are zeros of x, and gives
//   silu(c) there), kFold (K10: a, c folded in the CTA) and kOneRound (the
//   epilogue above). fp32 a, c would double K1/K5's bf16 pairs in
//   registers, so the consumers keep them in shared memory: a table of
//   the 64 channels of a chunk by the tile's image slots, two buffers,
//   chunk k + 2's filled beside chunk k's taps and published by the
//   per-chunk barrier that hands the V buffers over; each prologue line
//   reads its slot's 8 channels as four 16-byte loads. K10 first folds
//   the group means and inverse deviations of the groups its chunks
//   touch, for each image slot, into shared memory (the per-warp sums'
//   place: no statistics here), then each table entry per channel, so a
//   group that crosses 8-channel loads or 64-channel chunks is folded per
//   channel: two launches with K14's, no fold launch, no host sync. The
//   epilogue takes each warp's image slot for temb (a warp's 16 rows lie
//   in one image), after the ordered sum of the splits under split K.
//   What bounds them: as K1/K5 at the same shapes (K10 at the UNet's 256^2
//   levels, where the 4x4 and 8x8 levels are weight-bound and split K; T12
//   at the VAE's, the tensor cores), plus one fp32 division a staged
//   element in the prologue.
//
// Against conv3x3.cu's WMMA kernels (now their fp32 FMA twins): the
// prologue once per staged element instead of once per tap and output
// tile, a pipelined K loop on wgmma instead of load, sync, mma.sync, sync,
// and no fp32 round trip of the output through finish_stats_kernel and
// stats_reduce_kernel.
#include "conv_sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kAtom = 64;      // input channels of a chunk (128 bytes)
constexpr int kBN = 128;       // output channels of a tile
constexpr int kWinStages = 2;  // input windows in flight
constexpr int kMaxBStages = 8;
constexpr int kBBytes = kAtom * kBN * 2;  // one tap's weights of a chunk
constexpr int kSMs = 132;                 // H100 SXM
constexpr int kSmemLimit = 232448;
constexpr int kUpWG = 4;          // K4: a warpgroup a parity plane
constexpr int kUpMaxStages = 12;  // K4's B stages, a multiple of kUpWG
constexpr int kSameWinStages = 3;    // K7: input windows in flight
constexpr int kSameMaxBStages = 12;  // K7's B stages
constexpr int kSameMinChunks = 4;    // K7: chunks a split of two consumers
constexpr int kMaxGroups = 128;      // K10's GroupNorm groups

// The affine modes' bits (gn_conv_sm90's AFF; the header says what each
// does) and the two instantiated: K10's and T12's
constexpr int kF32Affine = 1;
constexpr int kMask = 2;
constexpr int kFold = 4;
constexpr int kOneRound = 8;
constexpr int kK10 = kF32Affine | kMask | kFold | kOneRound;
constexpr int kT12 = kF32Affine | kOneRound;
// Whether the mode `aff` has `bit`. The kernel asks this in its if
// constexpr conditions rather than keeping the answers in local constants:
// locals the other modes do not use perturbed their machine code.
__host__ __device__ constexpr bool has(int aff, int bit) {
  return (aff & bit) != 0;
}

// The affine modes' shared-memory tables, in the place of the per-warp
// statistics: a, c of a chunk's 64 channels for each of the up to 4 * nc
// image slots of a tile, two buffers; with kFold after them each slot's
// group means and inverse deviations.
__host__ __device__ constexpr int affine_table_bytes(int nc, bool fold) {
  return 4 * nc * (2 * 2 * kAtom + (fold ? 2 * kMaxGroups : 0)) * 4;
}

struct GnPlan {
  int nc, tw, rows, nb;   // a tile: nb images x rows x tw columns
  int win_lines, win_bytes, region0, stages, smem;
  int tiles_h, tiles_w, tpi;  // tiles of an image; tiles its stats span
  int m_tiles, n_tiles, chunks, splits, per_split;
};

struct GnArgs {
  const float* gn_a;  // (B, Cin) rows a_stride apart, or null: no prologue
  const float* gn_c;
  long long a_stride, c_stride;
  const bf16* bias;      // (>= Cs,) or null
  const bf16* residual;  // (B, H, W, Cs) or null
  bf16* out;             // (B, H, W, Cs)
  float* stats;          // (B, 2, Cs) or null: no statistics
  float* partial;        // (B * tpi, 2, Cs) when tpi > 1
  float* ws;             // the split tiles, fp32
  int* counters;         // one per output tile when split
  int B, H, W, Cin, Cs;
  int rows, nb, tiles_w, tpi, win_lines, win_bytes, region0, stages;
  int per_split, chunks, splits;
  // the affine modes
  const float* gn_stats;  // K10: (B, 2, Cin) fp32 sums of x and x^2
  const bf16* gn_scale;   // K10: the GroupNorm's (Cin,) scale and shift
  const bf16* gn_shift;
  const bf16* temb;  // K10: (B, Cs) or null
  float eps;
  int groups;
};

__device__ __forceinline__ float silu_bf16(float t) {
  return round_bf16(__fdividef(t, 1.0f + __expf(-t)));
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The affine modes' prologue: the SiLU expression of the fp32 twins
// (conv_staged.cu, conv_arms.cu), in fp32
__device__ __forceinline__ float silu_f32(float x, float a, float c) {
  const float t = fmaf(x, a, c);
  return t / (1.0f + __expf(-t));
}
__device__ __forceinline__ uint32_t silu2_f32(uint32_t w, float a0, float c0,
                                              float a1, float c1) {
  return pack_bf16(silu_f32(lo_bf16(w), a0, c0),
                   silu_f32(hi_bf16(w), a1, c1));
}

// Two bf16 of x through the prologue, as conv3x3.cu load_chunk_gn rounds;
// ac0, ac1: each channel's (a, c) rounded to bf16, a in the low half.
__device__ __forceinline__ uint32_t gn_silu2(uint32_t w, uint32_t ac0,
                                             uint32_t ac1) {
  return pack_bf16(
      silu_bf16(round_bf16(fmaf(lo_bf16(w), lo_bf16(ac0), hi_bf16(ac0)))),
      silu_bf16(round_bf16(fmaf(hi_bf16(w), lo_bf16(ac1), hi_bf16(ac1)))));
}

// The affine modes' work of one consumer thread (ct) of a CTA whose tile
// starts at image b0, row i0, column j0 and whose split starts at chunk
// c_begin; `smem` is the tables' region: ctab[buffer][slot][a, c][64
// channels], the split's chunk k in buffer k & 1, then with kFold
// gtab[slot][mean, inv][group]. Built where it is used, so that the
// kernels of the other modes hold none of it.
template <int TW, int NC, int AFF>
struct Affine {
  static constexpr int kCT = 128 * NC;
  static constexpr int kSlots = 4 * NC;  // image slots a tile can hold
  static constexpr int kWinW = TW + 2;
  const GnArgs& a;
  uint8_t* smem;
  int ct, b0, i0, j0, c_begin;

  __device__ float* ctab(int k) const {
    return reinterpret_cast<float*>(smem) + (k & 1) * kSlots * 2 * kAtom;
  }
  __device__ float* gtab() const { return ctab(0) + 2 * kSlots * 2 * kAtom; }

  // kFold: each image slot's means and inverse deviations of the groups
  // the split's nch chunks touch, from the fp32 sums (conv_staged.cu's
  // fold)
  __device__ void fold(int nch) const {
    const int cpg = a.Cin / a.groups;
    const int g_lo = c_begin * kAtom / cpg;
    const int ng = (min(a.Cin, (c_begin + nch) * kAtom) - 1) / cpg - g_lo + 1;
    const float n =
        static_cast<float>(static_cast<long long>(a.H) * a.W * cpg);
    float* const g = gtab();
#pragma unroll 1
    for (int v = ct; v < a.nb * ng; v += kCT) {
      const int slot = v / ng, grp = g_lo + v % ng, b = b0 + slot;
      float mean = 0.0f, inv = 0.0f;
      if (b < a.B) {
        const float* s = a.gn_stats + static_cast<long long>(b) * 2 * a.Cin;
        float s1 = 0.0f, s2 = 0.0f;
        for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
          s1 += __ldg(s + c);
          s2 += __ldg(s + a.Cin + c);
        }
        mean = s1 / n;
        inv = rsqrtf(s2 / n - mean * mean + a.eps);
      }
      g[slot * 2 * kMaxGroups + grp] = mean;
      g[slot * 2 * kMaxGroups + kMaxGroups + grp] = inv;
    }
  }

  // a, c of the split's chunk k for every image slot, per channel (a
  // group may cross the 8-channel loads and the 64-channel chunks); 0 past
  // Cin and for slots past the batch
  __device__ void fill(int k) const {
    float* const t = ctab(k);
    const int c0 = (c_begin + k) * kAtom;
#pragma unroll 1
    for (int v = ct; v < a.nb * kAtom; v += kCT) {
      const int slot = v / kAtom, e = v % kAtom, ch = c0 + e, b = b0 + slot;
      float av = 0.0f, cv = 0.0f;
      if (b < a.B && ch < a.Cin) {
        if constexpr (has(AFF, kFold)) {
          const float* gs = gtab() + slot * 2 * kMaxGroups;
          const int grp = ch / (a.Cin / a.groups);
          av = gs[kMaxGroups + grp] * __bfloat162float(a.gn_scale[ch]);
          cv = __bfloat162float(a.gn_shift[ch]) - gs[grp] * av;
        } else {
          av = __ldg(a.gn_a + b * a.a_stride + ch);
          cv = __ldg(a.gn_c + b * a.c_stride + ch);
        }
      }
      t[slot * 2 * kAtom + e] = av;
      t[slot * 2 * kAtom + kAtom + e] = cv;
    }
  }

  // K1/K5's transform walk (its lines and 16-byte groups, `part` of
  // `parts`) from the window `src` into the V buffer `dst` with the fp32
  // prologue from chunk k's table; kMask: 0 outside the image, else every
  // line, TMA's zeros included
  __device__ void transform(const uint8_t* src, uint8_t* dst, int k,
                            int part, int parts) const {
    const int q = ct & 7;
    const int img_lines = (a.rows + 2) * kWinW;
    const float* tk = ctab(k) + 8 * q;
#pragma unroll 1
    for (int L = (ct >> 3) + part * (kCT / 8); L < a.win_lines;
         L += parts * (kCT / 8)) {
      int slot = 0, rem = L;
      if (a.nb > 1) {
        slot = L / img_lines;
        rem = L - slot * img_lines;
      }
      const uint32_t off = L * 128 + ((q ^ (L & 7)) << 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      bool inside = true;
      if constexpr (has(AFF, kMask)) {
        const int y = i0 - 1 + rem / kWinW, x = j0 - 1 + rem % kWinW;
        inside = b0 + slot < a.B && y >= 0 && y < a.H && x >= 0 && x < a.W;
      }
      if (inside) {
        const float* t = tk + slot * 2 * kAtom;
        v = *reinterpret_cast<const uint4*>(src + off);
        const float4 a0 = *reinterpret_cast<const float4*>(t);
        const float4 c0 = *reinterpret_cast<const float4*>(t + kAtom);
        v.x = silu2_f32(v.x, a0.x, c0.x, a0.y, c0.y);
        v.y = silu2_f32(v.y, a0.z, c0.z, a0.w, c0.w);
        const float4 a1 = *reinterpret_cast<const float4*>(t + 4);
        const float4 c1 = *reinterpret_cast<const float4*>(t + kAtom + 4);
        v.z = silu2_f32(v.z, a1.x, c1.x, a1.y, c1.y);
        v.w = silu2_f32(v.w, a1.z, c1.z, a1.w, c1.w);
      }
      *reinterpret_cast<uint4*>(dst + off) = v;
    }
  }
};

// PLAIN: K7, no prologue, residual or statistics; A straight from the
// window stages (kSameWinStages of them), no V buffers. AFF: the affine
// modes' bits (K10, T12), 0 otherwise.
template <int TW, int NC, bool PLAIN, int AFF = 0>
__global__ void __launch_bounds__(128 * NC + 64, 1)
gn_conv_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw, const GnArgs a) {
  constexpr int kPix = 64 * NC;
  constexpr int kWinW = TW + 2;
  constexpr int kCT = 128 * NC;  // consumer threads
  constexpr int kWS = PLAIN ? kSameWinStages : kWinStages;
  constexpr int kBS = PLAIN ? kSameMaxBStages : kMaxBStages;
  // the per-warp statistics, or the affine modes' tables
  constexpr int kRedBytes =
      PLAIN                    ? 0
      : has(AFF, kF32Affine) ? affine_table_bytes(NC, has(AFF, kFold))
                             : 4 * NC * 2 * kBN * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int red_off = a.region0 + a.stages * kBBytes;
  const int bar_off = red_off + kRedBytes;
  auto win = [&](int s) { return base + s * a.win_bytes; };
  const uint32_t vbase = base + kWinStages * a.win_bytes;  // V[2]
  const uint32_t bring = base + a.region0;
  auto win_full = [&](int s) { return base + bar_off + 8 * s; };
  auto win_empty = [&](int s) { return base + bar_off + 8 * (kWS + s); };
  auto b_full = [&](int s) { return base + bar_off + 8 * (2 * kWS + s); };
  auto b_empty = [&](int s) {
    return base + bar_off + 8 * (2 * kWS + kBS + s);
  };
  int* const flag =
      reinterpret_cast<int*>(gbase + bar_off + 8 * 2 * (kWS + kBS));

  const int n0 = blockIdx.x * kBN;
  const int mt = blockIdx.y, split = blockIdx.z;
  int b0, i0 = 0, j0 = 0, timg = 0;
  if (a.tpi == 1) {
    b0 = mt * a.nb;  // whole images
  } else {
    b0 = mt / a.tpi;
    timg = mt % a.tpi;
    i0 = (timg / a.tiles_w) * a.rows;
    j0 = (timg % a.tiles_w) * TW;
  }
  const int c_begin = split * a.per_split;
  const int nch = min(a.per_split, a.chunks - c_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWS; ++s) {
      mbar_init(win_full(s), 1);
      mbar_init(win_empty(s), NC * 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(b_full(s), 1);
      mbar_init(b_empty(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCT) {
    // ---- two producer warps after the consumer warpgroups: lane 0 of the
    // first issues the weights, lane 0 of the second the windows, so
    // neither ring waits on the other ----
    if (threadIdx.x == kCT) {
      int s = 0, ph = 0;
#pragma unroll 1
      for (int k = 0; k < nch; ++k) {
        const int c0 = (c_begin + k) * kAtom;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(b_empty(s), ph ^ 1);
          mbar_expect_tx(b_full(s), kBBytes);
          const uint32_t dst = bring + s * kBBytes;
          tma_load(dst, &tw, b_full(s), n0, c0, tap, 0);
          tma_load(dst + kAtom * 128, &tw, b_full(s), n0 + kAtom, c0, tap,
                   0);
          if (++s == a.stages) s = 0, ph ^= 1;
        }
      }
    } else if (threadIdx.x == kCT + 32) {
      const uint32_t win_tx = a.win_lines * 128;
#pragma unroll 1
      for (int k = 0; k < nch; ++k) {
        const int s = k % kWS;
        mbar_wait(win_empty(s), ((k / kWS) & 1) ^ 1);
        mbar_expect_tx(win_full(s), win_tx);
        tma_load(win(s), &tx, win_full(s), (c_begin + k) * kAtom, j0 - 1,
                 i0 - 1, b0);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x;  // 0 .. kCT - 1
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;
  const int img_pix = a.rows * TW;             // tile pixels an image
  const int img_lines = (a.rows + 2) * kWinW;  // window lines an image

  // this lane's ldmatrix row: tile pixel m, its window line at tap (0, 0)
  int line0 = 0;
  {
    const int m = wg * 64 + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int slot = m / img_pix, rem = m % img_pix;
    if (slot < a.nb) line0 = slot * img_lines + (rem / TW) * kWinW + rem % TW;
  }
  const int hi = lane >> 4;  // the 8-channel half of a k16 step it loads

  // The prologue over one staged window into a V buffer: thread ct takes
  // the 16-byte group q = ct % 8 of lines ct / 8 + i * kCT / 8; `part` of
  // `parts` takes the i with i % parts == part, so that a chunk's prologue
  // can run in nine slices beside the previous chunk's nine taps.
  const int q = ct & 7;
  auto transform = [&](int s, uint32_t vb, int chunk, int part, int parts) {
    const uint8_t* src = gbase + (win(s) - base);
    uint8_t* dst = gbase + (vb - base);
    const int cbase = chunk * kAtom + 8 * q;
    uint32_t ac[8];  // a, c of the 8 channels as bf16 pairs
    int cur = -1;    // the image whose a, c ac holds
#pragma unroll 1
    for (int L = (ct >> 3) + part * (kCT / 8); L < a.win_lines;
         L += parts * (kCT / 8)) {
      int slot = 0, rem = L;
      if (a.nb > 1) {
        slot = L / img_lines;
        rem = L - slot * img_lines;
      }
      const int bimg = b0 + slot;
      const int y = i0 - 1 + rem / kWinW, x = j0 - 1 + rem % kWinW;
      const uint32_t off = L * 128 + ((q ^ (L & 7)) << 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (bimg < a.B && y >= 0 && y < a.H && x >= 0 && x < a.W) {
        v = *reinterpret_cast<const uint4*>(src + off);
        if (a.gn_a != nullptr) {
          if (bimg != cur) {
            cur = bimg;
            const float* pa = a.gn_a + bimg * a.a_stride + cbase;
            const float* pc = a.gn_c + bimg * a.c_stride + cbase;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              ac[e] = cbase + e < a.Cin ? pack_bf16(__ldg(pa + e),
                                                    __ldg(pc + e))
                                        : 0u;
          }
          v.x = gn_silu2(v.x, ac[0], ac[1]);
          v.y = gn_silu2(v.y, ac[2], ac[3]);
          v.z = gn_silu2(v.z, ac[4], ac[5]);
          v.w = gn_silu2(v.w, ac[6], ac[7]);
        }
      }
      *reinterpret_cast<uint4*>(dst + off) = v;
    }
  };
  auto vbuf = [&](int k) { return vbase + (k & 1) * a.win_bytes; };

  // chunk 0's prologue alone; then chunk k + 1's in slices beside chunk k's
  // taps, into the other V buffer. PLAIN reads each chunk's window stage
  // itself and hands it back after its nine taps' loads. F32: the tables
  // of chunks 0 and 1 first, chunk k + 2's beside chunk k's taps.
  if constexpr (has(AFF, kF32Affine)) {
    const Affine<TW, NC, AFF> f{a, gbase + red_off, ct, b0, i0, j0, c_begin};
    if constexpr (has(AFF, kFold)) {
      f.fold(nch);
      bar_sync(1, kCT);
    }
    f.fill(0);
    if (nch > 1) f.fill(1);
    bar_sync(1, kCT);
    mbar_wait(win_full(0), 0);
    f.transform(gbase + (win(0) - base), gbase + (vbuf(0) - base), 0, 0, 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(win_empty(0));
    bar_sync(1, kCT);  // V holds chunk 0
  } else if constexpr (!PLAIN) {
    mbar_wait(win_full(0), 0);
    transform(0, vbuf(0), c_begin, 0, 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(win_empty(0));
    bar_sync(1, kCT);  // V holds chunk 0
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[4][4];
  int bs = 0, bph = 0, prev = 0;
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const bool next = k + 1 < nch;
    const int nws = (k + 1) % kWS;
    if constexpr (PLAIN)
      mbar_wait(win_full(k % kWS), (k / kWS) & 1);
    else if (next)
      mbar_wait(win_full(nws), ((k + 1) / kWS) & 1);
    const uint32_t abuf = PLAIN ? win(k % kWS) : vbuf(k);
    // not unrolled: the taps' shifted addresses would all stay live
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      mbar_wait(b_full(bs), bph);
      // the previous tap's products are done: its registers and stage
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(afr);
      if (k > 0 || tap > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty(prev));
      }
      const int L = line0 + (tap / 3) * kWinW + tap % 3;
      const uint32_t row = abuf + L * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(afr[kk], row + (((2 * kk + hi) ^ (L & 7)) << 4));
      wg_fence();
      const uint32_t bt = bring + bs * kBBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma128::rs_t(acc, afr[kk],
                       desc128(bt + kk * 16 * 128, kAtom * 128));
      wg_commit();
      // a ninth of the next chunk's prologue while these products run
      if constexpr (has(AFF, kF32Affine)) {
        if (next)
          Affine<TW, NC, AFF>{a, gbase + red_off, ct, b0, i0, j0, c_begin}
              .transform(gbase + (win(nws) - base),
                         gbase + (vbuf(k + 1) - base), k + 1, tap, 9);
      } else if constexpr (!PLAIN) {
        if (next) transform(nws, vbuf(k + 1), c_begin + k + 1, tap, 9);
      }
      prev = bs;
      if (++bs == a.stages) bs = 0, bph ^= 1;
    }
    if constexpr (PLAIN) {
      // the chunk's window has been read into registers
      __syncwarp();
      if (lane == 0) mbar_arrive(win_empty(k % kWS));
    } else if (next) {
      __syncwarp();
      if (lane == 0) mbar_arrive(win_empty(nws));
      // chunk k's table is free: chunk k + 2's, published by the barrier
      if constexpr (has(AFF, kF32Affine))
        if (k + 2 < nch)
          Affine<TW, NC, AFF>{a, gbase + red_off, ct, b0, i0, j0, c_begin}
              .fill(k + 2);
      // the next V is complete, and every warp is done with this one
      bar_sync(1, kCT);
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(afr);

  // ---- split K: the last split of the tile adds all in split order ----
  const long long tile_mn =
      static_cast<long long>(mt) * gridDim.x + blockIdx.x;
  if (a.splits > 1) {
    float2* mine = reinterpret_cast<float2*>(
        a.ws + (tile_mn * a.splits + split) * kPix * kBN);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      __stcg(mine + i * kCT + ct, make_float2(acc[2 * i], acc[2 * i + 1]));
    __threadfence();
    bar_sync(1, kCT);
    if (ct == 0) *flag = atomicAdd(a.counters + tile_mn, 1);
    bar_sync(1, kCT);
    if (*flag != a.splits - 1) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < a.splits; ++s) {
      const float2* part = reinterpret_cast<const float2*>(
          a.ws + (tile_mn * a.splits + s) * kPix * kBN);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 v = __ldcg(part + i * kCT + ct);
        acc[2 * i] += v.x;
        acc[2 * i + 1] += v.y;
      }
    }
  }

  // ---- epilogue ----
  // tile pixel p -> its output element offset, if it lies in the image
  auto pixel = [&](int p, long long& off) {
    const int slot = p / img_pix, rem = p % img_pix;
    const int b = b0 + slot, y = i0 + rem / TW, x = j0 + rem % TW;
    if (slot >= a.nb || b >= a.B || y >= a.H || x >= a.W) return false;
    off = ((static_cast<long long>(b) * a.H + y) * a.W + x) * a.Cs;
    return true;
  };
  const bool vec = a.Cs % 8 == 0;
  // the bf16 output tile, kPix rows of kBN channels, aliases the windows
  uint8_t* const stage = gbase;
  bar_sync(1, kCT);  // every warp's last ldmatrix of V is done
  if (!PLAIN && a.residual != nullptr) {
#pragma unroll 1
    for (int v = ct; v < kPix * (kBN / 8); v += kCT) {
      const int p = v / (kBN / 8), c = v % (kBN / 8), n = n0 + 8 * c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      long long off;
      if (pixel(p, off) && n < a.Cs) {
        if (vec) {
          val = *reinterpret_cast<const uint4*>(a.residual + off + n);
        } else {
          bf16* e = reinterpret_cast<bf16*>(&val);
          for (int j = 0; j < 8 && n + j < a.Cs; ++j)
            e[j] = a.residual[off + n + j];
        }
      }
      *reinterpret_cast<uint4*>(stage + p * kBN * 2 + ((c ^ (p & 7)) * 16)) =
          val;
    }
    bar_sync(1, kCT);
  }
  // this thread's rows r0 and r0 + 8 of the warpgroup's 64 pixels
  const int r0 = 16 * warp + g;
  long long off;
  const bool ok0 = pixel(wg * 64 + r0, off);
  const bool ok1 = pixel(wg * 64 + r0 + 8, off);
  float* const red = reinterpret_cast<float*>(gbase + red_off);
  uint8_t* const st = stage + wg * 64 * kBN * 2;
  const int wid = wg * 4 + warp;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = 8 * i + 2 * tq4;
    const bool okn0 = n0 + n < a.Cs, okn1 = n0 + n + 1 < a.Cs;
    float bv0 = 0.0f, bv1 = 0.0f;
    if (a.bias != nullptr) {
      if (okn0) bv0 = __bfloat162float(a.bias[n0 + n]);
      if (okn1) bv1 = __bfloat162float(a.bias[n0 + n + 1]);
    }
    if constexpr (has(AFF, kOneRound)) {
      // acc + bias [+ temb of the image this warp's 16 rows lie in]
      // [+ residual] in fp32, one rounding
      float t0 = 0.0f, t1 = 0.0f;
      const int slot = (wg * 64 + 16 * warp) / img_pix;
      if (a.temb != nullptr && slot < a.nb && b0 + slot < a.B) {
        const bf16* trow =
            a.temb + static_cast<long long>(b0 + slot) * a.Cs + n0;
        if (okn0) t0 = __bfloat162float(trow[n]);
        if (okn1) t1 = __bfloat162float(trow[n + 1]);
      }
      float v0 = acc[4 * i] + bv0 + t0, v1 = acc[4 * i + 1] + bv1 + t1;
      float v2 = acc[4 * i + 2] + bv0 + t0, v3 = acc[4 * i + 3] + bv1 + t1;
      uint32_t* const p0 = reinterpret_cast<uint32_t*>(
          st + r0 * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
      uint32_t* const p1 = reinterpret_cast<uint32_t*>(
          st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
      if (a.residual != nullptr) {
        const uint32_t ra = *p0, rb = *p1;
        v0 += lo_bf16(ra), v1 += hi_bf16(ra);
        v2 += lo_bf16(rb), v3 += hi_bf16(rb);
      }
      *p0 = pack_bf16(v0, v1);
      *p1 = pack_bf16(v2, v3);
      continue;
    }
    float v0 = round_bf16(acc[4 * i] + bv0);
    float v1 = round_bf16(acc[4 * i + 1] + bv1);
    float v2 = round_bf16(acc[4 * i + 2] + bv0);
    float v3 = round_bf16(acc[4 * i + 3] + bv1);
    uint32_t* const p0 = reinterpret_cast<uint32_t*>(
        st + r0 * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
    uint32_t* const p1 = reinterpret_cast<uint32_t*>(
        st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
    if (!PLAIN && a.residual != nullptr) {
      const uint32_t ra = *p0, rb = *p1;
      v0 = round_bf16(v0 + lo_bf16(ra));
      v1 = round_bf16(v1 + hi_bf16(ra));
      v2 = round_bf16(v2 + lo_bf16(rb));
      v3 = round_bf16(v3 + hi_bf16(rb));
    }
    *p0 = pack_bf16(v0, v1);
    *p1 = pack_bf16(v2, v3);
    if (!PLAIN && a.stats != nullptr) {
      const float u0 = ok0 && okn0 ? v0 : 0.0f, u1 = ok0 && okn1 ? v1 : 0.0f;
      const float u2 = ok1 && okn0 ? v2 : 0.0f, u3 = ok1 && okn1 ? v3 : 0.0f;
      float s10 = u0 + u2, s11 = u1 + u3;
      float s20 = u0 * u0 + u2 * u2, s21 = u1 * u1 + u3 * u3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s10 += __shfl_xor_sync(0xffffffffu, s10, o);
        s11 += __shfl_xor_sync(0xffffffffu, s11, o);
        s20 += __shfl_xor_sync(0xffffffffu, s20, o);
        s21 += __shfl_xor_sync(0xffffffffu, s21, o);
      }
      if (g == 0) {
        float* rw = red + wid * 2 * kBN;
        rw[n] = s10, rw[n + 1] = s11;
        rw[kBN + n] = s20, rw[kBN + n + 1] = s21;
      }
    }
  }
  bar_sync(1, kCT);
  if (!PLAIN && a.stats != nullptr) {
    // image slot k of the tile: the warps whose 16 rows it holds, in order
#pragma unroll 1
    for (int v = ct; v < a.nb * 2 * kBN; v += kCT) {
      const int k = v / (2 * kBN), row = (v / kBN) % 2, n = v % kBN;
      const int b = b0 + k;
      if (b >= a.B || n0 + n >= a.Cs) continue;
      float sum = 0.0f;
      for (int w = 0; w < 4 * NC; ++w)
        if (16 * w / img_pix == k) sum += red[(w * 2 + row) * kBN + n];
      float* const dst =
          a.tpi == 1
              ? a.stats + static_cast<long long>(b) * 2 * a.Cs
              : a.partial +
                    (static_cast<long long>(b) * a.tpi + timg) * 2 * a.Cs;
      dst[row * a.Cs + n0 + n] = sum;
    }
  }
#pragma unroll 1
  for (int v = ct; v < kPix * (kBN / 8); v += kCT) {
    const int p = v / (kBN / 8), c = v % (kBN / 8), n = n0 + 8 * c;
    long long off;
    if (!pixel(p, off) || n >= a.Cs) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + p * kBN * 2 + ((c ^ (p & 7)) * 16));
    if (vec) {
      *reinterpret_cast<uint4*>(a.out + off + n) = val;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
      for (int j = 0; j < 8 && n + j < a.Cs; ++j) a.out[off + n + j] = e[j];
    }
  }
}

// K4: warpgroup p computes parity plane (ry, rx) = (p / 2, p % 2) of the
// same 64 source pixels; no producer warps (the header says why). STATS:
// K6, the statistics of y before its rounding.
template <int TW, bool STATS>
__global__ void __launch_bounds__(128 * kUpWG, 1)
upconv_sm90(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw, const GnArgs a) {
  constexpr int kWinW = TW + 2;
  constexpr int kCT = 128 * kUpWG;   // threads
  constexpr int kRows = 64 * kUpWG;  // a tile's output rows: 64 a plane
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int bar_off = a.region0 + a.stages * kBBytes;
  auto win = [&](int s) { return base + s * a.win_bytes; };
  const uint32_t bring = base + a.region0;
  auto win_full = [&](int s) { return base + bar_off + 8 * s; };
  auto win_empty = [&](int s) {
    return base + bar_off + 8 * (kWinStages + s);
  };
  auto b_full = [&](int s) {
    return base + bar_off + 8 * (2 * kWinStages + s);
  };
  int* const flag = reinterpret_cast<int*>(
      gbase + bar_off + 8 * (2 * kWinStages + kUpMaxStages));

  const int n0 = blockIdx.x * kBN;
  const int mt = blockIdx.y, split = blockIdx.z;
  int b0, i0 = 0, j0 = 0, timg = 0;
  if (a.tpi == 1) {
    b0 = mt * a.nb;  // whole images
  } else {
    b0 = mt / a.tpi;
    timg = mt % a.tpi;
    i0 = (timg / a.tiles_w) * a.rows;
    j0 = (timg % a.tiles_w) * TW;
  }
  const int c_begin = split * a.per_split;
  const int nch = min(a.per_split, a.chunks - c_begin);

  const int ct = threadIdx.x;
  const int wg = ct / 128;  // the parity plane
  const int ry = wg >> 1, rx = wg & 1;
  const int warp = (ct % 128) / 32, lane = ct % 32;
  const int g = lane / 4, tq4 = lane % 4;
  const bool issuer = warp == 0 && lane == 0;
  // the plane's stages wg, wg + 4, ...: spw of them, tap i in the
  // (i % spw)-th
  const int spw = a.stages / kUpWG;
  const int ntap = 4 * nch;

  if (ct == 0) {
    for (int s = 0; s < kWinStages; ++s) {
      mbar_init(win_full(s), 1);
      mbar_init(win_empty(s), kUpWG * 4);  // lane 0 of each warp
    }
    for (int s = 0; s < a.stages; ++s) mbar_init(b_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this plane's tap i: chunk i / 4, (ai, bi) = (t / 2, t % 2) for
  // t = i % 4, taps[p * 4 + t]
  auto issue_taps = [&](int i) {
    const int s = wg + kUpWG * (i % spw);
    const uint32_t dst = bring + s * kBBytes;
    const int c0 = (c_begin + i / 4) * kAtom, tap = wg * 4 + i % 4;
    mbar_expect_tx(b_full(s), kBBytes);
    tma_load(dst, &tw, b_full(s), n0, c0, tap, 0);
    tma_load(dst + kAtom * 128, &tw, b_full(s), n0 + kAtom, c0, tap, 0);
  };
  auto issue_window = [&](int k) {
    const int s = k % kWinStages;
    mbar_expect_tx(win_full(s), a.win_lines * 128);
    tma_load(win(s), &tx, win_full(s), (c_begin + k) * kAtom, j0 - 1, i0 - 1,
             b0);
  };
  if (ct == 0)
    for (int k = 0; k < kWinStages && k < nch; ++k) issue_window(k);
  if (issuer)
    for (int i = 0; i < spw && i < ntap; ++i) issue_taps(i);

  const int img_pix = a.rows * TW;
  const int img_lines = (a.rows + 2) * kWinW;
  // this lane's ldmatrix row: source pixel m, its window line at shift
  // (ry, rx); the plane's taps (ai, bi) add (ai, bi) to it
  int line0 = 0;
  {
    const int m = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int slot = m / img_pix, rem = m % img_pix;
    if (slot < a.nb)
      line0 = slot * img_lines + (rem / TW + ry) * kWinW + rem % TW + rx;
  }
  const int hi = lane >> 4;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[4][4];
  int j = 0, ph = 0;  // the stage (wg + 4 j) and its phase of the next tap
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const int ws = k % kWinStages;
    // chunk k + 1's window, once every warp is done with chunk k - 1's
    if (ct == 0 && k >= 1 && k + 1 < nch) {
      mbar_wait(win_empty((k + 1) % kWinStages),
                ((k - 1) / kWinStages) & 1);
      issue_window(k + 1);
    }
    mbar_wait(win_full(ws), (k / kWinStages) & 1);
#pragma unroll 1
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * k + t;
      const int bs = wg + kUpWG * j;
      mbar_wait(b_full(bs), ph);
      // the previous tap's products are done: its registers, and its
      // stage takes the tap spw - 1 ahead once every warp is past it
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(afr);
      if (i > 0 && i + spw - 1 < ntap) {
        bar_sync(2 + wg, 128);
        if (issuer) issue_taps(i + spw - 1);
      }
      const int L = line0 + (t >> 1) * kWinW + (t & 1);
      const uint32_t row = win(ws) + L * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(afr[kk], row + (((2 * kk + hi) ^ (L & 7)) << 4));
      wg_fence();
      const uint32_t bt = bring + bs * kBBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma128::rs_t(acc, afr[kk],
                       desc128(bt + kk * 16 * 128, kAtom * 128));
      wg_commit();
      if (++j == spw) j = 0, ph ^= 1;
    }
    // the chunk's window has been read into registers
    __syncwarp();
    if (lane == 0) mbar_arrive(win_empty(ws));
  }
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(afr);

  // ---- split K: the last split of the tile adds all in split order ----
  const long long tile_mn =
      static_cast<long long>(mt) * gridDim.x + blockIdx.x;
  if (a.splits > 1) {
    float2* mine = reinterpret_cast<float2*>(
        a.ws + (tile_mn * a.splits + split) * kRows * kBN);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      __stcg(mine + i * kCT + ct, make_float2(acc[2 * i], acc[2 * i + 1]));
    __threadfence();
    bar_sync(1, kCT);
    if (ct == 0) *flag = atomicAdd(a.counters + tile_mn, 1);
    bar_sync(1, kCT);
    if (*flag != a.splits - 1) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < a.splits; ++s) {
      const float2* part = reinterpret_cast<const float2*>(
          a.ws + (tile_mn * a.splits + s) * kRows * kBN);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 v = __ldcg(part + i * kCT + ct);
        acc[2 * i] += v.x;
        acc[2 * i + 1] += v.y;
      }
    }
  }

  // ---- epilogue: + bias, one rounding; the four planes' bf16 tiles
  // staged over the windows and the ring (rows of 128 channels, 16-byte
  // chunks XOR-swizzled by row), then stored as 16-byte rows. STATS: the
  // (sum, sumsq) of the values before their rounding, each 8-column group
  // added over the thread's two rows and the warp's 8 row groups, into
  // per-warp sums past the staged tiles ----
  uint8_t* const stage = gbase;
  bar_sync(1, kCT);  // every warp's last ldmatrix and products are done
  const int r0 = 16 * warp + g;
  uint8_t* const st = stage + wg * 64 * kBN * 2;
  float* const red = reinterpret_cast<float*>(gbase + kRows * kBN * 2);
  // source pixel m of the tile lies in an image
  auto inside = [&](int m) {
    const int slot = m / img_pix, rem = m % img_pix;
    return slot < a.nb && b0 + slot < a.B && i0 + rem / TW < a.H &&
           j0 + rem % TW < a.W;
  };
  const bool ok0 = STATS && inside(r0), ok1 = STATS && inside(r0 + 8);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = 8 * i + 2 * tq4;
    const bool okn0 = n0 + n < a.Cs, okn1 = n0 + n + 1 < a.Cs;
    float bv0 = 0.0f, bv1 = 0.0f;
    if (a.bias != nullptr) {
      if (okn0) bv0 = __bfloat162float(a.bias[n0 + n]);
      if (okn1) bv1 = __bfloat162float(a.bias[n0 + n + 1]);
    }
    const float v0 = acc[4 * i] + bv0, v1 = acc[4 * i + 1] + bv1;
    const float v2 = acc[4 * i + 2] + bv0, v3 = acc[4 * i + 3] + bv1;
    *reinterpret_cast<uint32_t*>(st + r0 * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) = pack_bf16(v0, v1);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) = pack_bf16(v2, v3);
    if constexpr (STATS) {
      const float u0 = ok0 && okn0 ? v0 : 0.0f, u1 = ok0 && okn1 ? v1 : 0.0f;
      const float u2 = ok1 && okn0 ? v2 : 0.0f, u3 = ok1 && okn1 ? v3 : 0.0f;
      float s10 = u0 + u2, s11 = u1 + u3;
      float s20 = u0 * u0 + u2 * u2, s21 = u1 * u1 + u3 * u3;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s10 += __shfl_xor_sync(0xffffffffu, s10, o);
        s11 += __shfl_xor_sync(0xffffffffu, s11, o);
        s20 += __shfl_xor_sync(0xffffffffu, s20, o);
        s21 += __shfl_xor_sync(0xffffffffu, s21, o);
      }
      if (g == 0) {
        float* rw = red + (wg * 4 + warp) * 2 * kBN;
        rw[n] = s10, rw[n + 1] = s11;
        rw[kBN + n] = s20, rw[kBN + n + 1] = s21;
      }
    }
  }
  bar_sync(1, kCT);
  if constexpr (STATS) {
    // image slot k of the tile: plane by plane, the warps whose 16 source
    // rows it holds, in order
#pragma unroll 1
    for (int v = ct; v < a.nb * 2 * kBN; v += kCT) {
      const int k = v / (2 * kBN), row = (v / kBN) % 2, n = v % kBN;
      const int b = b0 + k;
      if (b >= a.B || n0 + n >= a.Cs) continue;
      float sum = 0.0f;
      for (int w = 0; w < 4 * kUpWG; ++w)
        if (16 * (w % 4) / img_pix == k) sum += red[(w * 2 + row) * kBN + n];
      float* const dst =
          a.tpi == 1
              ? a.stats + static_cast<long long>(b) * 2 * a.Cs
              : a.partial +
                    (static_cast<long long>(b) * a.tpi + timg) * 2 * a.Cs;
      dst[row * a.Cs + n0 + n] = sum;
    }
  }
  const int H2 = 2 * a.H, W2 = 2 * a.W;
#pragma unroll 1
  for (int v = ct; v < kRows * (kBN / 8); v += kCT) {
    // channel chunk fastest, then rx, then the source pixel, then ry
    const int c = v % (kBN / 8), prx = (v / (kBN / 8)) % 2;
    const int p = (v / (2 * (kBN / 8))) % 64, pry = v / (128 * (kBN / 8));
    const int n = n0 + 8 * c;
    const int slot = p / img_pix, rem = p % img_pix;
    const int b = b0 + slot, y = i0 + rem / TW, x = j0 + rem % TW;
    if (slot >= a.nb || b >= a.B || y >= a.H || x >= a.W || n >= a.Cs)
      continue;
    const long long off =
        ((static_cast<long long>(b) * H2 + 2 * y + pry) * W2 + 2 * x + prx) *
            a.Cs + n;
    *reinterpret_cast<uint4*>(a.out + off) =
        *reinterpret_cast<const uint4*>(stage +
                                        ((pry * 2 + prx) * 64 + p) * kBN * 2 +
                                        ((c ^ (p & 7)) * 16));
  }
}

GnPlan plan_of(int nc, int B, int H, int W, int Cin, int Cout) {
  GnPlan p{};
  const int pix = 64 * nc;
  p.nc = nc;
  p.tw = W <= 4 ? 4 : W <= 8 ? 8 : 16;
  if (W <= p.tw && H * p.tw <= pix) {
    // whole images: rows a multiple of 16 / tw, so that each warp's 16
    // rows lie in one image
    const int unit = 16 / p.tw;
    p.rows = (H + unit - 1) / unit * unit;
    p.nb = pix / (p.rows * p.tw) < B ? pix / (p.rows * p.tw) : B;
    p.tiles_h = p.tiles_w = 1;
    p.m_tiles = (B + p.nb - 1) / p.nb;
  } else {
    p.rows = pix / p.tw;
    p.nb = 1;
    p.tiles_h = (H + p.rows - 1) / p.rows;
    p.tiles_w = (W + p.tw - 1) / p.tw;
    p.m_tiles = B * p.tiles_h * p.tiles_w;
  }
  p.tpi = p.tiles_h * p.tiles_w;
  p.win_lines = p.nb * (p.rows + 2) * (p.tw + 2);
  p.win_bytes = (p.win_lines * 128 + 1023) / 1024 * 1024;
  // the windows and the two V buffers, or the bf16 output staging that
  // aliases them
  p.region0 = 4 * p.win_bytes > pix * kBN * 2 ? 4 * p.win_bytes
                                              : pix * kBN * 2;
  // the B stages, the per-warp statistics, the mbarriers and the split
  // flag, 1024 bytes of slack to align the base
  const int fixed = p.region0 + 4 * nc * 2 * kBN * 4 +
                    8 * 2 * (kWinStages + kMaxBStages) + 16 + 1024;
  p.stages = (kSmemLimit - fixed) / kBBytes;
  if (p.stages > kMaxBStages) p.stages = kMaxBStages;
  p.smem = fixed + p.stages * kBBytes;
  p.n_tiles = (Cout + kBN - 1) / kBN;
  p.chunks = (Cin + kAtom - 1) / kAtom;
  return p;
}

// Two consumer warpgroups unless that grid would leave more than half of
// the SMs idle; then the chunks split over as many CTAs as fill the SMs
// once, each split a run of whole chunks. `nc` 1 or 2 and `splits` > 0
// force the choices (mirrored by ops/gn_conv.py gn_conv_sm90_plan).
GnPlan plan(int B, int H, int W, int Cin, int Cout, int nc, int splits) {
  GnPlan p = plan_of(2, B, H, W, Cin, Cout);
  if (!(nc == 2 || (nc == 0 && 2LL * p.m_tiles * p.n_tiles >= kSMs)))
    p = plan_of(1, B, H, W, Cin, Cout);
  const long long blocks = static_cast<long long>(p.m_tiles) * p.n_tiles;
  long long s = splits > 0 ? splits : blocks >= kSMs ? 1 : kSMs / blocks;
  if (s > p.chunks) s = p.chunks;
  p.per_split = static_cast<int>((p.chunks + s - 1) / s);
  p.splits = (p.chunks + p.per_split - 1) / p.per_split;
  return p;
}

// K4's plan: K1/K5's one-warpgroup tile of 64 source pixels, two window
// stages (no V buffers: no prologue), B stages a multiple of the four
// planes; K split as plan() splits it. `splits` > 0 forces the split
// (mirrored by ops/gn_conv.py upconv_sm90_plan).
GnPlan up_plan(int B, int H, int W, int Cin, int Cout, int splits) {
  GnPlan p = plan_of(1, B, H, W, Cin, Cout);
  p.nc = kUpWG;  // the split tiles hold the four planes' 64 rows each
  p.region0 = kWinStages * p.win_bytes;
  const int fixed =
      p.region0 + 8 * (2 * kWinStages + kUpMaxStages) + 16 + 1024;
  p.stages = (kSmemLimit - fixed) / kBBytes / kUpWG * kUpWG;
  if (p.stages > kUpMaxStages) p.stages = kUpMaxStages;
  p.smem = fixed + p.stages * kBBytes;
  const long long blocks = static_cast<long long>(p.m_tiles) * p.n_tiles;
  long long s = splits > 0 ? splits : blocks >= kSMs ? 1 : kSMs / blocks;
  if (s > p.chunks) s = p.chunks;
  p.per_split = static_cast<int>((p.chunks + s - 1) / s);
  p.splits = (p.chunks + p.per_split - 1) / p.per_split;
  return p;
}

// K7's plan: K1/K5's tile, consumer warpgroups and split of K (plan()),
// but where that takes one consumer warpgroup to split K, two consumers
// splitting deeper over as many CTAs where their tiles are full and each
// split keeps at least kSameMinChunks chunks (the UNet's 16^2 level at
// Cin >= 960: each B stage read for 128 pixels, not 64); the shared
// memory of the two V buffers goes to a third window stage and to B
// stages (mirrored by ops/gn_conv.py same_sm90_plan).
GnPlan same_plan(int B, int H, int W, int Cin, int Cout, int nc,
                 int splits) {
  GnPlan p = plan(B, H, W, Cin, Cout, nc, splits);
  if (nc == 0 && splits == 0 && p.nc == 1 && p.splits > 1) {
    const GnPlan q = plan(B, H, W, Cin, Cout, 2, 0);
    if (static_cast<long long>(q.m_tiles) * 128 ==
            static_cast<long long>(B) * H * W &&
        q.per_split >= kSameMinChunks)
      p = q;
  }
  // the windows, or the bf16 output staging that aliases them
  const int staging = 64 * p.nc * kBN * 2;
  p.region0 = kSameWinStages * p.win_bytes > staging
                  ? kSameWinStages * p.win_bytes
                  : staging;
  const int fixed = p.region0 +
                    8 * 2 * (kSameWinStages + kSameMaxBStages) + 16 + 1024;
  p.stages = (kSmemLimit - fixed) / kBBytes;
  if (p.stages > kSameMaxBStages) p.stages = kSameMaxBStages;
  p.smem = fixed + p.stages * kBBytes;
  return p;
}

// The affine modes' plan (K10 with `fold`, T12 without): K1/K5's tile,
// consumer warpgroups and split of K (plan()), the per-warp statistics'
// shared memory given to the tables (mirrored by ops/gn_conv.py
// gn_silu_sm90_plan and pipelined_sm90_plan).
GnPlan affine_plan(int B, int H, int W, int Cin, int Cout, int nc,
                   int splits, bool fold) {
  GnPlan p = plan(B, H, W, Cin, Cout, nc, splits);
  const int fixed = p.region0 + affine_table_bytes(p.nc, fold) +
                    8 * 2 * (kWinStages + kMaxBStages) + 16 + 1024;
  p.stages = (kSmemLimit - fixed) / kBBytes;
  if (p.stages > kMaxBStages) p.stages = kMaxBStages;
  p.smem = fixed + p.stages * kBBytes;
  return p;
}

// The work buffer's floats: the statistics, the tile partials, the split
// tiles, the split counters.
struct WorkLayout {
  long long stats, partial, ws, counters, total;
};

WorkLayout work_layout(const GnPlan& p, int B, int Cs, bool want_stats) {
  WorkLayout w{};
  w.stats = 0;
  w.partial = want_stats ? 2LL * B * Cs : 0;
  w.ws = w.partial + (want_stats && p.tpi > 1 ? 2LL * B * p.tpi * Cs : 0);
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  w.counters = w.ws + (p.splits > 1 ? tiles * p.splits * 64 * p.nc * kBN : 0);
  w.total = w.counters + (p.splits > 1 ? tiles : 0);
  return w;
}

bool grid_fits(const GnPlan& p) {
  return p.m_tiles <= 65535 && p.n_tiles <= 65535 && p.splits <= 65535;
}

template <int NC, bool PLAIN, int AFF = 0>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const GnArgs& a, const GnPlan& p, cudaStream_t stream) {
  auto kern = p.tw == 4   ? gn_conv_sm90<4, NC, PLAIN, AFF>
              : p.tw == 8 ? gn_conv_sm90<8, NC, PLAIN, AFF>
                          : gn_conv_sm90<16, NC, PLAIN, AFF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.n_tiles, p.m_tiles, p.splits), 128 * NC + 64, p.smem,
         stream>>>(tx, tw, a);
  return cudaGetLastError();
}

template <bool STATS>
cudaError_t launch_up(const CUtensorMap& tx, const CUtensorMap& tw,
                      const GnArgs& a, const GnPlan& p,
                      cudaStream_t stream) {
  auto kern = p.tw == 4   ? upconv_sm90<4, STATS>
              : p.tw == 8 ? upconv_sm90<8, STATS>
                          : upconv_sm90<16, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.n_tiles, p.m_tiles, p.splits), 128 * kUpWG, p.smem,
         stream>>>(tx, tw, a);
  return cudaGetLastError();
}

// x viewed as (C, W, H, B) in boxes of one tile's window: 64 channels by
// (tw + 2) x (rows + 2) pixels of nb images.
bool window_map(CUtensorMap* map, const void* x, int B, int H, int W,
                int Cin, const GnPlan& p) {
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[3] = {static_cast<cuuint64_t>(Cin) * 2,
                            static_cast<cuuint64_t>(W) * Cin * 2,
                            static_cast<cuuint64_t>(H) * W * Cin * 2};
  const cuuint32_t xbox[4] = {kAtom, static_cast<cuuint32_t>(p.tw + 2),
                              static_cast<cuuint32_t>(p.rows + 2),
                              static_cast<cuuint32_t>(p.nb)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, x, xd, xs, xbox, unit);
}

// w viewed as (Cout, Cin, taps) with its taps w_tap elements apart, in
// boxes of 64 x 64 (two make a tap's 128-column B stage).
bool weight_map(CUtensorMap* map, const void* w, int Cin, int Cout,
                long long w_tap, int taps) {
  const cuuint64_t wd[4] = {static_cast<cuuint64_t>(Cout),
                            static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(taps), 1};
  const cuuint64_t wsd[3] = {static_cast<cuuint64_t>(Cout) * 2,
                             static_cast<cuuint64_t>(w_tap) * 2,
                             static_cast<cuuint64_t>(w_tap) * taps * 2};
  const cuuint32_t wbox[4] = {kAtom, kAtom, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, w, wd, wsd, wbox, unit);
}

// A launch's arguments beside the plan's: the statistics, tile partials,
// split tiles and counters at their places in the work buffer `wf`; H, W
// the input's.
GnArgs args_of(const GnPlan& p, const WorkLayout& wl, float* wf,
               bool want_stats, const void* bias, void* out, int B, int H,
               int W, int Cin, int Cs) {
  GnArgs args{};
  args.bias = static_cast<const bf16*>(bias);
  args.out = static_cast<bf16*>(out);
  args.stats = want_stats ? wf + wl.stats : nullptr;
  args.partial = want_stats && p.tpi > 1 ? wf + wl.partial : nullptr;
  args.ws = p.splits > 1 ? wf + wl.ws : nullptr;
  args.counters =
      p.splits > 1 ? reinterpret_cast<int*>(wf + wl.counters) : nullptr;
  args.B = B, args.H = H, args.W = W, args.Cin = Cin, args.Cs = Cs;
  args.rows = p.rows, args.nb = p.nb, args.tiles_w = p.tiles_w;
  args.tpi = p.tpi, args.win_lines = p.win_lines;
  args.win_bytes = p.win_bytes, args.region0 = p.region0;
  args.stages = p.stages, args.per_split = p.per_split;
  args.chunks = p.chunks, args.splits = p.splits;
  return args;
}

// The split counters zeroed (when the plan splits K), the kernel, then
// each image's tile partials added in tile order (when an image spans
// tiles and the call takes statistics).
template <class Kernel>
cudaError_t run(const GnPlan& p, const GnArgs& args, cudaStream_t s,
                Kernel kernel) {
  if (p.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        args.counters, 0,
        sizeof(int) * static_cast<size_t>(p.m_tiles) * p.n_tiles, s);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = kernel();
  if (err != cudaSuccess || args.partial == nullptr) return err;
  return launch_tile_stats_reduce(args.partial, args.stats, args.B, p.tpi,
                                  args.Cs, s);
}

bool bad_shape(int B, int H, int W, int Cin, int Cout, int Cs) {
  return B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 ||
         Cout % 8 || Cs <= 0 || Cs > Cout;
}

// An affine plan's 16 fields as dtp_gn_conv3x3_sm90_plan reports a plan's,
// its work buffer floats (no statistics) last.
void affine_plan_fields(const GnPlan& p, int B, int Cs, long long* out) {
  const long long v[16] = {
      p.nc,     p.tw,      p.rows,    p.nb,        p.win_lines, p.stages,
      p.smem,   p.tiles_h, p.tiles_w, p.tpi,       p.m_tiles,   p.n_tiles,
      p.chunks, p.splits,  p.per_split,
      work_layout(p, B, Cs, false).total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}

// K10 (AFF kK10) and T12 (kT12): an affine mode's launch, no statistics;
// `mode(args)` sets the mode's own operands.
template <int AFF, class Mode>
cudaError_t affine_conv(const void* x, const void* w, const void* bias,
                        const void* residual, void* out, void* work, int B,
                        int H, int W, int Cin, int Cout, int Cs, int nc,
                        int splits, cudaStream_t s, Mode mode) {
  if (bad_shape(B, H, W, Cin, Cout, Cs) || nc < 0 || nc > 2 || splits < 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      (residual != nullptr && !aligned16(residual)))
    return cudaErrorInvalidValue;
  const GnPlan p =
      affine_plan(B, H, W, Cin, Cout, nc, splits, has(AFF, kFold));
  if (!grid_fits(p)) return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cs, false);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !weight_map(&tw, w, Cin, Cout, static_cast<long long>(Cin) * Cout, 9))
    return cudaErrorInvalidValue;
  GnArgs args = args_of(p, wl, static_cast<float*>(work), false, bias, out,
                        B, H, W, Cin, Cs);
  args.residual = static_cast<const bf16*>(residual);
  mode(args);
  return run(p, args, s, [&] {
    return p.nc == 2 ? launch<2, false, AFF>(tx, tw, args, p, s)
                     : launch<1, false, AFF>(tx, tw, args, p, s);
  });
}

// K4 (want_stats false) and K6: x (B,H,W,Cin); taps (16,Cin,Cout); bias
// (Cout,) or null; out (B,2H,2W,Cout); work: the plan's work floats (the
// statistics first, (B, 2, Cout)), or null when it needs none.
cudaError_t upconv(const void* x, const void* taps, const void* bias,
                   void* out, void* work, int B, int H, int W, int Cin,
                   int Cout, bool want_stats, int splits,
                   cudaStream_t stream) {
  if (bad_shape(B, H, W, Cin, Cout, Cout) || splits < 0 || !aligned16(x) ||
      !aligned16(taps) || !aligned16(out))
    return cudaErrorInvalidValue;
  const GnPlan p = up_plan(B, H, W, Cin, Cout, splits);
  if (!grid_fits(p)) return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cout, want_stats);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !weight_map(&tw, taps, Cin, Cout, static_cast<long long>(Cin) * Cout,
                  16))
    return cudaErrorInvalidValue;
  const GnArgs args = args_of(p, wl, static_cast<float*>(work), want_stats,
                              bias, out, B, H, W, Cin, Cout);
  return run(p, args, stream, [&] {
    return want_stats ? launch_up<true>(tx, tw, args, p, stream)
                      : launch_up<false>(tx, tw, args, p, stream);
  });
}

}  // namespace
}  // namespace dtp

// The plan of a call into out[16]: {consumer warpgroups, tile columns,
// tile rows, images a tile, window lines, B stages, dynamic shared memory
// bytes, tiles down and across an image, tiles an image's statistics span,
// M tiles, N tiles, channel chunks, splits, chunks a split, work buffer
// floats} (the tests hold ops/gn_conv.py gn_conv_sm90_plan against it);
// `nc` and `splits` as for the entry.
extern "C" int dtp_gn_conv3x3_sm90_plan(int B, int H, int W, int Cin,
                                        int Cout, int Cs, int want_stats,
                                        int nc, int splits, long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cs) || nc < 0 || nc > 2 ||
      splits < 0)
    return -1;
  const dtp::GnPlan p = dtp::plan(B, H, W, Cin, Cout, nc, splits);
  const long long v[16] = {
      p.nc,      p.tw,      p.rows,    p.nb,      p.win_lines, p.stages,
      p.smem,    p.tiles_h, p.tiles_w, p.tpi,     p.m_tiles,   p.n_tiles,
      p.chunks,  p.splits,  p.per_split,
      dtp::work_layout(p, B, Cs, want_stats != 0).total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  return 0;
}

// K1/K5 in bf16: x (B,H,W,Cin); a, c (B,Cin) fp32 rows a_stride, c_stride
// floats apart (the folded GroupNorm affine, rounded to bf16 here), or
// both null for no prologue; w (3,3,Cin,Cout) with its 9 taps w_tap
// elements apart (Cin*Cout, or more for a slice of a wider weight's input
// channels); bias (>= Cs,) or null; residual (B,H,W,Cs) or null; out
// (B,H,W,Cs), Cs <= Cout the channels stored (a zero-padded weight's
// real ones). Cin and Cout multiples of 8, x and w 16-byte aligned (TMA's
// 16-byte strides). `work`: the plan's work floats (the statistics first,
// (B, 2, Cs)), or null when want_stats is 0 and the plan does not split;
// `nc` 0 for the plan's tile, 1 or 2 to force its consumer warpgroups,
// `splits` 0 for the plan's split of K, > 0 to force one (probes).
extern "C" cudaError_t dtp_gn_conv3x3_sm90(
    const void* x, const void* a, const void* c, const void* w,
    const void* bias, const void* residual, void* out, void* work, int B,
    int H, int W, int Cin, int Cout, int Cs, long long w_tap,
    long long a_stride, long long c_stride, int want_stats, int nc,
    int splits, void* stream) {
  using namespace dtp;
  if (bad_shape(B, H, W, Cin, Cout, Cs) || nc < 0 || nc > 2 || splits < 0 ||
      w_tap < static_cast<long long>(Cin) * Cout || w_tap % 8 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      (residual != nullptr && !aligned16(residual)) ||
      ((a == nullptr) != (c == nullptr)))
    return cudaErrorInvalidValue;
  const GnPlan p = plan(B, H, W, Cin, Cout, nc, splits);
  if (!grid_fits(p)) return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cs, want_stats != 0);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !weight_map(&tw, w, Cin, Cout, w_tap, 9))
    return cudaErrorInvalidValue;
  GnArgs args = args_of(p, wl, static_cast<float*>(work), want_stats != 0,
                        bias, out, B, H, W, Cin, Cs);
  args.gn_a = static_cast<const float*>(a);
  args.gn_c = static_cast<const float*>(c);
  args.a_stride = a_stride, args.c_stride = c_stride;
  args.residual = static_cast<const bf16*>(residual);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run(p, args, s, [&] {
    return p.nc == 2 ? launch<2, false>(tx, tw, args, p, s)
                     : launch<1, false>(tx, tw, args, p, s);
  });
}

// K7's plan into out[16], the fields of dtp_gn_conv3x3_sm90_plan's (ops/
// gn_conv.py same_sm90_plan mirrors it); `nc` and `splits` as for the
// entry.
extern "C" int dtp_conv3x3_sm90_plan(int B, int H, int W, int Cin, int Cout,
                                     int nc, int splits, long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cout) || nc < 0 || nc > 2 ||
      splits < 0)
    return -1;
  const dtp::GnPlan p = dtp::same_plan(B, H, W, Cin, Cout, nc, splits);
  const long long v[16] = {
      p.nc,      p.tw,      p.rows,    p.nb,      p.win_lines, p.stages,
      p.smem,    p.tiles_h, p.tiles_w, p.tpi,     p.m_tiles,   p.n_tiles,
      p.chunks,  p.splits,  p.per_split,
      dtp::work_layout(p, B, Cout, false).total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  return 0;
}

// K7 in bf16: x (B,H,W,Cin), w (3,3,Cin,Cout), bias (Cout,) or null, out
// (B,H,W,Cout). Cin and Cout multiples of 8, x, w and out 16-byte
// aligned. `work`: the plan's work floats (the split tiles and counters),
// or null when it does not split; `nc` and `splits` as for
// dtp_gn_conv3x3_sm90.
extern "C" cudaError_t dtp_conv3x3_sm90(const void* x, const void* w,
                                        const void* bias, void* out,
                                        void* work, int B, int H, int W,
                                        int Cin, int Cout, int nc,
                                        int splits, void* stream) {
  using namespace dtp;
  if (bad_shape(B, H, W, Cin, Cout, Cout) || nc < 0 || nc > 2 ||
      splits < 0 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return cudaErrorInvalidValue;
  const GnPlan p = same_plan(B, H, W, Cin, Cout, nc, splits);
  if (!grid_fits(p)) return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cout, false);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !weight_map(&tw, w, Cin, Cout, static_cast<long long>(Cin) * Cout, 9))
    return cudaErrorInvalidValue;
  const GnArgs args = args_of(p, wl, static_cast<float*>(work), false, bias,
                              out, B, H, W, Cin, Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run(p, args, s, [&] {
    return p.nc == 2 ? launch<2, true>(tx, tw, args, p, s)
                     : launch<1, true>(tx, tw, args, p, s);
  });
}

// The plan of K4 (want_stats 0) or K6 into out[15]: {tile columns, tile
// rows, images a tile, window lines, B stages, dynamic shared memory
// bytes, tiles down and across an image, tiles an image, M tiles, N tiles,
// channel chunks, splits, chunks a split, work buffer floats} (ops/
// gn_conv.py upconv_sm90_plan mirrors it); `splits` as for the entries.
extern "C" int dtp_upsample2x_conv3x3_sm90_plan(int B, int H, int W,
                                                int Cin, int Cout,
                                                int want_stats, int splits,
                                                long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cout) || splits < 0) return -1;
  const dtp::GnPlan p = dtp::up_plan(B, H, W, Cin, Cout, splits);
  const long long v[15] = {
      p.tw,      p.rows,    p.nb,      p.win_lines, p.stages,
      p.smem,    p.tiles_h, p.tiles_w, p.tpi,       p.m_tiles,
      p.n_tiles, p.chunks,  p.splits,  p.per_split,
      dtp::work_layout(p, B, Cout, want_stats != 0).total};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

// K4 in bf16: x (B,H,W,Cin); taps (16,Cin,Cout), the folded 2x2 taps of
// the four planes; bias (Cout,) or null; out (B,2H,2W,Cout). Cin and Cout
// multiples of 8, x, taps and out 16-byte aligned. `work`: the plan's work
// floats, or null when it does not split; `splits` 0 for the plan's split
// of K, > 0 to force one (probes).
extern "C" cudaError_t dtp_upsample2x_conv3x3_sm90(
    const void* x, const void* taps, const void* bias, void* out, void* work,
    int B, int H, int W, int Cin, int Cout, int splits, void* stream) {
  return dtp::upconv(x, taps, bias, out, work, B, H, W, Cin, Cout, false,
                     splits, static_cast<cudaStream_t>(stream));
}

// K6 in bf16: K4's operands, and with want_stats the fp32 (sum, sumsq) of
// the pre-rounding output at the front of `work` as (B, 2, Cout).
extern "C" cudaError_t dtp_upsample2x_conv3x3_stats_sm90(
    const void* x, const void* taps, const void* bias, void* out, void* work,
    int B, int H, int W, int Cin, int Cout, int want_stats, int splits,
    void* stream) {
  return dtp::upconv(x, taps, bias, out, work, B, H, W, Cin, Cout,
                     want_stats != 0, splits,
                     static_cast<cudaStream_t>(stream));
}

// The plans of K10 (dtp_gn_silu_conv3x3_sm90_plan) and T12
// (dtp_gn_conv_pipelined_sm90_plan) into out[16], the fields of
// dtp_gn_conv3x3_sm90_plan's (ops/gn_conv.py gn_silu_sm90_plan and
// pipelined_sm90_plan mirror them); `nc` and `splits` as for the entries.
extern "C" int dtp_gn_silu_conv3x3_sm90_plan(int B, int H, int W, int Cin,
                                             int Cout, int Cs, int nc,
                                             int splits, long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cs) || nc < 0 || nc > 2 ||
      splits < 0)
    return -1;
  dtp::affine_plan_fields(
      dtp::affine_plan(B, H, W, Cin, Cout, nc, splits, true), B, Cs, out);
  return 0;
}

extern "C" int dtp_gn_conv_pipelined_sm90_plan(int B, int H, int W, int Cin,
                                               int Cout, int Cs, int nc,
                                               int splits, long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cs) || nc < 0 || nc > 2 ||
      splits < 0)
    return -1;
  dtp::affine_plan_fields(
      dtp::affine_plan(B, H, W, Cin, Cout, nc, splits, false), B, Cs, out);
  return 0;
}

// K10 in bf16: x (B,H,W,Cin); stats (B,2,Cin) fp32 sums of x and x^2 over
// H, W (csrc/moments.cu); scale, shift (Cin,) the GroupNorm's affine with
// `groups` groups (Cin % groups == 0, at most 128); w (3,3,Cin,Cout); bias
// (>= Cs,) or null; temb (B,Cs) or null; residual (B,H,W,Cs) or null; out
// (B,H,W,Cs), Cs <= Cout the channels stored (a zero-padded weight's real
// ones). Cin and Cout multiples of 8; x, w, out and residual 16-byte
// aligned. `work`: the plan's work floats (the split tiles and counters),
// or null when it does not split; `nc` and `splits` as for
// dtp_gn_conv3x3_sm90.
extern "C" cudaError_t dtp_gn_silu_conv3x3_sm90(
    const void* x, const void* stats, const void* scale, const void* shift,
    const void* w, const void* bias, const void* temb, const void* residual,
    void* out, void* work, float eps, int B, int H, int W, int Cin, int Cout,
    int Cs, int groups, int nc, int splits, void* stream) {
  using namespace dtp;
  if (groups <= 0 || groups > kMaxGroups || Cin % groups ||
      stats == nullptr || scale == nullptr || shift == nullptr)
    return cudaErrorInvalidValue;
  return affine_conv<kK10>(
      x, w, bias, residual, out, work, B, H, W, Cin, Cout, Cs, nc, splits,
      static_cast<cudaStream_t>(stream), [&](GnArgs& a) {
        a.gn_stats = static_cast<const float*>(stats);
        a.gn_scale = static_cast<const bf16*>(scale);
        a.gn_shift = static_cast<const bf16*>(shift);
        a.temb = static_cast<const bf16*>(temb);
        a.eps = eps;
        a.groups = groups;
      });
}

// T12 in bf16: x (B,H,W,Cin); a, c (B,Cin) fp32, contiguous; w
// (3,3,Cin,Cout); bias (>= Cs,) or null; out (B,H,W,Cs), Cs <= Cout as for
// K10. Cin and Cout multiples of 8; x, w and out 16-byte aligned. `work`,
// `nc` and `splits` as for dtp_gn_silu_conv3x3_sm90.
extern "C" cudaError_t dtp_gn_conv_pipelined_sm90(
    const void* x, const void* a, const void* c, const void* w,
    const void* bias, void* out, void* work, int B, int H, int W, int Cin,
    int Cout, int Cs, int nc, int splits, void* stream) {
  using namespace dtp;
  if (a == nullptr || c == nullptr) return cudaErrorInvalidValue;
  return affine_conv<kT12>(
      x, w, bias, nullptr, out, work, B, H, W, Cin, Cout, Cs, nc, splits,
      static_cast<cudaStream_t>(stream), [&](GnArgs& g) {
        g.gn_a = static_cast<const float*>(a);
        g.gn_c = static_cast<const float*>(c);
        g.a_stride = g.c_stride = Cin;
      });
}
