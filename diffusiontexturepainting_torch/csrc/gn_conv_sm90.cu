// K1/K5 in bf16 for Hopper (sm_90a): GroupNorm -> SiLU -> 3x3 SAME conv
// with bias, residual and statistics epilogues, as a warp-specialised
// implicit GEMM, wgmma fed by TMA.
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
// Against conv3x3.cu's bf16 K1/K5: the prologue once per staged element
// instead of once per tap and output tile, a pipelined K loop on wgmma
// instead of load, sync, mma.sync, sync, and no fp32 round trip of the
// output through finish_stats_kernel and stats_reduce_kernel.
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

// Two bf16 of x through the prologue, as conv3x3.cu load_chunk_gn rounds;
// ac0, ac1: each channel's (a, c) rounded to bf16, a in the low half.
__device__ __forceinline__ uint32_t gn_silu2(uint32_t w, uint32_t ac0,
                                             uint32_t ac1) {
  return pack_bf16(
      silu_bf16(round_bf16(fmaf(lo_bf16(w), lo_bf16(ac0), hi_bf16(ac0)))),
      silu_bf16(round_bf16(fmaf(hi_bf16(w), lo_bf16(ac1), hi_bf16(ac1)))));
}

template <int TW, int NC>
__global__ void __launch_bounds__(128 * NC + 64, 1)
gn_conv_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw, const GnArgs a) {
  constexpr int kPix = 64 * NC;
  constexpr int kWinW = TW + 2;
  constexpr int kCT = 128 * NC;  // consumer threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int red_off = a.region0 + a.stages * kBBytes;
  const int bar_off = red_off + 4 * NC * 2 * kBN * 4;
  auto win = [&](int s) { return base + s * a.win_bytes; };
  const uint32_t vbase = base + kWinStages * a.win_bytes;  // V[2]
  const uint32_t bring = base + a.region0;
  auto win_full = [&](int s) { return base + bar_off + 8 * s; };
  auto win_empty = [&](int s) {
    return base + bar_off + 8 * (kWinStages + s);
  };
  auto b_full = [&](int s) {
    return base + bar_off + 8 * (2 * kWinStages + s);
  };
  auto b_empty = [&](int s) {
    return base + bar_off + 8 * (2 * kWinStages + kMaxBStages + s);
  };
  int* const flag = reinterpret_cast<int*>(
      gbase + bar_off + 8 * 2 * (kWinStages + kMaxBStages));

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
    for (int s = 0; s < kWinStages; ++s) {
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
        const int s = k % kWinStages;
        mbar_wait(win_empty(s), ((k / kWinStages) & 1) ^ 1);
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
  // taps, into the other V buffer
  mbar_wait(win_full(0), 0);
  transform(0, vbuf(0), c_begin, 0, 1);
  __syncwarp();
  if (lane == 0) mbar_arrive(win_empty(0));
  bar_sync(1, kCT);  // V holds chunk 0

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[4][4];
  int bs = 0, bph = 0, prev = 0;
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const bool next = k + 1 < nch;
    const int nws = (k + 1) % kWinStages;
    if (next) mbar_wait(win_full(nws), ((k + 1) / kWinStages) & 1);
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
      const uint32_t row = vbuf(k) + L * 128;
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
      if (next) transform(nws, vbuf(k + 1), c_begin + k + 1, tap, 9);
      prev = bs;
      if (++bs == a.stages) bs = 0, bph ^= 1;
    }
    if (next) {
      __syncwarp();
      if (lane == 0) mbar_arrive(win_empty(nws));
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
  if (a.residual != nullptr) {
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
    float v0 = round_bf16(acc[4 * i] + bv0);
    float v1 = round_bf16(acc[4 * i + 1] + bv1);
    float v2 = round_bf16(acc[4 * i + 2] + bv0);
    float v3 = round_bf16(acc[4 * i + 3] + bv1);
    uint32_t* const p0 = reinterpret_cast<uint32_t*>(
        st + r0 * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
    uint32_t* const p1 = reinterpret_cast<uint32_t*>(
        st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) + 4 * tq4);
    if (a.residual != nullptr) {
      const uint32_t ra = *p0, rb = *p1;
      v0 = round_bf16(v0 + lo_bf16(ra));
      v1 = round_bf16(v1 + hi_bf16(ra));
      v2 = round_bf16(v2 + lo_bf16(rb));
      v3 = round_bf16(v3 + hi_bf16(rb));
    }
    *p0 = pack_bf16(v0, v1);
    *p1 = pack_bf16(v2, v3);
    if (a.stats != nullptr) {
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
  if (a.stats != nullptr) {
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
// same 64 source pixels; no producer warps (the header says why).
template <int TW>
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
  int b0, i0 = 0, j0 = 0;
  if (a.tpi == 1) {
    b0 = mt * a.nb;  // whole images
  } else {
    b0 = mt / a.tpi;
    const int timg = mt % a.tpi;
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
  // chunks XOR-swizzled by row), then stored as 16-byte rows ----
  uint8_t* const stage = gbase;
  bar_sync(1, kCT);  // every warp's last ldmatrix and products are done
  const int r0 = 16 * warp + g;
  uint8_t* const st = stage + wg * 64 * kBN * 2;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int n = 8 * i + 2 * tq4;
    float bv0 = 0.0f, bv1 = 0.0f;
    if (a.bias != nullptr) {
      if (n0 + n < a.Cs) bv0 = __bfloat162float(a.bias[n0 + n]);
      if (n0 + n + 1 < a.Cs) bv1 = __bfloat162float(a.bias[n0 + n + 1]);
    }
    *reinterpret_cast<uint32_t*>(st + r0 * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) =
        pack_bf16(acc[4 * i] + bv0, acc[4 * i + 1] + bv1);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) =
        pack_bf16(acc[4 * i + 2] + bv0, acc[4 * i + 3] + bv1);
  }
  bar_sync(1, kCT);
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

template <int TW, int NC>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const GnArgs& a, const GnPlan& p, cudaStream_t stream) {
  auto kern = gn_conv_sm90<TW, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.n_tiles, p.m_tiles, p.splits), 128 * NC + 64, p.smem,
         stream>>>(tx, tw, a);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_tw(const CUtensorMap& tx, const CUtensorMap& tw,
                      const GnArgs& a, const GnPlan& p,
                      cudaStream_t stream) {
  switch (p.tw) {
    case 4:
      return launch<4, NC>(tx, tw, a, p, stream);
    case 8:
      return launch<8, NC>(tx, tw, a, p, stream);
    default:
      return launch<16, NC>(tx, tw, a, p, stream);
  }
}

template <int TW>
cudaError_t launch_up(const CUtensorMap& tx, const CUtensorMap& tw,
                      const GnArgs& a, const GnPlan& p,
                      cudaStream_t stream) {
  auto kern = upconv_sm90<TW>;
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

bool bad_shape(int B, int H, int W, int Cin, int Cout, int Cs) {
  return B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 ||
         Cout % 8 || Cs <= 0 || Cs > Cout;
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
  if (p.m_tiles > 65535 || p.n_tiles > 65535 || p.splits > 65535)
    return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cs, want_stats != 0);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t wd[4] = {static_cast<cuuint64_t>(Cout),
                            static_cast<cuuint64_t>(Cin), 9, 1};
  const cuuint64_t wsd[3] = {static_cast<cuuint64_t>(Cout) * 2,
                             static_cast<cuuint64_t>(w_tap) * 2,
                             static_cast<cuuint64_t>(w_tap) * 9 * 2};
  const cuuint32_t wbox[4] = {kAtom, kAtom, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !tensor_map_4d(&tw, w, wd, wsd, wbox, unit))
    return cudaErrorInvalidValue;
  float* const wf = static_cast<float*>(work);
  GnArgs args{};
  args.gn_a = static_cast<const float*>(a);
  args.gn_c = static_cast<const float*>(c);
  args.a_stride = a_stride, args.c_stride = c_stride;
  args.bias = static_cast<const bf16*>(bias);
  args.residual = static_cast<const bf16*>(residual);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (p.splits > 1) {
    err = cudaMemsetAsync(args.counters, 0,
                          sizeof(int) * static_cast<size_t>(p.m_tiles) *
                              p.n_tiles,
                          s);
    if (err != cudaSuccess) return err;
  }
  err = p.nc == 2 ? launch_tw<2>(tx, tw, args, p, s)
                  : launch_tw<1>(tx, tw, args, p, s);
  if (err != cudaSuccess || args.partial == nullptr) return err;
  return launch_tile_stats_reduce(args.partial, args.stats, B, p.tpi, Cs, s);
}

// K4's plan into out[15]: {tile columns, tile rows, images a tile, window
// lines, B stages, dynamic shared memory bytes, tiles down and across an
// image, tiles an image, M tiles, N tiles, channel chunks, splits, chunks
// a split, work buffer floats} (ops/gn_conv.py upconv_sm90_plan mirrors
// it); `splits` as for the entry.
extern "C" int dtp_upsample2x_conv3x3_sm90_plan(int B, int H, int W,
                                                int Cin, int Cout,
                                                int splits, long long* out) {
  if (dtp::bad_shape(B, H, W, Cin, Cout, Cout) || splits < 0) return -1;
  const dtp::GnPlan p = dtp::up_plan(B, H, W, Cin, Cout, splits);
  const long long v[15] = {
      p.tw,      p.rows,    p.nb,      p.win_lines, p.stages,
      p.smem,    p.tiles_h, p.tiles_w, p.tpi,       p.m_tiles,
      p.n_tiles, p.chunks,  p.splits,  p.per_split,
      dtp::work_layout(p, B, Cout, false).total};
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
  using namespace dtp;
  if (bad_shape(B, H, W, Cin, Cout, Cout) || splits < 0 || !aligned16(x) ||
      !aligned16(taps) || !aligned16(out))
    return cudaErrorInvalidValue;
  const GnPlan p = up_plan(B, H, W, Cin, Cout, splits);
  if (p.m_tiles > 65535 || p.n_tiles > 65535 || p.splits > 65535)
    return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(p, B, Cout, false);
  if (wl.total > 0 && work == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t wd[4] = {static_cast<cuuint64_t>(Cout),
                            static_cast<cuuint64_t>(Cin), 16, 1};
  const cuuint64_t tap = static_cast<cuuint64_t>(Cin) * Cout * 2;
  const cuuint64_t wsd[3] = {static_cast<cuuint64_t>(Cout) * 2, tap,
                             tap * 16};
  const cuuint32_t wbox[4] = {kAtom, kAtom, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap tx, tw;
  if (!window_map(&tx, x, B, H, W, Cin, p) ||
      !tensor_map_4d(&tw, taps, wd, wsd, wbox, unit))
    return cudaErrorInvalidValue;
  float* const wf = static_cast<float*>(work);
  GnArgs args{};
  args.bias = static_cast<const bf16*>(bias);
  args.out = static_cast<bf16*>(out);
  args.ws = p.splits > 1 ? wf + wl.ws : nullptr;
  args.counters =
      p.splits > 1 ? reinterpret_cast<int*>(wf + wl.counters) : nullptr;
  args.B = B, args.H = H, args.W = W, args.Cin = Cin, args.Cs = Cout;
  args.rows = p.rows, args.nb = p.nb, args.tiles_w = p.tiles_w;
  args.tpi = p.tpi, args.win_lines = p.win_lines;
  args.win_bytes = p.win_bytes, args.region0 = p.region0;
  args.stages = p.stages, args.per_split = p.per_split;
  args.chunks = p.chunks, args.splits = p.splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        args.counters, 0,
        sizeof(int) * static_cast<size_t>(p.m_tiles) * p.n_tiles, s);
    if (err != cudaSuccess) return err;
  }
  switch (p.tw) {
    case 4:
      return launch_up<4>(tx, tw, args, p, s);
    case 8:
      return launch_up<8>(tx, tw, args, p, s);
    default:
      return launch_up<16>(tx, tw, args, p, s);
  }
}
