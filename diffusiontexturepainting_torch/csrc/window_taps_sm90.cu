// T11 in bf16 for Hopper (sm_90a): the nine-tap product over resident
// windows with each of the TPU tool's four tap reads, as one row-shifted
// implicit GEMM, wgmma fed by TMA.
//
//   dtp_conv_window_taps_sm90  T11 <- tools/bench_conv_shift_cost.py bench
//       / _kernel (pallas_call :110). fp32 stays on csrc/conv_arms.cu's FMA
//       twin (dtp_conv_window_taps, whose entry refuses bf16; dispatch by
//       dtype in ops/conv_variants.py conv_window_taps).
//
// What it computes. With flat = one window of xwin (nwin, H_T + 2, Wp,
// Cin) as ((H_T + 2) * Wp, Cin) rows, all four reads are one function of a
// base row and a pitch:
//     out_flat[p] = sum_tap flat[base(tap) + p] * w[tap],
//     output (h, x) = (p / pitch, p % pitch), stored where x < W
//   read       base(di, dj)                     pitch
//   shifted    di * Wp + dj                     Wp   (the VALID 3x3 conv)
//   unshifted  0                                Wp   (tap (0, 0) nine times)
//   rowflat    di * Wp + dj                     W
//   jointw     min(di * Wp, 2 * Wp - 2) + dj    Wp   (the tool's clamped
//                                                     dynamic_slice)
// w is (9, Cin, N); jointw's (3, 3 * Cin, N) is the same memory. Then
// (reps - 1) * acc[0, 0, 0] of the window, the tool's loop carry, is added
// to every element (one fixed-order fp32 block reduction: every CTA of a
// window gets the same bits) and the sum is rounded once. `reps` repeats
// the whole pass, loads and products, inside the kernel.
//
// Design. A CTA owns a tile of one window's outputs (tiles never cross a
// window), tr output rows of tw columns (tw the narrowest power of two
// from 16 up that holds W, at most the tile's 64 * NC pixels; tr * tw = 64
// * NC), by 128 output channels: NC consumer warpgroups of 64 pixels, then
// two producer warps (one issues the weights, the other the windows).
// Output row h0 + k of the tile is segment k: tw consecutive flat outputs
// from (h0 + k) * pitch + x0, so no row of the tile lies past W except in
// a ragged last column tile (128 consecutive flat rows would compute and
// drop the pitch - W columns of every output row, and the tail of a
// window's last tile: 1.5x the stored rows at W = 32).
//   - A: per 64-channel chunk, TMA brings for each segment k three boxes of
//     tw + 2 flat rows, one per di, at row base(di, 0) + (h0 + k) * pitch +
//     x0 of a 3-D map (Cin, (H_T + 2) * Wp, nwin), 128-byte swizzle, each
//     box at a 1 KiB boundary (unshifted needs one box a segment: its taps
//     all read base 0). Rows past a window's end are out of bounds and
//     arrive as zeros; they feed only outputs that are not stored. Tap
//     (di, dj) of segment k is its box di at row offset dj: its A fragments
//     are ldmatrix'ed from the swizzled box at that offset into wgmma's
//     register A operand, as the K1/K5 body reads its shifted taps. A
//     one-row offset breaks the 8-row swizzle atom that a shared-memory
//     descriptor needs, so A does not come from a descriptor.
//   - B: each tap's (64 x 128) weights w[tap, c0:c0+64, n0:n0+128] through
//     a ring of stages with full/empty mbarriers, two 64-column TMA boxes
//     over w viewed as (N, Cin, 9), MN-major (the transpose bit).
//   - Small grids split the chunks over blockIdx.z in whole chunks; each
//     split stores its fp32 tile and the last to finish (an integer
//     counter per tile, zeroed by the host before the launch) adds all
//     splits in split order and takes the carry: no float atomics, a
//     replay is bit-identical.
//   - Epilogue: + carry, one rounding, the bf16 tile staged in shared
//     memory over the A stages (16-byte chunks XOR-swizzled by row), then
//     16-byte rows of channels stored where h < H_T, x < W and n < Ns, or
//     one element at a time where Ns, the stored channels, is off 8 (a
//     weight whose N is off 8 is zero-padded by the wrapper).
// What bounds it on the H100: the tensor cores (2 * 9 * Cin * N operations
// a stored output against Cin + N elements moved); each 64 x 128 weight
// stage read from L2 for 64 * NC outputs, nine a chunk, is what keeps it
// from them (as K1/K5 and K7), with the A boxes' two extra rows a segment.
#include "conv_sm90.cuh"

namespace dtp {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kAtom = 64;      // input channels of a chunk (128 bytes)
constexpr int kBN = 128;       // output channels of a tile
constexpr int kAStages = 2;    // chunks of A boxes in flight
constexpr int kMaxBStages = 12;
constexpr int kBBytes = kAtom * kBN * 2;  // one tap's weights of a chunk
constexpr int kSMs = 132;                 // H100 SXM
constexpr int kSmemLimit = 232448;
// past the mbarriers: the split flag (16 bytes) and the carry's per-warp
// sums (8 floats)
constexpr int kTail = 16 + 32;

enum TapRead : int {
  kShifted = 0,
  kUnshifted = 1,
  kRowflat = 2,
  kJointw = 3
};

struct TapPlan {
  int nc;         // consumer warpgroups: a tile is 64 * nc flat rows
  int pitch;      // flat rows a window's output row
  int tw, tr;     // a tile: tr output rows of tw columns, tw * tr = 64 * nc
  int h_tiles, x_tiles, tiles_win;  // tiles down, across, in a window
  int m_tiles, n_tiles, chunks, splits, per_split;
  int nbox;       // A boxes a segment: one a di, one for unshifted
  int box_rows;   // tw + 2
  int box_bytes;  // box_rows * 128, rounded up to 1 KiB
  int region0;    // the A stages, or the output staging that aliases them
  int stages;     // B stages
  int smem;
};

struct TapArgs {
  const bf16* xwin;  // (nwin, H_T + 2, Wp, Cin)
  const bf16* w;     // (9, Cin, N)
  bf16* out;         // (nwin, H_T, W, Ns)
  float* ws;         // the split tiles, fp32
  int* counters;     // one per output tile when split
  int H_T, W, Wp, Cin, N, Ns, reps;
  int pitch, tw_shift, tr, x_tiles, tiles_win, nbox, box_bytes, region0;
  int stages;
  int chunks, per_split, splits;
  int box0, box1, box2;  // base(di, 0) of box di
  int dj_step;           // base(di, dj) - base(di, 0) = dj * dj_step
};

__device__ __forceinline__ int box_base(const TapArgs& a, int bx) {
  return bx == 0 ? a.box0 : bx == 1 ? a.box1 : a.box2;
}

// Grid: x = N tiles, y = (window, M tile of the window), z = split of K.
template <int NC>
__global__ void __launch_bounds__(128 * NC + 64, 1)
window_taps_sm90(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, const TapArgs a) {
  constexpr int kRows = 64 * NC;  // a tile's output pixels
  constexpr int kCT = 128 * NC;   // consumer threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int a_bytes = a.tr * a.nbox * a.box_bytes;  // one chunk's A stage
  auto astage = [&](int s) { return base + s * a_bytes; };
  const uint32_t bring = base + a.region0;
  const int bar_off = a.region0 + a.stages * kBBytes;
  auto a_full = [&](int s) { return base + bar_off + 8 * s; };
  auto a_empty = [&](int s) { return base + bar_off + 8 * (kAStages + s); };
  auto b_full = [&](int s) {
    return base + bar_off + 8 * (2 * kAStages + s);
  };
  auto b_empty = [&](int s) {
    return base + bar_off + 8 * (2 * kAStages + kMaxBStages + s);
  };
  int* const flag = reinterpret_cast<int*>(
      gbase + bar_off + 8 * 2 * (kAStages + kMaxBStages));
  float* const red = reinterpret_cast<float*>(flag + 4);

  const int n0 = blockIdx.x * kBN;
  const int mt = blockIdx.y, split = blockIdx.z;
  const int wi = mt / a.tiles_win;
  const int tile = mt - wi * a.tiles_win;
  const int h0 = (tile / a.x_tiles) * a.tr;
  const int x0 = (tile - (tile / a.x_tiles) * a.x_tiles) << a.tw_shift;
  const int tcols = 1 << a.tw_shift;  // tw, the tile's columns
  const int c_begin = split * a.per_split;
  const int nch = min(a.per_split, a.chunks - c_begin);
  const int steps = a.reps * nch;  // chunk passes, all reps

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(a_full(s), 1);
      mbar_init(a_empty(s), NC * 4);  // lane 0 of each consumer warp
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
    // first issues the weights, lane 0 of the second the A boxes ----
    if (threadIdx.x == kCT) {
      int s = 0, ph = 0;
#pragma unroll 1
      for (int i = 0; i < steps; ++i) {
        const int c0 = (c_begin + i % nch) * kAtom;
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
      const uint32_t a_tx = a.tr * a.nbox * (tcols + 2) * 128;
#pragma unroll 1
      for (int i = 0; i < steps; ++i) {
        const int s = i % kAStages;
        mbar_wait(a_empty(s), ((i / kAStages) & 1) ^ 1);
        mbar_expect_tx(a_full(s), a_tx);
        const int c0 = (c_begin + i % nch) * kAtom;
        // segment k (output row h0 + k) of box bx at its box (k, bx)
#pragma unroll 1
        for (int k = 0; k < a.tr; ++k)
#pragma unroll 1
          for (int bx = 0; bx < a.nbox; ++bx)
            tma_load(astage(s) + (k * a.nbox + bx) * a.box_bytes, &tx,
                     a_full(s), c0,
                     box_base(a, bx) + (h0 + k) * a.pitch + x0, wi, 0);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x / 128;
  const int ct = threadIdx.x;  // 0 .. kCT - 1
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;
  // this lane's ldmatrix row: tile pixel r, segment rk (output row
  // h0 + rk) at column rx, read at row rx + dj * dj_step of its boxes
  const int r = wg * 64 + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rk = r >> a.tw_shift, rx = r & (tcols - 1);
  const int hi = lane >> 4;  // the 8-channel half of a k16 step it loads

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[4][4];
  int bs = 0, bph = 0, prev = 0;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int as = i % kAStages;
    if (i > 0 && i % nch == 0) {
      // a new pass: the last one's products are done; it starts again
      wg_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    }
    mbar_wait(a_full(as), (i / kAStages) & 1);
    // not unrolled: the taps' shifted addresses would all stay live
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      mbar_wait(b_full(bs), bph);
      // the previous tap's products are done: its registers and stage
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(afr);
      if (i > 0 || tap > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty(prev));
      }
      const int di = tap / 3, dj = tap - 3 * di;
      const int L = rx + dj * a.dj_step;
      const uint32_t row = astage(as) +
                           (rk * a.nbox + (a.nbox == 3 ? di : 0)) *
                               a.box_bytes +
                           L * 128;
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
      prev = bs;
      if (++bs == a.stages) bs = 0, bph ^= 1;
    }
    // the chunk's boxes have been read into registers
    __syncwarp();
    if (lane == 0) mbar_arrive(a_empty(as));
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

  // ---- the loop carry: acc[0, 0, 0] of this window, reps - 1 times; one
  // fp32 dot over its 9 * Cin terms, reduced in a fixed order ----
  float carry = 0.0f;
  if (a.reps > 1) {
    const bf16* flat =
        a.xwin + static_cast<long long>(wi) * (a.H_T + 2) * a.Wp * a.Cin;
    float part = 0.0f;
#pragma unroll 1
    for (int i = ct; i < 9 * a.Cin; i += kCT) {
      const int tap = i / a.Cin, ch = i - tap * a.Cin;
      const int di = tap / 3, dj = tap - 3 * di;
      const int b = box_base(a, a.nbox == 3 ? di : 0) + dj * a.dj_step;
      part = fmaf(__bfloat162float(flat[static_cast<long long>(b) * a.Cin +
                                        ch]),
                  __bfloat162float(
                      a.w[(static_cast<long long>(tap) * a.Cin + ch) * a.N]),
                  part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[ct >> 5] = part;
    bar_sync(1, kCT);
    float first = 0.0f;
#pragma unroll
    for (int i = 0; i < kCT / 32; ++i) first += red[i];
    for (int k = 1; k < a.reps; ++k) carry += first;
  }

  // ---- epilogue: + carry, one rounding; the tile staged over the A
  // stages (rows of 128 channels, 16-byte chunks XOR-swizzled by row),
  // then stored as 16-byte rows ----
  uint8_t* const stage = gbase;
  bar_sync(1, kCT);  // every warp's last ldmatrix is done
  const int r0 = 16 * warp + g;
  uint8_t* const st = stage + wg * 64 * kBN * 2;
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    *reinterpret_cast<uint32_t*>(st + r0 * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) =
        pack_bf16(acc[4 * i] + carry, acc[4 * i + 1] + carry);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * kBN * 2 + ((i ^ g) * 16) +
                                 4 * tq4) =
        pack_bf16(acc[4 * i + 2] + carry, acc[4 * i + 3] + carry);
  }
  bar_sync(1, kCT);
  const bool vec = a.Ns % 8 == 0;
#pragma unroll 1
  for (int v = ct; v < kRows * (kBN / 8); v += kCT) {
    const int p = v / (kBN / 8), c = v % (kBN / 8), n = n0 + 8 * c;
    const int h = h0 + (p >> a.tw_shift), x = x0 + (p & (tcols - 1));
    if (h >= a.H_T || x >= a.W || n >= a.Ns) continue;
    const long long off =
        ((static_cast<long long>(wi) * a.H_T + h) * a.W + x) * a.Ns + n;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + p * kBN * 2 + ((c ^ (p & 7)) * 16));
    if (vec) {
      *reinterpret_cast<uint4*>(a.out + off) = val;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
      for (int j = 0; j < 8 && n + j < a.Ns; ++j) a.out[off + j] = e[j];
    }
  }
}

// base(di, 0) of box di and the dj step of `read` (the header's table).
void tap_bases(int read, int Wp, int (&box)[3], int& dj_step) {
  dj_step = read == kUnshifted ? 0 : 1;
  for (int di = 0; di < 3; ++di)
    box[di] = read == kUnshifted                  ? 0
              : read == kJointw && di * Wp > 2 * Wp - 2 ? 2 * Wp - 2
                                                        : di * Wp;
}

TapPlan plan_of(int nc, int nwin, int H_T, int W, int Wp, int Cin, int N,
                int read) {
  TapPlan p{};
  const int rows = 64 * nc;
  p.nc = nc;
  p.pitch = read == kRowflat ? W : Wp;
  // the narrowest power of two from 16 to the tile's pixels that holds W
  p.tw = 16;
  while (p.tw < W && p.tw < rows) p.tw *= 2;
  p.tr = rows / p.tw;
  p.h_tiles = (H_T + p.tr - 1) / p.tr;
  p.x_tiles = (W + p.tw - 1) / p.tw;
  p.tiles_win = p.h_tiles * p.x_tiles;
  p.m_tiles = nwin * p.tiles_win;
  p.n_tiles = (N + kBN - 1) / kBN;
  p.chunks = (Cin + kAtom - 1) / kAtom;
  p.nbox = read == kUnshifted ? 1 : 3;
  p.box_rows = p.tw + 2;
  p.box_bytes = (p.box_rows * 128 + 1023) / 1024 * 1024;
  const int staging = rows * kBN * 2;
  const int a_stages = kAStages * p.tr * p.nbox * p.box_bytes;
  p.region0 = a_stages > staging ? a_stages : staging;
  const int fixed =
      p.region0 + 8 * 2 * (kAStages + kMaxBStages) + kTail + 1024;
  p.stages = (kSmemLimit - fixed) / kBBytes;
  if (p.stages > kMaxBStages) p.stages = kMaxBStages;
  p.smem = fixed + p.stages * kBBytes;
  return p;
}

// Two consumer warpgroups (128-row tiles) unless that grid would leave
// more than half of the SMs idle; then the chunks split over as many CTAs
// as fill the SMs once, each split a run of whole chunks. `nc` 1 or 2 and
// `splits` > 0 force the choices (mirrored by ops/gn_conv.py
// taps_sm90_plan).
TapPlan plan(int nwin, int H_T, int W, int Wp, int Cin, int N, int read,
             int nc, int splits) {
  TapPlan p = plan_of(2, nwin, H_T, W, Wp, Cin, N, read);
  if (!(nc == 2 || (nc == 0 && 2LL * p.m_tiles * p.n_tiles >= kSMs)))
    p = plan_of(1, nwin, H_T, W, Wp, Cin, N, read);
  const long long blocks = static_cast<long long>(p.m_tiles) * p.n_tiles;
  long long s = splits > 0 ? splits : blocks >= kSMs ? 1 : kSMs / blocks;
  if (s > p.chunks) s = p.chunks;
  p.per_split = static_cast<int>((p.chunks + s - 1) / s);
  p.splits = (p.chunks + p.per_split - 1) / p.per_split;
  return p;
}

// The work buffer's floats: the split tiles, then the split counters.
long long work_floats(const TapPlan& p) {
  if (p.splits <= 1) return 0;
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  return tiles * p.splits * 64 * p.nc * kBN + tiles;
}

bool bad_shape(int nwin, int H_T, int W, int Wp, int Cin, int N, int read,
               int nc, int splits) {
  return nwin <= 0 || H_T <= 0 || W <= 0 || Wp < W + 2 || Cin <= 0 ||
         N <= 0 || Cin % 8 || N % 8 || read < kShifted || read > kJointw ||
         nc < 0 || nc > 2 || splits < 0 ||
         static_cast<long long>(H_T + 2) * Wp * Cin >= (1LL << 31) ||
         static_cast<long long>(nwin) * H_T * ((W + 15) / 16) >=
             (1LL << 31);
}

// A bf16 tensor map of `dims` (innermost first, the outermost 1) in boxes
// of `box`, rows of `dims[0]` elements.
bool map_3d(CUtensorMap* map, const void* base, cuuint64_t d0,
            cuuint64_t d1, cuuint64_t d2, cuuint32_t b0, cuuint32_t b1) {
  const cuuint64_t dims[4] = {d0, d1, d2, 1};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {b0, b1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return tensor_map_4d(map, base, dims, strides, box, unit);
}

template <int NC>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const TapArgs& a, const TapPlan& p, cudaStream_t stream) {
  auto kern = window_taps_sm90<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.n_tiles, p.m_tiles, p.splits), 128 * NC + 64, p.smem,
         stream>>>(tx, tw, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtp

// The plan of a call into out[17]: {consumer warpgroups, pitch, tile
// columns, tile rows, tiles down and across a window, tiles a window, M
// tiles, N tiles, channel chunks, splits, chunks a split, A boxes a
// segment, A box rows, B stages, dynamic shared memory bytes, work buffer
// floats} (ops/gn_conv.py taps_sm90_plan mirrors it); `nc` and `splits` as
// for the entry.
extern "C" int dtp_conv_window_taps_sm90_plan(int nwin, int H_T, int W,
                                              int Wp, int Cin, int N,
                                              int read, int nc, int splits,
                                              long long* out) {
  if (dtp::bad_shape(nwin, H_T, W, Wp, Cin, N, read, nc, splits)) return -1;
  const dtp::TapPlan p =
      dtp::plan(nwin, H_T, W, Wp, Cin, N, read, nc, splits);
  const long long v[17] = {
      p.nc,       p.pitch,   p.tw,     p.tr,      p.h_tiles, p.x_tiles,
      p.tiles_win, p.m_tiles, p.n_tiles, p.chunks, p.splits, p.per_split,
      p.nbox,     p.box_rows, p.stages, p.smem,   dtp::work_floats(p)};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
  return 0;
}

// T11 in bf16: xwin (nwin, H_T+2, Wp, Cin) with Wp >= W + 2; w (9, Cin, N),
// or jointw's (3, 3*Cin, N), the same memory; out (nwin, H_T, W, Ns), Ns <=
// N the channels stored (a zero-padded weight's real ones). Cin and N
// multiples of 8, xwin, w and out 16-byte aligned. read: 0 shifted, 1
// unshifted, 2 rowflat, 3 jointw; reps >= 1 passes. `work`: the plan's
// work floats (the split tiles and counters), or null when it does not
// split; `nc` 0 for the plan's tile, 1 or 2 to force its consumer
// warpgroups, `splits` 0 for the plan's split of K, > 0 to force one.
extern "C" cudaError_t dtp_conv_window_taps_sm90(
    const void* xwin, const void* w, void* out, void* work, int nwin,
    int H_T, int W, int Wp, int Cin, int N, int Ns, int read, int reps,
    int nc, int splits, void* stream) {
  using namespace dtp;
  if (bad_shape(nwin, H_T, W, Wp, Cin, N, read, nc, splits) || Ns <= 0 ||
      Ns > N || reps <= 0 || !aligned16(xwin) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const TapPlan p = plan(nwin, H_T, W, Wp, Cin, N, read, nc, splits);
  if (p.m_tiles > 65535 || p.n_tiles > 65535 || p.splits > 65535 ||
      (p.splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!map_3d(&tx, xwin, Cin, static_cast<cuuint64_t>(H_T + 2) * Wp, nwin,
              kAtom, p.box_rows) ||
      !map_3d(&tw, w, N, Cin, 9, kAtom, kAtom))
    return cudaErrorInvalidValue;
  TapArgs a{};
  a.xwin = static_cast<const bf16*>(xwin);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.ws = p.splits > 1 ? static_cast<float*>(work) : nullptr;
  a.counters = p.splits > 1
                   ? reinterpret_cast<int*>(static_cast<float*>(work) +
                                            work_floats(p) - p.m_tiles *
                                                static_cast<long long>(
                                                    p.n_tiles))
                   : nullptr;
  a.H_T = H_T, a.W = W, a.Wp = Wp, a.Cin = Cin, a.N = N, a.Ns = Ns;
  a.reps = reps;
  a.pitch = p.pitch, a.tr = p.tr, a.x_tiles = p.x_tiles;
  a.tw_shift = 0;
  while ((1 << a.tw_shift) < p.tw) ++a.tw_shift;
  a.tiles_win = p.tiles_win, a.nbox = p.nbox;
  a.box_bytes = p.box_bytes, a.region0 = p.region0, a.stages = p.stages;
  a.chunks = p.chunks, a.per_split = p.per_split, a.splits = p.splits;
  int box[3];
  tap_bases(read, Wp, box, a.dj_step);
  a.box0 = box[0], a.box1 = box[1], a.box2 = box[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        a.counters, 0,
        sizeof(int) * static_cast<size_t>(p.m_tiles) * p.n_tiles, s);
    if (err != cudaSuccess) return err;
  }
  return p.nc == 2 ? launch<2>(tx, tw, a, p, s) : launch<1>(tx, tw, a, p, s);
}
