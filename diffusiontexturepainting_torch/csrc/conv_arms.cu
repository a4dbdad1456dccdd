// The conv family's A/B arms: the two experiments the TPU tools ran on the
// streamed GroupNorm-SiLU-conv kernel, over the staged-window step of
// conv_staged.cuh (its patch, window pitch and block GEMM).
//
//   dtp_gn_conv_pipelined  T12 <- tools/bench_stream_pipeline.py pipelined /
//       _pipe_kernel (pallas_call :126), in fp32 only: the FMA twin. In
//       bf16 T12 runs the affine mode of csrc/gn_conv_sm90.cu (the K1/K5
//       body, its prologue on TMA's zeros too), and this entry refuses
//       bf16. What it computes, NHWC:
//         out = conv3x3_VALID(y) + bias,
//         y   = round_T(silu(xp * a[b, c] + c[b, c])) in fp32,
//       where xp is x zero-padded FIRST (one row above and below, one column
//       left and right), so the border of y is silu(c), not 0 as in K5/K10;
//       a, c are fp32 (B, Cin), given. Any H, W, Cin, Cout (the TPU
//       prototype's single Cout tile and H % H_T == 0 are its limits, not
//       the function's).
//       The question of the tool: does normalizing window h+1 overlap the
//       taps of window h? Here: a block owns a TH x TW patch and one Cout
//       tile and walks the input channels in chunks of BK. Three window
//       stages, as the TPU kernel's triple buffer: while the 9 taps of
//       chunk k run from stage k % 3, chunk k+1 (copied an iteration
//       earlier) has had its prologue applied in stage (k+1) % 3 and chunk
//       k+2 is landing in stage (k+2) % 3 by cp.async. The copy writes
//       zeros where the window leaves the image, and the prologue is then
//       applied to EVERY staged element, the zeros included. Each thread
//       normalizes the 16-byte chunks it copied itself, so its own
//       cp.async wait is the only dependency; the taps' barriers publish
//       the stage to the block. Copy and prologue of the next chunks are
//       issued before this chunk's MMAs.
//
//   dtp_conv_window_taps   T11 <- tools/bench_conv_shift_cost.py bench /
//       _kernel (pallas_call :110), in fp32 only: the FMA twin. In bf16 T11
//       runs csrc/window_taps_sm90.cu (one row-shifted wgmma/TMA GEMM for
//       all four reads), and this entry refuses bf16. What it computes:
//       nine (Cin x N) products over one window
//       xwin (H_T + 2, Wp, Cin), Wp >= W + 2, -> (H_T, W, N), fp32
//       accumulation, the tap's read one of four. With flat = xwin as
//       ((H_T + 2) * Wp, Cin) rows, tap (di, dj), output (h, w):
//         shifted    flat[(h + di) * Wp + w + dj]: the VALID 3x3 conv
//         unshifted  flat[h * Wp + w] for every tap (wrong on purpose: the
//                    same products without the shifted reads)
//         rowflat    flat[di * Wp + dj + h * W + w]: the output pitch is W,
//                    so it is the conv only where Wp == W (never)
//         jointw     flat[min(di * Wp, 2 * Wp - 2) + h * Wp + w + dj] with
//                    w as (3, 3 * Cin, N): per di the three one-pixel-shifted
//                    reads are one K = 3 * Cin product; the di = 2 start is
//                    clamped as the tool's dynamic_slice clamps it (its
//                    slice overruns the window by 2 rows), so that term
//                    reads two pixels early
//       then (reps - 1) * acc[0, 0, 0], the tool's loop carry, is added to
//       every element before the one rounding. A leading axis of windows
//       is the caller's (the tool's single window is 16 to 64 blocks).
//       One kernel, the tap read a template parameter. A block owns a
//       TH x TW patch of one window's output and one N tile; per channel
//       chunk it stages what its taps read: for shifted and unshifted the
//       patch's (TH + 2) x (TW + 2) halo window, the read of
//       conv_staged.cu; for rowflat and jointw one run of TW + 2 flat
//       pixels per (patch row, di), since their reads are not a rectangle
//       of the window. (3, 3 * Cin, N) weights are (9, Cin, N) in memory:
//       jointw's K = 3 * Cin step is three consecutive K steps into one
//       accumulator. `reps` repeats the whole pass (staging and products)
//       inside the kernel; every pass but the last is kept alive by an
//       empty asm that reads its accumulators. The carry is computed in the
//       kernel: each block takes acc[0, 0, 0] of its window as one fp32
//       dot over the 9 * Cin terms of that element (a block reduction in a
//       fixed order: every block of a window gets the same bits) and adds
//       it reps - 1 times, one after the other as the tool's loop does, in
//       the epilogue.
//
// Both: the fp32 FMA twin. No split-K, no atomics: every run gives the
// same bits.
//
// What bounds them on the H100: the fp32 FMA rate at the tools' shapes
// (2 * 9 * Cin * N flops a pixel against Cin + N elements moved). The tap
// loop is conv_staged.cu's (B per tap behind two barriers), and T11's four
// reads differ only in shared-memory addressing.
#include "conv_staged.cuh"

namespace dtp {
namespace {

// One tap's BK x BN weight tile into shared memory, rows beyond Cin and
// columns beyond Cout zero.
template <typename T>
__device__ __forceinline__ void load_b_tile(T* Bs, const T* wt, int ci0,
                                            int n0, int Cin, int Cout,
                                            bool vec_w, int tid) {
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr int B_CPR = TL::BN / V;
  constexpr int B_CHUNKS = TL::BK * B_CPR / kThreads;
  static_assert(B_CHUNKS * kThreads == TL::BK * B_CPR, "B tile split");
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / B_CPR, col = (c % B_CPR) * V;
    const int k = ci0 + r, n = n0 + col;
    const bool ok = k < Cin;
    const T* src = ok ? wt + (size_t)k * Cout + n : wt;
    load_chunk(Bs + r * TL::LDB + col, src, ok ? Cout - n : 0, vec_w);
  }
}

// --- T12 ---

template <typename T>
struct PipeArgs {
  const T* x;      // (B, H, W, Cin)
  const float* a;  // (B, Cin) fp32
  const float* c;  // (B, Cin) fp32
  const T* w;      // (9, Cin, Cout)
  const T* bias;   // (Cout,)
  T* out;          // (B, H, W, Cout)
  int B, H, W, Cin, Cout, tiles_y, tiles_x;
  bool vec_x, vec_w;
};

template <typename T>
struct PipeShape {
  using TL = Tile<T>;
  using PT = Patch<T>;
  static constexpr int WH = PT::TH + 2, WW = PT::TW + 2;
  static constexpr int kStages = 3;
  static constexpr int kWin = WH * WW * PT::LDW;  // elements a stage
  static constexpr size_t kBytes =
      sizeof(T) * (kStages * kWin + TL::BK * TL::LDB);
};

// Grid: x = image * patches, y = Cout tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pipelined_kernel(const PipeArgs<T> p) {
  using TL = Tile<T>;
  using PT = Patch<T>;
  using PS = PipeShape<T>;
  constexpr int TH = PT::TH, TW = PT::TW, LDW = PT::LDW;
  constexpr int WW = PS::WW;
  constexpr int BK = TL::BK;
  constexpr int V = 16 / sizeof(T);
  constexpr int W_CPP = BK / V;  // 16-byte chunks per window pixel
  constexpr int WIN_CHUNKS = PS::WH * WW * W_CPP;
  static_assert(TH * TW == TL::BM, "one patch per tile");
  static_assert(sizeof(T) * PS::kWin * PS::kStages >= kThreads * 32,
                "epilogue");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // kStages windows
  T* Bs = win + PS::kStages * PS::kWin;

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tid = threadIdx.x;
  const int per_image = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_image;
  const int patch = blockIdx.x - b * per_image;
  const int y0 = (patch / p.tiles_x) * TH, x0 = (patch % p.tiles_x) * TW;
  const int n0 = blockIdx.y * TL::BN;
  const int nchunks = (Cin + BK - 1) / BK;
  const float* ga = p.a + (size_t)b * Cin;
  const float* gc = p.c + (size_t)b * Cin;

  // chunk k's halo window into stage s, zero outside the image and beyond
  // Cin: cp.async where rows allow 16-byte copies
  auto copy = [&](int k, int s) {
    const int ci0 = k * BK;
    T* dst0 = win + s * PS::kWin;
    for (int i = tid; i < WIN_CHUNKS; i += kThreads) {
      const int pix = i / W_CPP, col = (i - pix * W_CPP) * V;
      const int wy = pix / WW, wx = pix - wy * WW;
      const int yy = y0 + wy - 1, xx = x0 + wx - 1;
      const bool inb = yy >= 0 && yy < H && xx >= 0 && xx < W;
      int nvalid = inb ? Cin - (ci0 + col) : 0;
      nvalid = nvalid < 0 ? 0 : (nvalid > V ? V : nvalid);
      const T* src =
          nvalid ? p.x + (((size_t)b * H + yy) * W + xx) * Cin + ci0 + col
                 : p.x;
      T* dst = dst0 + pix * LDW + col;
      if (p.vec_x)
        cp_async16(dst, src, nvalid * (int)sizeof(T));
      else
        load_chunk(dst, src, nvalid, false);
    }
  };
  // y = round_T(silu(v * a + c)) on every element this thread copied, the
  // zeros of the border included; channels beyond Cin stay zero
  auto prologue = [&](int k, int s) {
    const int ci0 = k * BK;
    T* dst0 = win + s * PS::kWin;
    for (int i = tid; i < WIN_CHUNKS; i += kThreads) {
      const int pix = i / W_CPP, col = (i - pix * W_CPP) * V;
      T* dst = dst0 + pix * LDW + col;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int ch = ci0 + col + e;
        if (ch < Cin) {
          const float t = to_float(dst[e]) * __ldg(ga + ch) + __ldg(gc + ch);
          dst[e] = from_float<T>(t / (1.0f + __expf(-t)));
        }
      }
    }
  };

  typename MathFor<T>::type math;
  math.init();

  copy(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  prologue(0, 0);
  if (nchunks > 1) copy(1, 1);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    // stage (k+2) % 3 was last read by the taps of chunk k-1, which ended
    // on a barrier
    if (k + 2 < nchunks) copy(k + 2, (k + 2) % PS::kStages);
    cp_async_commit();
    if (k + 1 < nchunks) {
      cp_async_wait<1>();  // all but the newest group: chunk k+1 is in
      prologue(k + 1, (k + 1) % PS::kStages);
    }
    const T* cur = win + (k % PS::kStages) * PS::kWin;
    for (int tap = 0; tap < 9; ++tap) {
      load_b_tile(Bs, p.w + (size_t)tap * Cin * Cout, k * BK, n0, Cin, Cout,
                  p.vec_w, tid);
      __syncthreads();  // this tap's B; at tap 0 also chunk k's prologue
      staged_step<WW, LDW>(math, cur, Bs, tid, 1, tap / 3, tap % 3);
      __syncthreads();  // before the next B or the next copy
    }
  }
  cp_async_wait_all();

  auto store = [&](int lr, int lc, float v) {
    const int y = y0 + lr / TW, xq = x0 + lr % TW, n = n0 + lc;
    if (y >= H || xq >= W || n >= Cout) return;
    if (p.bias != nullptr) v += to_float(p.bias[n]);
    p.out[(((size_t)b * H + y) * W + xq) * Cout + n] = from_float<T>(v);
  };
  math.epilogue(reinterpret_cast<float*>(win), tid, store);
}

template <typename T>
cudaError_t launch_pipelined(PipeArgs<T> p, cudaStream_t stream) {
  using TL = Tile<T>;
  using PT = Patch<T>;
  constexpr int V = 16 / sizeof(T);
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.Cin <= 0 || p.Cout <= 0 ||
      p.x == nullptr || p.a == nullptr || p.c == nullptr ||
      p.w == nullptr || p.out == nullptr)
    return cudaErrorInvalidValue;
  p.tiles_y = (p.H + PT::TH - 1) / PT::TH;
  p.tiles_x = (p.W + PT::TW - 1) / PT::TW;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x;
  const long long col_tiles = (p.Cout + TL::BN - 1) / TL::BN;
  if (blocks > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidValue;
  p.vec_x = p.Cin % V == 0 && aligned16(p.x);
  p.vec_w = p.Cout % V == 0 && aligned16(p.w);
  auto kern = pipelined_kernel<T>;
  constexpr size_t bytes = PipeShape<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)blocks, (unsigned)col_tiles);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// --- T11 ---

enum TapRead : int {
  kShifted = 0,
  kUnshifted = 1,
  kRowflat = 2,
  kJointw = 3
};

template <typename T>
struct TapArgs {
  const T* xwin;  // (nwin, H_T + 2, Wp, Cin)
  const T* w;     // (9, Cin, N); jointw's (3, 3 * Cin, N) is the same memory
  T* out;         // (nwin, H_T, W, N)
  int nwin, H_T, W, Wp, Cin, N, reps, tiles_y, tiles_x;
  bool vec_x, vec_w;
};

// The flat pixel tap (di, dj) reads for output (0, 0); output (h, w) reads
// `pitch` * h + w further on.
template <int READ>
__device__ __forceinline__ int tap_base(int di, int dj, int Wp) {
  if (READ == kUnshifted) return 0;
  if (READ == kJointw) {
    const int start = di * Wp < 2 * Wp - 2 ? di * Wp : 2 * Wp - 2;
    return start + dj;
  }
  return di * Wp + dj;
}

template <typename T, int READ>
struct TapShape {
  using TL = Tile<T>;
  using PT = Patch<T>;
  // shifted and unshifted: the halo window's TH + 2 rows; rowflat and
  // jointw: one run per (patch row, di)
  static constexpr bool kRuns = READ == kRowflat || READ == kJointw;
  static constexpr int WW = PT::TW + 2;
  static constexpr int kRows = kRuns ? 3 * PT::TH : PT::TH + 2;
  static constexpr int kWin = kRows * WW * PT::LDW;
  static constexpr size_t kBytes = sizeof(T) * (kWin + TL::BK * TL::LDB);
};

__device__ __forceinline__ void keep_alive(const MathF32& m) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"f"(m.acc[i][j]));
}

// Grid: x = window * patches, y = N tiles.
template <typename T, int READ>
__global__ void __launch_bounds__(kThreads)
window_taps_kernel(const TapArgs<T> p) {
  using TL = Tile<T>;
  using PT = Patch<T>;
  using TS = TapShape<T, READ>;
  constexpr int TH = PT::TH, TW = PT::TW, LDW = PT::LDW;
  constexpr int WW = TS::WW;
  constexpr int BK = TL::BK;
  constexpr int V = 16 / sizeof(T);
  constexpr int W_CPP = BK / V;
  constexpr int WIN_CHUNKS = TS::kRows * WW * W_CPP;
  static_assert(TH * TW == TL::BM, "one patch per tile");
  static_assert(sizeof(T) * TS::kWin >= kThreads * 32, "epilogue");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* Bs = win + TS::kWin;
  __shared__ float red[kThreads / 32];

  const int W = p.W, Wp = p.Wp, Cin = p.Cin, N = p.N;
  const int tid = threadIdx.x;
  const int per_win = p.tiles_y * p.tiles_x;
  const int wi = blockIdx.x / per_win;
  const int patch = blockIdx.x - wi * per_win;
  const int y0 = (patch / p.tiles_x) * TH, x0 = (patch % p.tiles_x) * TW;
  const int n0 = blockIdx.y * TL::BN;
  const int total = (p.H_T + 2) * Wp;  // flat pixels of a window
  const int pitch = READ == kRowflat ? W : Wp;
  const T* flat = p.xwin + (size_t)wi * total * Cin;

  // the loop carry: acc[0, 0, 0] of this window, (reps - 1) times
  float carry = 0.0f;
  if (p.reps > 1) {
    float part = 0.0f;
    for (int i = tid; i < 9 * Cin; i += kThreads) {
      const int tap = i / Cin, ch = i - tap * Cin;
      part = fmaf(
          to_float(flat[(size_t)tap_base<READ>(tap / 3, tap % 3, Wp) * Cin +
                        ch]),
          to_float(p.w[((size_t)tap * Cin + ch) * N]), part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    float first = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) first += red[i];
    for (int r = 1; r < p.reps; ++r) carry += first;
  }

  typename MathFor<T>::type math;
  for (int rep = 0; rep < p.reps; ++rep) {
    math.init();
    for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
      // what this block's taps read of this channel chunk; pixels beyond
      // the window are zero (they feed only outputs that are not stored)
      for (int i = tid; i < WIN_CHUNKS; i += kThreads) {
        const int pix = i / W_CPP, col = (i - pix * W_CPP) * V;
        const int row = pix / WW, j = pix - row * WW;
        const int start =
            TS::kRuns ? tap_base<READ>(row % 3, 0, Wp) + (y0 + row / 3) * pitch
                      : (y0 + row) * Wp;
        const int f = start + x0 + j;
        const bool ok = f < total;
        load_chunk(win + pix * LDW + col,
                   ok ? flat + (size_t)f * Cin + ci0 + col : flat,
                   ok ? Cin - (ci0 + col) : 0, p.vec_x);
      }
      for (int tap = 0; tap < 9; ++tap) {
        load_b_tile(Bs, p.w + (size_t)tap * Cin * N, ci0, n0, Cin, N,
                    p.vec_w, tid);
        __syncthreads();  // the window (first tap) and this tap's B are in
        if (TS::kRuns)
          staged_step<WW, LDW>(math, win, Bs, tid, 3, tap / 3, tap % 3);
        else if (READ == kUnshifted)
          staged_step<WW, LDW>(math, win, Bs, tid, 1, 0, 0);
        else
          staged_step<WW, LDW>(math, win, Bs, tid, 1, tap / 3, tap % 3);
        __syncthreads();  // before the next B or the next chunk's window
      }
    }
    if (rep + 1 < p.reps) keep_alive(math);
  }

  auto store = [&](int lr, int lc, float v) {
    const int y = y0 + lr / TW, xq = x0 + lr % TW, n = n0 + lc;
    if (y >= p.H_T || xq >= W || n >= N) return;
    p.out[(((size_t)wi * p.H_T + y) * W + xq) * N + n] =
        from_float<T>(v + carry);
  };
  math.epilogue(reinterpret_cast<float*>(win), tid, store);
}

template <typename T, int READ>
cudaError_t launch_taps(TapArgs<T> p, cudaStream_t stream) {
  using TL = Tile<T>;
  using PT = Patch<T>;
  constexpr int V = 16 / sizeof(T);
  p.tiles_y = (p.H_T + PT::TH - 1) / PT::TH;
  p.tiles_x = (p.W + PT::TW - 1) / PT::TW;
  const long long blocks = (long long)p.nwin * p.tiles_y * p.tiles_x;
  const long long col_tiles = (p.N + TL::BN - 1) / TL::BN;
  if (blocks > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidValue;
  p.vec_x = p.Cin % V == 0 && aligned16(p.xwin);
  p.vec_w = p.N % V == 0 && aligned16(p.w);
  auto kern = window_taps_kernel<T, READ>;
  constexpr size_t bytes = TapShape<T, READ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)blocks, (unsigned)col_tiles);
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_taps(TapArgs<T> p, int read, cudaStream_t s) {
  switch (read) {
    case kShifted: return launch_taps<T, kShifted>(p, s);
    case kUnshifted: return launch_taps<T, kUnshifted>(p, s);
    case kRowflat: return launch_taps<T, kRowflat>(p, s);
    case kJointw: return launch_taps<T, kJointw>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtp

// T12 in fp32: x (B,H,W,Cin), w (3,3,Cin,Cout), bias (Cout,) or null, out
// (B,H,W,Cout), all fp32; a, c (B,Cin) fp32. is_bf16 returns
// cudaErrorInvalidValue (bf16 T12 runs dtp_gn_conv_pipelined_sm90 of
// csrc/gn_conv_sm90.cu).
extern "C" cudaError_t dtp_gn_conv_pipelined(const void* x, const void* a,
                                             const void* c, const void* w,
                                             const void* bias, void* out,
                                             int B, int H, int W, int Cin,
                                             int Cout, int is_bf16,
                                             void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  dtp::PipeArgs<float> p{};
  p.x = static_cast<const float*>(x);
  p.a = static_cast<const float*>(a);
  p.c = static_cast<const float*>(c);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.B = B, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout;
  return dtp::launch_pipelined<float>(p, static_cast<cudaStream_t>(stream));
}

// T11 in fp32: xwin (nwin,H_T+2,Wp,Cin) with Wp >= W + 2, w (9,Cin,N) or
// jointw's (3,3*Cin,N), out (nwin,H_T,W,N), all fp32; read: 0 shifted, 1
// unshifted, 2 rowflat, 3 jointw; reps >= 1 passes. is_bf16 returns
// cudaErrorInvalidValue (bf16 T11 runs dtp_conv_window_taps_sm90 of
// csrc/window_taps_sm90.cu).
extern "C" cudaError_t dtp_conv_window_taps(const void* xwin, const void* w,
                                            void* out, int nwin, int H_T,
                                            int W, int Wp, int Cin, int N,
                                            int read, int reps, int is_bf16,
                                            void* stream) {
  if (is_bf16 || nwin <= 0 || H_T <= 0 || W <= 0 || Wp < W + 2 ||
      Cin <= 0 || N <= 0 || reps <= 0 || xwin == nullptr || w == nullptr ||
      out == nullptr)
    return cudaErrorInvalidValue;
  dtp::TapArgs<float> p{};
  p.xwin = static_cast<const float*>(xwin);
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.nwin = nwin, p.H_T = H_T, p.W = W, p.Wp = Wp, p.Cin = Cin, p.N = N;
  p.reps = reps;
  return dtp::dispatch_taps<float>(p, read, static_cast<cudaStream_t>(stream));
}
