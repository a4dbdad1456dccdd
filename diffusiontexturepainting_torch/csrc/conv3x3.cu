// The 3x3 convolution family in fp32, NHWC, as implicit GEMMs on FMA: the
// plain 3x3 SAME conv, the fused nearest-x2 upsample + 3x3 conv, the
// stride-2 downsample conv, and their fused modes with GroupNorm prologue,
// residual and statistics epilogues. Every kernel here is the fp32 twin of
// a bf16 wgmma/TMA kernel; each entry returns cudaErrorInvalidValue for
// bf16 (the wrappers dispatch by dtype: ops/conv3x3.py, ops/gn_conv.py).
//
// Replaces (TPU, diffusiontexturepainting_tpu/ops/), in fp32:
//   dtp_conv3x3              <- conv3x3.py _conv3x3_pallas / _conv_kernel
//                               (K7); bf16: gn_conv_sm90.cu dtp_conv3x3_sm90
//   dtp_upsample2x_conv3x3   <- conv3x3.py _upconv_pallas /
//                               _upconv_kernel_padded (K4); bf16:
//                               gn_conv_sm90.cu dtp_upsample2x_conv3x3_sm90
//   dtp_gn_conv3x3           <- conv3x3.py _gn_conv_resident_pallas /
//                               _gn_res_kernel (K1) and gn_conv_stream.py
//                               _stream_fused_pallas / _kernel (K5): one
//                               function, resident or streamed on the TPU;
//                               bf16: gn_conv_sm90.cu dtp_gn_conv3x3_sm90
//   dtp_upsample2x_conv3x3_stats
//                            <- gn_conv_stream.py _upconv_stream_pallas /
//                               _upconv_stream_kernel (K6); bf16:
//                               gn_conv_sm90.cu
//                               dtp_upsample2x_conv3x3_stats_sm90
//   dtp_downsample_conv3x3_stats
//                            <- gn_conv_stream.py _downconv_stream_pallas /
//                               _downconv_kernel (K9); bf16: conv_sm90.cu
//                               dtp_downsample_conv3x3_stats_sm90
//
// What they compute:
//   conv:  out[b,y,x,n] = bias[n] + sum_{di,dj,c} x[b,y+di-1,x+dj-1,c]
//                                                 * w[di,dj,c,n]
//          GEMM with M = B*H*W output pixels, N = Cout, K = 9*Cin.
//   upconv: conv3x3(nearest_x2(x)) as four parity planes (ry, rx), each a
//          2x2-tap conv over the SOURCE image with weights folded on the
//          host into w16[(ry*2+rx)*4 + ai*2+bi, c, n]:
//          out[b,2y+ry,2x+rx,n] = bias[n] + sum_{ai,bi,c}
//                 x[b,y+ry+ai-1,x+rx+bi-1,c] * w16[...,c,n]
//          GEMM per plane with M = B*H*W, N = Cout, K = 4*Cin; the plane's
//          results are written straight into the interleaved (B,2H,2W,Cout)
//          output, so no plane tensor and no transpose exist.
//   gn conv (K1/K5): the conv of v = silu(x*a[b,c] + c[b,c]) with a, c the
//          folded GroupNorm affine; then y = acc + bias, y = y + residual,
//          and optionally (sum, sumsq) of the final y per (b, n).
//   upconv stats (K6): the upconv, with (sum, sumsq) per (b, n) of the
//          output BEFORE its rounding (the TPU kernel's order; K1/K5 take
//          theirs after rounding and residual).
//   downconv stats (K9): the VAE encoder's level transition, a stride-2
//          3x3 conv over x padded by one zero row below and one zero column
//          to the right (diffusers' Downsample2D, pad (0,1),(0,1)):
//          out[b,i,j,n] = bias[n] + sum_{di,dj,c} x[b,2i+di,2j+dj,c]
//                                                 * w[di,dj,c,n]
//          for i < H/2, j < W/2 (the VALID conv's output size), with K6's
//          pre-rounding statistics. GEMM with M = B*(H/2)*(W/2), K = 9*Cin.
// Borders are load predicates: out-of-image taps load zeros, and in the
// GroupNorm mode they skip the prologue, since silu(0*a + c) != 0. SAME
// and UP read row y+di-1 (zero for -1 and H); DOWN reads row 2i+di, which
// is never negative and reads zero only at H (the pad row) - no -1 offset.
// No padded copy of the input is made.
//
// Design: one 64x64 output tile per block of 256 threads, each a 4x4
// register tile of FMAs (gemm_tile.cuh MathF32), fed 16-deep operand tiles
// through shared memory (load, sync, FMA, sync). Where the output tiles
// alone would leave most of the 132 SMs idle (the UNet's small levels), the
// K loop is split across blocks into an fp32 workspace and reduced in a
// fixed order by a finish kernel. What bounds it: the H100's fp32 FMA rate
// (67 TFLOP/s); the fp32 twins serve the fp32 paths and the tests.
//
// The statistics are deterministic (no float atomics: a replayed stamp is
// bit-identical, and the statistics feed every next GroupNorm). With
// statistics the conv writes its sums to the workspace, and
// finish_stats_kernel runs the whole epilogue: each thread owns one output
// channel of a chunk of rows, walks the rows in order (bias, residual,
// store) and keeps per-image partial sums, since one chunk may span
// several images at the UNet's 4x4 and 8x8 levels; stats_reduce_kernel
// then adds each image's chunk partials in chunk order.
//
// Sizes: element offsets and the workspace's splits x outputs are size_t;
// pixel and row counts are int, which holds the 1024^2 envelope's largest
// call (the VAE encoder's (2,1024,1024,128) x 128: 2^21 rows, 2^28 outputs,
// a 1 GiB fp32 workspace) with room; the grids stay within their limits
// there (x: 2^15 row tiles or statistics chunks, z: 4 x splits).
#include "gemm_tile.cuh"

namespace dtp {
namespace {

// The family's modes: the output pixel's taps and the output's layout.
enum Mode : int {
  kSame = 0,  // 3x3 SAME conv
  kUp = 1,    // nearest x2 + 3x3 conv, as four parity planes of 2x2 taps
  kDown = 2,  // stride-2 3x3 conv, pad (0,1),(0,1)
};

// Output pixels per image of a mode (per parity plane for kUp).
__host__ __device__ inline int out_rows(int mode, int H) {
  return mode == kDown ? H / 2 : H;
}

// Everything one launch of conv_kernel reads.
template <typename T>
struct ConvArgs {
  const T* x;
  const T* w;         // taps w_tap elements apart, each (Cin, Cout)
  const T* bias;      // (Cout,) or null
  const T* gn_a;      // (B, Cin) GroupNorm prologue scale, or null: none
  const T* gn_c;      // (B, Cin) GroupNorm prologue shift
  const T* residual;  // the output's shape, or null (in-kernel epilogue)
  T* out;
  float* partial;  // fp32 sums, splits x output elements, when to_ws
  long long w_tap;
  int B, H, W, Cin, Cout, splits;
  bool vec_a, vec_b, to_ws;
};

// One 16-byte A chunk through the GroupNorm prologue: silu(x*a + c) in
// fp32, the affine result and the SiLU each rounded to T as the plain
// version rounds them. Elements at index >= nvalid are zero.
template <typename T>
__device__ __forceinline__ void load_chunk_gn(T* dst, const T* src,
                                              const T* a, const T* c,
                                              int nvalid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  alignas(16) T v[V];
  if (vec && nvalid >= V) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[e] = (e < nvalid) ? src[e] : from_float<T>(0.0f);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < nvalid) {
      float t = to_float(v[e]) * to_float(a[e]) + to_float(c[e]);
      t = to_float(from_float<T>(t));
      v[e] = from_float<T>(t / (1.0f + __expf(-t)));
    }
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// kSame: 3x3 SAME conv. kUp: blockIdx.z is the parity plane of the
// x2-upsampled output and w holds the 16 folded 2x2 taps. kDown: stride-2
// taps over the (0,1)-padded input. H, W are the input's. T, here and
// below, is float: the entries instantiate nothing else.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const ConvArgs<T> p) {
  constexpr bool UP = MODE == kUp;
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr int A_CPR = TL::BK / V;  // 16-byte chunks per A-tile row
  constexpr int B_CPR = TL::BN / V;
  constexpr int A_CHUNKS = TL::BM * A_CPR / kThreads;
  constexpr int B_CHUNKS = TL::BK * B_CPR / kThreads;
  static_assert(A_CHUNKS * kThreads == TL::BM * A_CPR, "A tile split");
  static_assert(B_CHUNKS * kThreads == TL::BK * B_CPR, "B tile split");

  __shared__ __align__(128) T As[TL::BM * TL::LDA];
  __shared__ __align__(128) T Bs[TL::BK * TL::LDB];

  const int B = p.B, H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int splits = p.splits;
  const int tid = threadIdx.x;
  const int OW = out_rows(MODE, W);
  const int HW = out_rows(MODE, H) * OW;  // output pixels per image (plane)
  const int M = B * HW;
  const int m0 = blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const int plane = UP ? blockIdx.z / splits : 0;
  const int split = blockIdx.z % splits;
  const int ry = plane >> 1, rx = plane & 1;
  constexpr int kTaps = UP ? 4 : 9;
  constexpr int kStride = MODE == kDown ? 2 : 1;
  // K steps are (tap, channel block) pairs; split s takes [k_begin, k_end)
  const int steps_per_tap = (Cin + TL::BK - 1) / TL::BK;
  const int k_steps = kTaps * steps_per_tap;
  const int k_begin = (int)((long long)split * k_steps / splits);
  const int k_end = (int)((long long)(split + 1) * k_steps / splits);

  // The output pixel of each A row this thread loads, fixed over K.
  int a_row[A_CHUNKS], a_col[A_CHUNKS], a_b[A_CHUNKS], a_y[A_CHUNKS],
      a_x[A_CHUNKS];
  bool a_ok[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = tid + i * kThreads;
    a_row[i] = c / A_CPR;
    a_col[i] = (c % A_CPR) * V;
    const int m = m0 + a_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / HW;
    const int rem = mm - a_b[i] * HW;
    a_y[i] = rem / OW;
    a_x[i] = rem - a_y[i] * OW;
  }

  typename MathFor<T>::type math;
  math.init();

  for (int step = k_begin; step < k_end; ++step) {
    const int tap = step / steps_per_tap;
    const int ci0 = (step - tap * steps_per_tap) * TL::BK;
    int dy, dx;
    const T* wt;
    if (UP) {
      dy = ry + (tap >> 1) - 1;
      dx = rx + (tap & 1) - 1;
      wt = p.w + (size_t)(plane * 4 + tap) * p.w_tap;
    } else if (MODE == kDown) {
      dy = tap / 3;
      dx = tap % 3;
      wt = p.w + (size_t)tap * p.w_tap;
    } else {
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
      wt = p.w + (size_t)tap * p.w_tap;
    }
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int yy = kStride * a_y[i] + dy, xx = kStride * a_x[i] + dx;
      const int ci = ci0 + a_col[i];
      const bool inb = a_ok[i] && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src =
          inb ? p.x + (((size_t)a_b[i] * H + yy) * W + xx) * Cin + ci : p.x;
      T* dst = As + a_row[i] * TL::LDA + a_col[i];
      if (p.gn_a != nullptr && inb) {
        const size_t g = (size_t)a_b[i] * Cin + ci;
        load_chunk_gn(dst, src, p.gn_a + g, p.gn_c + g, Cin - ci, p.vec_a);
      } else {
        load_chunk(dst, src, inb ? Cin - ci : 0, p.vec_a);
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / B_CPR, col = (c % B_CPR) * V;
      const int k = ci0 + r, n = n0 + col;
      const bool ok = k < Cin;
      const T* src = ok ? wt + (size_t)k * Cout + n : wt;
      load_chunk(Bs + r * TL::LDB + col, src, ok ? Cout - n : 0, p.vec_b);
    }
    __syncthreads();
    math.step(As, Bs, tid);
    __syncthreads();
  }

  const size_t total = (size_t)M * Cout * (UP ? 4 : 1);
  auto store = [&](int lr, int lc, float v) {
    const int m = m0 + lr, n = n0 + lc;
    if (m >= M || n >= Cout) return;
    size_t o;
    if (UP) {
      const int b = m / HW, rem = m - b * HW;
      const int y = rem / W, xq = rem - y * W;
      o = (((size_t)b * 2 * H + 2 * y + ry) * (2 * W) + 2 * xq + rx) * Cout + n;
    } else {
      o = (size_t)m * Cout + n;
    }
    if (p.to_ws) {
      p.partial[split * total + o] = v;  // epilogue in a finish kernel
      return;
    }
    if (p.bias != nullptr) v += to_float(p.bias[n]);
    T y = from_float<T>(v);
    if (p.residual != nullptr)
      y = from_float<T>(to_float(y) + to_float(p.residual[o]));
    p.out[o] = y;
  };
  // The K loop ended on a barrier, so the A tile is free as the
  // epilogue's scratch (MathF32 stores straight from its registers).
  math.epilogue(reinterpret_cast<float*>(As), tid, store);
}

// Split-K reduction of K7/K4: out = round(sum over splits of the partials
// + bias), summed in a fixed order, so results do not vary from run to run.
template <typename T>
__global__ void finish_kernel(const float* __restrict__ partial,
                              const T* __restrict__ bias,
                              T* __restrict__ out, size_t total, int Cout,
                              int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = to_float(bias[i % Cout]);
    for (int s = 0; s < splits; ++s) v += partial[s * total + i];
    out[i] = from_float<T>(v);
  }
}

constexpr int kStatCols = 128;  // output channels per finish_stats block

// The epilogue of the fused modes, run after the conv: thread n of block
// (chunk, column block) walks the chunk's `chunk` rows of the image-major
// output (B images of `hw` rows) in order, sums the splits, adds the bias,
// rounds, adds the residual in T, stores, and keeps (sum, sumsq) per image
// of the chunk in ws[chunk][image - first image of the chunk][0|1][n].
// PRE: the statistics of the fp32 value before rounding (K6); otherwise of
// the stored value (K1/K5).
template <typename T, bool PRE>
__global__ void __launch_bounds__(kStatCols)
finish_stats_kernel(const float* __restrict__ partial,
                    const T* __restrict__ bias,
                    const T* __restrict__ residual, T* __restrict__ out,
                    float* __restrict__ ws, int rows, int hw, int Cout,
                    int splits, int chunk, int slots, bool want_stats) {
  const int n = blockIdx.y * kStatCols + threadIdx.x;
  if (n >= Cout) return;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows);
  const size_t total = (size_t)rows * Cout;
  const float bv = bias != nullptr ? to_float(bias[n]) : 0.0f;
  const int b0 = r0 / hw;
  float* wsn = ws + (size_t)blockIdx.x * slots * 2 * Cout + n;
  int b = b0, next = (b0 + 1) * hw;
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = r0; r < r1; ++r) {
    if (r == next) {
      if (want_stats) {
        wsn[(size_t)(b - b0) * 2 * Cout] = s1;
        wsn[(size_t)(b - b0) * 2 * Cout + Cout] = s2;
      }
      ++b;
      next += hw;
      s1 = s2 = 0.0f;
    }
    const size_t o = (size_t)r * Cout + n;
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partial[s * total + o];
    v += bv;
    if (PRE) {
      s1 += v;
      s2 += v * v;
    }
    T y = from_float<T>(v);
    if (residual != nullptr)
      y = from_float<T>(to_float(y) + to_float(residual[o]));
    out[o] = y;
    if (!PRE) {
      const float f = to_float(y);
      s1 += f;
      s2 += f * f;
    }
  }
  if (want_stats) {
    wsn[(size_t)(b - b0) * 2 * Cout] = s1;
    wsn[(size_t)(b - b0) * 2 * Cout + Cout] = s2;
  }
}

// stats[b][0|1][n]: the chunk partials of image b, added in chunk order.
__global__ void stats_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ stats, int B, int hw,
                                    int Cout, int chunk, int slots) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B * Cout;
       i += gridDim.x * blockDim.x) {
    const int b = i / Cout, n = i - b * Cout;
    const long long first = (long long)b * hw, last = first + hw - 1;
    float s1 = 0.0f, s2 = 0.0f;
    for (long long c = first / chunk; c <= last / chunk; ++c) {
      const int slot = b - (int)(c * chunk / hw);
      const float* p = ws + ((size_t)c * slots + slot) * 2 * Cout + n;
      s1 += p[0];
      s2 += p[Cout];
    }
    stats[(size_t)b * 2 * Cout + n] = s1;
    stats[(size_t)b * 2 * Cout + Cout + n] = s2;
  }
}

constexpr int kSMs = 132;  // H100 SXM

// Rows per finish_stats chunk: 128, halved down to 8 until the chunks times
// the column blocks give about two blocks per SM (the UNet's 4x4 level has
// 48 output rows).
int plan_chunk(int rows, int Cout) {
  const int col_blocks = (Cout + kStatCols - 1) / kStatCols;
  int chunk = 128;
  while (chunk > 8 &&
         (long long)((rows + chunk - 1) / chunk) * col_blocks < 2 * kSMs)
    chunk /= 2;
  return chunk;
}

// Image slots per chunk: the most images `chunk` consecutive rows touch.
int plan_slots(int chunk, int hw, int B) {
  const int s = (chunk - 1) / hw + 2;
  return s < B ? s : B;
}

// K splits for one call: 1 when the output tiles alone fill the card;
// otherwise enough splits for about two waves of blocks, each keeping at
// least 8 K steps. The UNet's 4x4 to 16x16 levels (M = 48..768 pixels,
// K up to 9*2560) would otherwise run 10-60 blocks on 132 SMs.
template <typename T, int MODE>
int plan_splits(int B, int H, int W, int Cin, int Cout) {
  using TL = Tile<T>;
  constexpr bool UP = MODE == kUp;
  const long long M =
      (long long)B * out_rows(MODE, H) * out_rows(MODE, W);
  const long long blocks = ((M + TL::BM - 1) / TL::BM) *
                           ((Cout + TL::BN - 1) / TL::BN) * (UP ? 4 : 1);
  if (blocks >= kSMs) return 1;
  const int k_steps = (UP ? 4 : 9) * ((Cin + TL::BK - 1) / TL::BK);
  long long s = (2 * kSMs + blocks - 1) / blocks;
  s = s < k_steps / 8 ? s : k_steps / 8;
  return s > 1 ? (int)s : 1;
}

template <typename T, int MODE>
cudaError_t launch_conv(ConvArgs<T> p, cudaStream_t stream) {
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr bool UP = MODE == kUp;
  if (p.splits < 1 || (p.to_ws && p.partial == nullptr) ||
      (p.gn_a == nullptr) != (p.gn_c == nullptr))
    return cudaErrorInvalidValue;
  const long long M =
      (long long)p.B * out_rows(MODE, p.H) * out_rows(MODE, p.W);
  dim3 grid((unsigned)((M + TL::BM - 1) / TL::BM),
            (unsigned)((p.Cout + TL::BN - 1) / TL::BN),
            (unsigned)((UP ? 4 : 1) * p.splits));
  p.vec_a = p.Cin % V == 0 && aligned16(p.x);
  p.vec_b = p.Cout % V == 0 && p.w_tap % V == 0 && aligned16(p.w);
  conv_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K7 / K4: conv + bias, split-K reduced by finish_kernel.
template <typename T, int MODE>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   void* partial, int B, int H, int W, int Cin, int Cout,
                   int splits, cudaStream_t stream) {
  ConvArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.bias = static_cast<const T*>(bias);
  p.out = static_cast<T*>(out);
  p.partial = static_cast<float*>(partial);
  p.w_tap = (long long)Cin * Cout;
  p.B = B, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.splits = splits;
  p.to_ws = splits > 1;
  if (bias == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_conv<T, MODE>(p, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)B * H * W * Cout * (MODE == kUp ? 4 : 1);
  const unsigned fin_blocks =
      (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  finish_kernel<T><<<fin_blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const T*>(bias),
      static_cast<T*>(out), total, Cout, splits);
  return cudaGetLastError();
}

// The fused modes (K1/K5 with kSame, K6 with kUp, K9 with kDown). Without
// statistics and split-K the whole epilogue runs in the conv kernel;
// otherwise the conv writes fp32 sums to `partial` and finish_stats_kernel
// (+ stats_reduce_kernel) finishes; K6 and K9 take their statistics before
// rounding.
template <typename T, int MODE>
cudaError_t launch_fused(const void* x, const void* a, const void* c,
                         const void* w, const void* bias,
                         const void* residual, void* out, void* partial,
                         void* ws, void* stats, int B, int H, int W, int Cin,
                         int Cout, long long w_tap, int splits,
                         bool want_stats, cudaStream_t stream) {
  ConvArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.bias = static_cast<const T*>(bias);
  p.gn_a = static_cast<const T*>(a);
  p.gn_c = static_cast<const T*>(c);
  p.residual = static_cast<const T*>(residual);
  p.out = static_cast<T*>(out);
  p.partial = static_cast<float*>(partial);
  p.w_tap = w_tap;
  p.B = B, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.splits = splits;
  p.to_ws = splits > 1 || want_stats;
  if (w_tap < (long long)Cin * Cout) return cudaErrorInvalidValue;
  if (want_stats && (ws == nullptr || stats == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_conv<T, MODE>(p, stream);
  if (err != cudaSuccess || !p.to_ws) return err;
  const int hw =
      out_rows(MODE, H) * out_rows(MODE, W) * (MODE == kUp ? 4 : 1);
  const int rows = B * hw;
  const int chunk = plan_chunk(rows, Cout);
  const int slots = plan_slots(chunk, hw, B);
  dim3 grid((unsigned)((rows + chunk - 1) / chunk),
            (unsigned)((Cout + kStatCols - 1) / kStatCols));
  finish_stats_kernel<T, MODE != kSame><<<grid, kStatCols, 0, stream>>>(
      p.partial, p.bias, p.residual, p.out, static_cast<float*>(ws), rows,
      hw, Cout, splits, chunk, slots, want_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_stats) return err;
  const int n = B * Cout;
  stats_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(stats), B, hw, Cout,
      chunk, slots);
  return cudaGetLastError();
}

// An empty output is refused too: kDown needs two input rows and columns.
bool bad_shape(int mode, int B, int H, int W, int Cin, int Cout) {
  return B <= 0 || out_rows(mode, H) <= 0 || out_rows(mode, W) <= 0 ||
         Cin <= 0 || Cout <= 0;
}

// bf16 has no plan here: -1 (the entries refuse it).
template <int MODE>
int splits_for(int B, int H, int W, int Cin, int Cout, int is_bf16) {
  if (is_bf16) return -1;
  if (bad_shape(MODE, B, H, W, Cin, Cout)) return 1;
  return plan_splits<float, MODE>(B, H, W, Cin, Cout);
}

}  // namespace
}  // namespace dtp

// The K split an fp32 call uses; with splits > 1 the caller passes an fp32
// workspace of splits * (output elements) floats. is_bf16: -1.
extern "C" int dtp_conv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                  int is_bf16) {
  return dtp::splits_for<dtp::kSame>(B, H, W, Cin, Cout, is_bf16);
}

extern "C" int dtp_upsample2x_conv3x3_splits(int B, int H, int W, int Cin,
                                             int Cout, int is_bf16) {
  return dtp::splits_for<dtp::kUp>(B, H, W, Cin, Cout, is_bf16);
}

extern "C" int dtp_downsample_conv3x3_splits(int B, int H, int W, int Cin,
                                             int Cout, int is_bf16) {
  return dtp::splits_for<dtp::kDown>(B, H, W, Cin, Cout, is_bf16);
}

// Floats of the statistics workspace of a fused call whose output has
// B images of `hw` rows of Cout channels.
extern "C" int dtp_stats_workspace_floats(int B, int hw, int Cout) {
  if (B <= 0 || hw <= 0 || Cout <= 0) return 0;
  const int rows = B * hw;
  const int chunk = dtp::plan_chunk(rows, Cout);
  return ((rows + chunk - 1) / chunk) * dtp::plan_slots(chunk, hw, B) * 2 *
         Cout;
}

// K7 in fp32: x (B,H,W,Cin), w (3,3,Cin,Cout), bias (Cout,), out
// (B,H,W,Cout), all fp32; is_bf16 must be 0 (bf16 K7 is gn_conv_sm90.cu's).
extern "C" cudaError_t dtp_conv3x3(const void* x, const void* w,
                                   const void* bias, void* out,
                                   void* partial, int B, int H, int W,
                                   int Cin, int Cout, int splits,
                                   int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad_shape(dtp::kSame, B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  return dtp::launch<float, dtp::kSame>(x, w, bias, out, partial, B, H, W,
                                        Cin, Cout, splits,
                                        static_cast<cudaStream_t>(stream));
}

// K4 in fp32: x (B,H,W,Cin), w16 (16,Cin,Cout) folded taps, bias (Cout,),
// out (B,2H,2W,Cout), all fp32; is_bf16 must be 0 (bf16 K4 is
// gn_conv_sm90.cu's).
extern "C" cudaError_t dtp_upsample2x_conv3x3(const void* x, const void* w16,
                                              const void* bias, void* out,
                                              void* partial, int B, int H,
                                              int W, int Cin, int Cout,
                                              int splits, int is_bf16,
                                              void* stream) {
  if (is_bf16) return cudaErrorInvalidValue;
  if (dtp::bad_shape(dtp::kUp, B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  return dtp::launch<float, dtp::kUp>(x, w16, bias, out, partial, B, H, W,
                                      Cin, Cout, splits,
                                      static_cast<cudaStream_t>(stream));
}

// K1/K5 in fp32: x (B,H,W,Cin); a, c (B,Cin) folded GroupNorm affine, or
// both null for no prologue; w (3,3,Cin,Cout) with its 9 taps w_tap elements apart
// (Cin*Cout, or more for a slice of a wider weight's input channels);
// bias (Cout,) or null; residual
// (B,H,W,Cout) or null; out (B,H,W,Cout); all fp32. partial:
// splits * B*H*W*Cout floats when splits > 1 or want_stats; ws:
// dtp_stats_workspace_floats(B, H*W, Cout) floats and stats (B,2,Cout)
// fp32 when want_stats.
extern "C" cudaError_t dtp_gn_conv3x3(const void* x, const void* a,
                                      const void* c, const void* w,
                                      const void* bias, const void* residual,
                                      void* out, void* partial, void* ws,
                                      void* stats, int B, int H, int W,
                                      int Cin, int Cout, int w_tap,
                                      int splits, int want_stats,
                                      int is_bf16, void* stream) {
  // bf16 runs gn_conv_sm90.cu's wgmma kernel: no bf16 instantiation here
  if (is_bf16 || dtp::bad_shape(dtp::kSame, B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  return dtp::launch_fused<float, dtp::kSame>(
      x, a, c, w, bias, residual, out, partial, ws, stats, B, H, W, Cin,
      Cout, w_tap, splits, want_stats != 0,
      static_cast<cudaStream_t>(stream));
}

// K6 in fp32: x (B,H,W,Cin), w16 (16,Cin,Cout) folded taps, bias (Cout,)
// or null, out (B,2H,2W,Cout); workspaces as for dtp_gn_conv3x3 with the
// output's 4*H*W rows per image; is_bf16 must be 0 (bf16 K6 is
// gn_conv_sm90.cu's).
extern "C" cudaError_t dtp_upsample2x_conv3x3_stats(
    const void* x, const void* w16, const void* bias, void* out,
    void* partial, void* ws, void* stats, int B, int H, int W, int Cin,
    int Cout, int splits, int want_stats, int is_bf16, void* stream) {
  if (is_bf16 || dtp::bad_shape(dtp::kUp, B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  return dtp::launch_fused<float, dtp::kUp>(
      x, nullptr, nullptr, w16, bias, nullptr, out, partial, ws, stats, B, H,
      W, Cin, Cout, (long long)Cin * Cout, splits, want_stats != 0,
      static_cast<cudaStream_t>(stream));
}

// K9 in fp32: x (B,H,W,Cin) with H, W >= 2, w (3,3,Cin,Cout), bias (Cout,)
// or null, out (B,H/2,W/2,Cout); workspaces as for dtp_gn_conv3x3 with the
// output's (H/2)*(W/2) rows per image.
extern "C" cudaError_t dtp_downsample_conv3x3_stats(
    const void* x, const void* w, const void* bias, void* out,
    void* partial, void* ws, void* stats, int B, int H, int W, int Cin,
    int Cout, int splits, int want_stats, int is_bf16, void* stream) {
  // bf16 runs conv_sm90.cu's wgmma kernel: no bf16 instantiation here
  if (is_bf16 || dtp::bad_shape(dtp::kDown, B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  return dtp::launch_fused<float, dtp::kDown>(
      x, nullptr, nullptr, w, bias, nullptr, out, partial, ws, stats, B, H,
      W, Cin, Cout, (long long)Cin * Cout, splits, want_stats != 0,
      static_cast<cudaStream_t>(stream));
}
