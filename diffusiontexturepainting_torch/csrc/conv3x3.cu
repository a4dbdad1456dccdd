// 3x3 stride-1 SAME convolution and the fused nearest-x2 upsample + 3x3
// convolution, NHWC, as implicit GEMMs.
//
// Replaces (TPU):
//   dtp_conv3x3              <- diffusiontexturepainting_tpu/ops/conv3x3.py
//                               _conv3x3_pallas / _conv_kernel
//   dtp_upsample2x_conv3x3   <- diffusiontexturepainting_tpu/ops/conv3x3.py
//                               _upconv_pallas / _upconv_kernel_padded
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
// The SAME border is a load predicate (out-of-image taps load zeros); no
// padded copy of the input is made. fp32 accumulation, the bias (stored in
// the activation type) added in fp32, one rounding to the activation type
// at the end.
//
// What bounds it on the H100: at the UNet's shapes (M = 48..3072 pixels,
// K up to 9*2560) it is tensor-core work on small M, so tile occupancy and
// the un-pipelined K loop (load, sync, mma, sync) bound it; at the VAE's
// 256^2 levels (M up to 131072, K = 1152) the operand traffic through
// shared memory does. This first version keeps one 128x128 output tile per
// block with bf16 WMMA (mma.sync) on 8 warps and an fp32 FMA twin. Where
// the output tiles alone would leave most of the 132 SMs idle (the UNet's
// small levels), the K loop is split across blocks into an fp32 workspace
// and reduced in a fixed order by finish_kernel. The TMA + wgmma pipelined
// version is later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace dtp {
namespace {

constexpr int kThreads = 256;

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int LDA = BK + 8, LDB = BN + 8;
};
template <>
struct Tile<float> {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDA = BK + 4, LDB = BN + 4;
};

// bf16: 8 warps as 4 (M) x 2 (N), each warp a 32x64 sub-tile of 2x4 WMMA
// 16x16x16 fragments.
struct MathBF16 {
  using TL = Tile<__nv_bfloat16>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                       int tid) {
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * TL::LDA + kk,
                               TL::LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * TL::LDB + wn * 64 + j * 16,
                               TL::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // `scratch`: 8 warps x 256 floats of shared memory, free by now.
  template <class Store>
  __device__ void epilogue(float* scratch, int tid, Store store) {
    const int warp = tid >> 5, lane = tid & 31, wm = warp & 3, wn = warp >> 2;
    float* scr = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = lane * 8 + e;
          store(wm * 32 + i * 16 + (idx >> 4), wn * 64 + j * 16 + (idx & 15),
                scr[idx]);
        }
        __syncwarp();
      }
    }
  }
};

// fp32: 16x16 threads, each a 4x4 register tile of the 64x64 block tile.
struct MathF32 {
  using TL = Tile<float>;
  float acc[4][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void step(const float* As, const float* Bs, int tid) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int k = 0; k < TL::BK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(tm * 4 + i) * TL::LDA + k];
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + k * TL::LDB + tn * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

  template <class Store>
  __device__ void epilogue(float*, int tid, Store store) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(tm * 4 + i, tn * 4 + j, acc[i][j]);
  }
};

template <typename T>
struct MathFor;
template <>
struct MathFor<__nv_bfloat16> { using type = MathBF16; };
template <>
struct MathFor<float> { using type = MathF32; };

// UP = false: 3x3 SAME conv. UP = true: blockIdx.z is the parity plane of
// the x2-upsampled output and w holds the 16 folded 2x2 taps.
template <typename T, bool UP>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ out, int B, int H,
            int W, int Cin, int Cout, bool vec_a, bool vec_b, int splits,
            float* __restrict__ partial) {
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

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const int plane = UP ? blockIdx.z / splits : 0;
  const int split = blockIdx.z % splits;
  const int ry = plane >> 1, rx = plane & 1;
  constexpr int kTaps = UP ? 4 : 9;
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
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
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
      wt = w + (size_t)(plane * 4 + tap) * Cin * Cout;
    } else {
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
      wt = w + (size_t)tap * Cin * Cout;
    }
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const int ci = ci0 + a_col[i];
      const bool inb = a_ok[i] && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src =
          inb ? x + (((size_t)a_b[i] * H + yy) * W + xx) * Cin + ci : x;
      load_chunk(As + a_row[i] * TL::LDA + a_col[i], src,
                 inb ? Cin - ci : 0, vec_a);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / B_CPR, col = (c % B_CPR) * V;
      const int k = ci0 + r, n = n0 + col;
      const bool ok = k < Cin;
      const T* src = ok ? wt + (size_t)k * Cout + n : wt;
      load_chunk(Bs + r * TL::LDB + col, src, ok ? Cout - n : 0, vec_b);
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
    if (splits > 1) {
      partial[split * total + o] = v;  // bias and rounding in finish_kernel
    } else {
      out[o] = from_float<T>(v + to_float(bias[n]));
    }
  };
  // The K loop ended on a barrier, so the A tile is free as the bf16
  // epilogue's per-warp staging area (8 x 256 floats fit in it).
  math.epilogue(reinterpret_cast<float*>(As), tid, store);
}

// Split-K reduction: out = round(sum over splits of the partials + bias),
// summed in a fixed order, so results do not vary from run to run.
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

constexpr int kSMs = 132;  // H100 SXM

// K splits for one call: 1 when the output tiles alone fill the card;
// otherwise enough splits for about two waves of blocks, each keeping at
// least 8 K steps. The UNet's 4x4 to 16x16 levels (M = 48..768 pixels,
// K up to 9*2560) would otherwise run 10-60 blocks on 132 SMs.
template <typename T, bool UP>
int plan_splits(int B, int H, int W, int Cin, int Cout) {
  using TL = Tile<T>;
  const long long M = (long long)B * H * W;
  const long long blocks = ((M + TL::BM - 1) / TL::BM) *
                           ((Cout + TL::BN - 1) / TL::BN) * (UP ? 4 : 1);
  if (blocks >= kSMs) return 1;
  const int k_steps = (UP ? 4 : 9) * ((Cin + TL::BK - 1) / TL::BK);
  long long s = (2 * kSMs + blocks - 1) / blocks;
  s = s < k_steps / 8 ? s : k_steps / 8;
  return s > 1 ? (int)s : 1;
}

template <typename T, bool UP>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   void* partial, int B, int H, int W, int Cin, int Cout,
                   int splits, cudaStream_t stream) {
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  if (splits < 1 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + TL::BM - 1) / TL::BM),
            (unsigned)((Cout + TL::BN - 1) / TL::BN),
            (unsigned)((UP ? 4 : 1) * splits));
  const bool vec_a = Cin % V == 0 && aligned16(x);
  const bool vec_b = Cout % V == 0 && aligned16(w);
  conv_kernel<T, UP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), B, H, W, Cin,
      Cout, vec_a, vec_b, splits, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)M * Cout * (UP ? 4 : 1);
  const unsigned fin_blocks =
      (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  finish_kernel<T><<<fin_blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const T*>(bias),
      static_cast<T*>(out), total, Cout, splits);
  return cudaGetLastError();
}

template <bool UP>
int splits_for(int B, int H, int W, int Cin, int Cout, int is_bf16) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return 1;
  return is_bf16 ? plan_splits<__nv_bfloat16, UP>(B, H, W, Cin, Cout)
                 : plan_splits<float, UP>(B, H, W, Cin, Cout);
}

template <bool UP>
cudaError_t dispatch(const void* x, const void* w, const void* bias,
                     void* out, void* partial, int B, int H, int W, int Cin,
                     int Cout, int splits, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, UP>(x, w, bias, out, partial, B, H, W, Cin,
                                     Cout, splits, s);
  return launch<float, UP>(x, w, bias, out, partial, B, H, W, Cin, Cout,
                           splits, s);
}

}  // namespace
}  // namespace dtp

// The K split a call uses; with splits > 1 the caller passes an fp32
// workspace of splits * (output elements) floats.
extern "C" int dtp_conv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                  int is_bf16) {
  return dtp::splits_for<false>(B, H, W, Cin, Cout, is_bf16);
}

extern "C" int dtp_upsample2x_conv3x3_splits(int B, int H, int W, int Cin,
                                             int Cout, int is_bf16) {
  return dtp::splits_for<true>(B, H, W, Cin, Cout, is_bf16);
}

// x (B,H,W,Cin), w (3,3,Cin,Cout), bias (Cout,), out (B,H,W,Cout), all of
// one type: bf16 when is_bf16, else fp32.
extern "C" cudaError_t dtp_conv3x3(const void* x, const void* w,
                                   const void* bias, void* out,
                                   void* partial, int B, int H, int W,
                                   int Cin, int Cout, int splits,
                                   int is_bf16, void* stream) {
  return dtp::dispatch<false>(x, w, bias, out, partial, B, H, W, Cin, Cout,
                              splits, is_bf16, stream);
}

// x (B,H,W,Cin), w16 (16,Cin,Cout) folded taps, bias (Cout,),
// out (B,2H,2W,Cout), all of one type.
extern "C" cudaError_t dtp_upsample2x_conv3x3(const void* x, const void* w16,
                                              const void* bias, void* out,
                                              void* partial, int B, int H,
                                              int W, int Cin, int Cout,
                                              int splits, int is_bf16,
                                              void* stream) {
  return dtp::dispatch<true>(x, w16, bias, out, partial, B, H, W, Cin, Cout,
                             splits, is_bf16, stream);
}
