// The UNet transformer's GEGLU feed-forward in one kernel:
//   out = round(residual + b2 + sum_i h[:, i] * W2[:, i]),
//   h   = round((x @ W0v^T + b0v) * gelu_erf(x @ W0g^T + b0g)),
// over (N, C) tokens with inner = 4C.
//
// Replaces (TPU): diffusiontexturepainting_tpu/ops/ff_geglu.py
//   _ff_geglu_pallas / _ff_kernel (K3), in fp32 only: bf16 K3 is
//   ff_geglu_sm90.cu's two wgmma/TMA GEMMs (dispatch by dtype in
//   ops/ff_geglu.py ff_geglu), and dtp_ff_geglu returns
//   cudaErrorInvalidValue for it. The Pallas kernel's default GELU is the
//   tanh form (a TPU speed trade); this kernel computes the erf GELU of the
//   module GEGLU and of the JAX package's _reference.
//
// Weights are read in PyTorch's nn.Linear layout, (out, in), as the modules
// hold them: w0 (2*inner, C) with the value rows first, then the gate rows;
// w2 (C, inner). No transposed copy exists.
//
// Design. Block (t, s) owns the token tile t (BM tokens) and the inner chunk
// s (IC columns of h):
//   1. for each panel of BN/2 inner columns: one BM x BN GEMM over K = C
//      against the panel's value and gate rows of w0, then h for the panel
//      (bias, erf GELU, product, rounding to the activation type) into the
//      block's h tile in shared memory;
//   2. for each BN-wide column tile of the output: a GEMM of the h tile
//      (BM x IC, shared memory) against w2's rows, written as this chunk's
//      fp32 partial of the output to a workspace.
// ff_finish_kernel then adds the chunks' partials in chunk order, + b2 +
// residual in fp32, and rounds once. The (tokens, inner) intermediate never
// reaches device memory; the fp32 partials of the output do.
//
// What bounds it on the H100: 6*N*C*inner flops per call against
// 3*C*inner weights that every token tile reads again (from L2). At the
// UNet's 256^2 shapes (N = 48..3072 tokens) there are few token tiles, so
// splitting inner across blocks is what fills the 132 SMs, and the fp32
// partials (splits * N * C * 4 bytes, about 40 MB a call) are the extra
// traffic that buys it. The fp32 FMA path of the conv family's GEMM tile;
// no pipelining.
#include "gemm_tile.cuh"

namespace dtp {
namespace {

template <typename T>
struct FFArgs {
  const T* x;    // (N, C)
  const T* w0;   // (2*I, C)
  const T* b0;   // (2*I,)
  const T* w2;   // (C, I)
  float* ws;     // (splits, N, C) fp32 partials
  int N, C, I, IC;
};

// Loads Bs[k][n] = rows[n][k0 + k] for a BK x BN tile of a matrix stored
// (rows, K) row-major, one 16-byte chunk along k per step. row_of(n)
// returns the matrix row of tile column n, or -1 for a zero column; k_end
// bounds the valid k.
template <typename T, class RowOf>
__device__ __forceinline__ void load_bt(T* Bs, const T* mat, int ld, int k0,
                                        int k_end, bool vec, int tid,
                                        RowOf row_of) {
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr int KC = TL::BK / V;  // chunks along k per column
  constexpr int CHUNKS = TL::BN * KC / kThreads;
  static_assert(CHUNKS * kThreads == TL::BN * KC, "B tile split");
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = tid + i * kThreads;
    const int n = c / KC, kk = (c % KC) * V;
    const int row = row_of(n);
    const int k = k0 + kk;
    const int nvalid = row >= 0 ? k_end - k : 0;
    alignas(16) T v[V];
    load_chunk(v, row >= 0 ? mat + (size_t)row * ld + k : mat, nvalid, vec);
#pragma unroll
    for (int e = 0; e < V; ++e) Bs[(kk + e) * TL::LDB + n] = v[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ff_kernel(const FFArgs<T> p) {
  using TL = Tile<T>;
  constexpr int V = 16 / sizeof(T);
  constexpr int HALF = TL::BN / 2;
  constexpr int A_CPR = TL::BK / V;
  constexpr int A_CHUNKS = TL::BM * A_CPR / kThreads;
  static_assert(A_CHUNKS * kThreads == TL::BM * A_CPR, "A tile split");
  const int ldh = p.IC + 16 / (int)sizeof(T);  // multiple of 8 elements

  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TL::BM * TL::LDA;
  float* stage = reinterpret_cast<float*>(Bs + TL::BK * TL::LDB);
  constexpr int LDS = TL::BN + 4;
  T* Hs = reinterpret_cast<T*>(stage + TL::BM * LDS);

  const int tid = threadIdx.x;
  const int N = p.N, C = p.C, I = p.I;
  const int m0 = blockIdx.x * TL::BM;
  const int i0 = blockIdx.y * p.IC;
  const int i_end = min(i0 + p.IC, I);
  const bool vec_x = C % V == 0 && aligned16(p.x);
  const bool vec_w0 = C % V == 0 && aligned16(p.w0);
  const bool vec_w2 = I % V == 0 && aligned16(p.w2);
  typename MathFor<T>::type math;

  // 1. h tile, panel by panel
  for (int pc = 0; pc < p.IC; pc += HALF) {
    math.init();
    for (int k0 = 0; k0 < C; k0 += TL::BK) {
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / A_CPR, col = (c % A_CPR) * V;
        const int m = m0 + r, k = k0 + col;
        load_chunk(As + r * TL::LDA + col,
                   m < N ? p.x + (size_t)m * C + k : p.x,
                   m < N ? C - k : 0, vec_x);
      }
      load_bt(Bs, p.w0, C, k0, C, vec_w0, tid, [&](int n) {
        const int j = i0 + pc + (n < HALF ? n : n - HALF);
        if (j >= i_end) return -1;
        return n < HALF ? j : I + j;
      });
      __syncthreads();
      math.step(As, Bs, tid);
      __syncthreads();
    }
    math.epilogue(reinterpret_cast<float*>(As), tid,
                  [&](int lr, int lc, float v) { stage[lr * LDS + lc] = v; });
    __syncthreads();
    for (int e = tid; e < TL::BM * HALF; e += kThreads) {
      const int r = e / HALF, j = e - r * HALF;
      const int col = i0 + pc + j;
      float h = 0.0f;
      if (col < i_end) {
        const float v = stage[r * LDS + j] + to_float(p.b0[col]);
        const float g = stage[r * LDS + HALF + j] + to_float(p.b0[I + col]);
        h = v * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
      }
      Hs[r * ldh + pc + j] = from_float<T>(h);
    }
    __syncthreads();
  }

  // 2. this chunk's partial of the output, column tile by column tile
  float* ws = p.ws + (size_t)blockIdx.y * N * C;
  for (int n0 = 0; n0 < C; n0 += TL::BN) {
    math.init();
    for (int k0 = 0; k0 < p.IC; k0 += TL::BK) {
      load_bt(Bs, p.w2 + i0, I, k0, i_end - i0, vec_w2 && i0 % V == 0, tid,
              [&](int n) { return n0 + n < C ? n0 + n : -1; });
      __syncthreads();
      math.step(Hs + k0, Bs, tid, ldh);
      __syncthreads();
    }
    math.epilogue(reinterpret_cast<float*>(As), tid,
                  [&](int lr, int lc, float v) {
                    const int m = m0 + lr, c = n0 + lc;
                    if (m < N && c < C) ws[(size_t)m * C + c] = v;
                  });
    __syncthreads();
  }
}

// out = round(sum over chunks of the partials + b2 + residual), in a fixed
// order, so results do not vary from run to run.
template <typename T>
__global__ void ff_finish_kernel(const float* __restrict__ ws,
                                 const T* __restrict__ b2,
                                 const T* __restrict__ residual,
                                 T* __restrict__ out, int N, int C,
                                 int splits) {
  const size_t total = (size_t)N * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += ws[s * total + i];
    v += to_float(b2[i % C]);
    v += to_float(residual[i]);
    out[i] = from_float<T>(v);
  }
}

constexpr int kSMs = 132;  // H100 SXM

// Inner columns per block: 256 where the token tiles times the chunks give
// a wave of blocks on the 132 SMs, else 128.
template <typename T>
int plan_ic(int N, int I) {
  using TL = Tile<T>;
  const long long tiles = (N + TL::BM - 1) / TL::BM;
  return tiles * ((I + 255) / 256) >= kSMs ? 256 : 128;
}

template <typename T>
size_t smem_bytes(int ic) {
  using TL = Tile<T>;
  return sizeof(T) * (TL::BM * TL::LDA + TL::BK * TL::LDB) +
         sizeof(float) * TL::BM * (TL::BN + 4) +
         sizeof(T) * TL::BM * (ic + 16 / sizeof(T));
}

template <typename T>
cudaError_t launch(const void* x, const void* w0, const void* b0,
                   const void* w2, const void* b2, const void* residual,
                   void* out, void* ws, int N, int C, int I, int ic,
                   cudaStream_t stream) {
  using TL = Tile<T>;
  if (ic % (TL::BN / 2) != 0 || ic % TL::BK != 0 || ws == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(ic);
  cudaError_t err = cudaFuncSetAttribute(
      ff_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  FFArgs<T> p{static_cast<const T*>(x), static_cast<const T*>(w0),
              static_cast<const T*>(b0), static_cast<const T*>(w2),
              static_cast<float*>(ws), N, C, I, ic};
  const int splits = (I + ic - 1) / ic;
  dim3 grid((unsigned)((N + TL::BM - 1) / TL::BM), (unsigned)splits);
  ff_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)N * C;
  const unsigned fin_blocks =
      (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  ff_finish_kernel<T><<<fin_blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const T*>(b2),
      static_cast<const T*>(residual), static_cast<T*>(out), N, C, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtp

// Inner columns per block of a call; the caller passes an fp32 workspace of
// ceil(inner / ic) * N * C floats.
// (is_bf16 is kept for the binding and ignored: fp32 only.)
extern "C" int dtp_ff_geglu_chunk(int N, int inner, int is_bf16) {
  if (N <= 0 || inner <= 0) return 128;
  return dtp::plan_ic<float>(N, inner);
}

// x (N,C), w0 (2*inner,C), b0 (2*inner,), w2 (C,inner), b2 (C,),
// residual (N,C), out (N,C), all fp32; is_bf16 must be 0 (bf16 K3 is
// ff_geglu_sm90.cu's).
extern "C" cudaError_t dtp_ff_geglu(const void* x, const void* w0,
                                    const void* b0, const void* w2,
                                    const void* b2, const void* residual,
                                    void* out, void* ws, int N, int C,
                                    int inner, int ic, int is_bf16,
                                    void* stream) {
  if (is_bf16 || N <= 0 || C <= 0 || inner <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtp::launch<float>(x, w0, b0, w2, b2, residual, out, ws, N, C,
                            inner, ic, s);
}
