// Spatial moments of an NHWC tensor: per (image, channel) the fp32 sum and
// sum of squares over the H*W pixels, the GroupNorm statistics of the fused
// serving legs for a tensor that no conv epilogue produced.
//
// Replaces (TPU, diffusiontexturepainting_tpu/ops/groupnorm.py):
//   dtp_spatial_moments  <- _stats_pallas / _stats_kernel (K14)
//
// What it computes: x (B, N = H*W, C) of fp32, bf16 or fp16 ->
//   stats[b][0][c] = sum_n x[b,n,c],  stats[b][1][c] = sum_n x[b,n,c]^2,
//   in fp32.
//
// What bounds it on the H100: bytes. It reads each element once and does 3
// operations on it, at sizes from 3x4x4x1280 (the UNet's 4x4 level,
// 120 KiB of bf16) to 2x1024x1024x128 (the 1024^2 encoder stem, 512 MiB).
// The plan is chosen from the shape before the launch (and mirrored by
// ops/groupnorm.py moments_plan, so the host makes one ctypes call):
//   pass 1 (moments_band_kernel): one block per (row band, image, slice of
//     up to 256 channel groups), writing each band's partial;
//   pass 2 (moments_reduce_kernel): one block per (image, 32 of the 2*C
//     partial columns); 8 lanes each add every 8th band in band order,
//     then a fixed tree adds the 8 lanes.
// The bands are as many as give about eight blocks for each SM (the 512 MiB
// stem streams at the memory rate), but no fewer than 4 rows for each row
// lane of a band (the UNet's 16-row tensors get a few blocks each). A
// one-launch design (8-block thread-block clusters adding their bands
// through distributed shared memory) was measured and lost device time at
// the UNet's shapes; see PERF.md.
// In a block, a row's channels are cut into 16-byte groups (V elements)
// over the block's first `tpr` threads, so that neighbouring threads read
// neighbouring bytes; the block's other threads take the next rows
// (256 / tpr row lanes). Each thread keeps fp32 sums of its group over its
// rows; the block adds its row lanes in lane order. No atomics and no
// counters: every run gives the same bits (a replayed stamp stays
// bit-identical), and a launch shares nothing with another stream's.
#include <cuda_fp16.h>

#include "common.cuh"

namespace dtp {

template <>
__device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

namespace {

constexpr int kMomentThreads = 256;
constexpr int kReduceCols = 32, kReduceLanes = 8;
constexpr int kSMs = 132;  // H100 SXM

// V elements of one row's channel group, as fp32.
template <typename T, int V>
__device__ __forceinline__ void load_group(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_float(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte load");
    alignas(16) T t[V];
    *reinterpret_cast<uint4*>(t) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_float(t[e]);
  }
}

// One row band of image blockIdx.y, channel groups from blockIdx.z * gpb,
// into partial[b][band][0|1][c], the band's (sum, sumsq).
template <typename T, int V>
__global__ void __launch_bounds__(kMomentThreads)
moments_band_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int N, int C, int rows_per_band, int gpb) {
  __shared__ float red[kMomentThreads * 2 * V];
  const int G = C / V;  // channel groups of a row
  const int g0 = blockIdx.z * gpb;
  const int tpr = min(G - g0, gpb);        // threads per row
  const int lanes = kMomentThreads / tpr;  // rows in flight
  const int tid = threadIdx.x;
  const int lane = tid / tpr, g = g0 + tid % tpr;
  const int band = blockIdx.x, b = blockIdx.y, bands = gridDim.x;
  const long long r0 = (long long)band * rows_per_band;
  const long long r1 = min(r0 + rows_per_band, (long long)N);

  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.0f;
  if (lane < lanes) {
    const T* base = x + (size_t)b * N * C + (size_t)g * V;
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += lanes) {
      float v[V];
      load_group<T, V>(base + (size_t)r * C, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += v[e];
        s2[e] += v[e] * v[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[tid * 2 * V + e] = s1[e];
    red[tid * 2 * V + V + e] = s2[e];
  }
  __syncthreads();
  if (tid < tpr) {
    // thread t adds row lanes 0, 1, ... of its group, in that order
#pragma unroll
    for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.0f;
    for (int l = 0; l < lanes; ++l) {
      const float* r = red + (l * tpr + tid) * 2 * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += r[e];
        s2[e] += r[V + e];
      }
    }
    float* out = partial + ((size_t)b * bands + band) * 2 * C + (size_t)g * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[e] = s1[e];
      out[C + e] = s2[e];
    }
  }
}

// stats[b][col] = sum over bands of partial[b][band][col], col < 2*C: lane
// l adds bands l, l + 8, ... in order, then a fixed tree adds the lanes.
__global__ void __launch_bounds__(kReduceCols* kReduceLanes)
moments_reduce_kernel(const float* __restrict__ partial,
                      float* __restrict__ stats, int C, int bands) {
  __shared__ float red[kReduceLanes][kReduceCols];
  const int b = blockIdx.y;
  const int col = blockIdx.x * kReduceCols + threadIdx.x;
  const int lane = threadIdx.y;
  const int cols = 2 * C;
  float s = 0.0f;
  if (col < cols) {
    const float* p = partial + (size_t)b * bands * cols + col;
    for (int k = lane; k < bands; k += kReduceLanes) s += p[(size_t)k * cols];
  }
  red[lane][threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int half = kReduceLanes / 2; half > 0; half /= 2) {
    if (lane < half) red[lane][threadIdx.x] += red[lane + half][threadIdx.x];
    __syncthreads();
  }
  if (lane == 0 && col < cols) stats[(size_t)b * cols + col] = red[0][threadIdx.x];
}

struct MomentsPlan {
  int bands, gpb, slices;
  long long partial_floats;
};

// The plan of one call (see the design note at the top); `vec`: the rows
// are read as 16-byte groups of 16 / itemsize elements, else one element.
MomentsPlan plan(int B, int N, int C, int itemsize, bool vec) {
  MomentsPlan p{};
  const int V = vec ? 16 / itemsize : 1;
  const int G = (C + V - 1) / V;
  p.gpb = G < kMomentThreads ? G : kMomentThreads;
  p.slices = (G + p.gpb - 1) / p.gpb;
  const int lanes = kMomentThreads / p.gpb;
  const long long per_band = (long long)B * p.slices;
  long long bands = (8LL * kSMs + per_band - 1) / per_band;
  const long long most = N / (4LL * lanes);
  if (bands > most) bands = most;
  p.bands = bands > 1 ? (int)bands : 1;
  p.partial_floats = (long long)B * p.bands * 2 * C;
  return p;
}

template <typename T, int V>
cudaError_t launch(const void* x, float* partial, float* stats, int B, int N,
                   int C, const MomentsPlan& p, cudaStream_t stream) {
  const int rows_per_band = (int)(((long long)N + p.bands - 1) / p.bands);
  const dim3 grid((unsigned)p.bands, (unsigned)B, (unsigned)p.slices);
  moments_band_kernel<T, V><<<grid, kMomentThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, N, C, rows_per_band, p.gpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 rgrid((unsigned)((2 * C + kReduceCols - 1) / kReduceCols),
             (unsigned)B);
  moments_reduce_kernel<<<rgrid, dim3(kReduceCols, kReduceLanes), 0,
                          stream>>>(partial, stats, C, p.bands);
  return cudaGetLastError();
}

template <typename T>
bool vectorized(const void* x, int C) {
  return C % (16 / sizeof(T)) == 0 && aligned16(x);
}

// 16-byte groups where every row starts 16-byte aligned, else one element.
template <typename T>
cudaError_t dispatch(const void* x, float* partial, float* stats, int B,
                     int N, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vectorized<T>(x, C);
  const MomentsPlan p = plan(B, N, C, sizeof(T), vec);
  if (p.bands > 65535 || p.slices > 65535 || partial == nullptr)
    return cudaErrorInvalidValue;
  if (vec) return launch<T, V>(x, partial, stats, B, N, C, p, stream);
  return launch<T, 1>(x, partial, stats, B, N, C, p, stream);
}

}  // namespace
}  // namespace dtp

// The plan of a call over x (B, N, C) of `itemsize`-byte elements read in
// 16-byte groups when `vec` (C a multiple of 16 / itemsize, x 16-byte
// aligned), into out[4]: {bands, channel groups a block, slices, partial
// floats} (the tests hold ops/groupnorm.py moments_plan against it). -1 for
// a shape no plan takes.
extern "C" int dtp_moments_plan(int B, int N, int C, int itemsize, int vec,
                                long long* out) {
  if (B <= 0 || N <= 0 || C <= 0 || itemsize <= 0 || 16 % itemsize != 0)
    return -1;
  const dtp::MomentsPlan p = dtp::plan(B, N, C, itemsize, vec != 0);
  const long long v[4] = {p.bands, p.gpb, p.slices, p.partial_floats};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// The row bands of a call whose rows are read in 16-byte groups.
extern "C" int dtp_moments_bands(int B, int N, int C, int itemsize) {
  if (B <= 0 || N <= 0 || C <= 0 || itemsize <= 0 || 16 % itemsize != 0)
    return 1;
  return dtp::plan(B, N, C, itemsize, C % (16 / itemsize) == 0).bands;
}

// K14: x (B, N, C) contiguous, dtype 0 fp32, 1 bf16, 2 fp16; partial the
// plan's partial floats; stats (B, 2, C) fp32.
extern "C" cudaError_t dtp_spatial_moments(const void* x, void* partial,
                                           void* stats, int B, int N, int C,
                                           int dtype, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || B > 65535 || stats == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0:
      return dtp::dispatch<float>(x, p, st, B, N, C, s);
    case 1:
      return dtp::dispatch<__nv_bfloat16>(x, p, st, B, N, C, s);
    case 2:
      return dtp::dispatch<__half>(x, p, st, B, N, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
