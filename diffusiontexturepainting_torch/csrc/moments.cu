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
// One launch configuration does not serve both, so the row band a block
// covers is planned from B, N and C:
//   pass 1 (moments_band_kernel): one block per (row band, image, slice of
//     up to 256 channel groups). A row's channels are cut into 16-byte
//     groups (V elements) over the block's first `tpr` threads, so that
//     neighbouring threads read neighbouring bytes; the block's other
//     threads take the next rows (256 / tpr row lanes). Each thread keeps
//     fp32 sums of its group over its rows; the block adds its row lanes
//     in lane order in shared memory and writes the band's partial
//     (sum, sumsq) per channel, zeros for a band past the last row.
//   pass 2 (moments_reduce_kernel): one block per (image, 32 of the 2*C
//     partial columns); 8 lanes each add every 8th band in band order,
//     then a fixed tree adds the 8 lanes.
// The bands are as many as give about eight blocks for each SM (the 512 MiB
// stem streams at the memory rate), but no fewer than 4 rows for each row
// lane of a band (the UNet's 16-row tensors get a few blocks each). No
// atomics: every run gives the same bits, so replayed stamps stay
// bit-identical.
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

// partial[b][band][0|1][c]: the band's (sum, sumsq) of channel c of image b.
template <typename T, int V>
__global__ void __launch_bounds__(kMomentThreads)
moments_band_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int N, int C, int rows_per_band) {
  __shared__ float red[kMomentThreads * 2 * V];
  const int G = C / V;  // channel groups of a row
  const int g0 = blockIdx.z * kMomentThreads;
  const int tpr = min(G - g0, kMomentThreads);  // threads per row
  const int lanes = kMomentThreads / tpr;       // rows in flight
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
  if (tid >= tpr) return;
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

// Row bands of one call (see the design note at the top). `itemsize` sizes
// the 16-byte channel groups as the kernel cuts them when it vectorizes.
int plan_bands(int B, int N, int C, int itemsize) {
  const int V = 16 / itemsize;
  const int G = (C + V - 1) / V;
  const int slices = (G + kMomentThreads - 1) / kMomentThreads;
  const int tpr = G < kMomentThreads ? G : kMomentThreads;
  const int lanes = kMomentThreads / tpr;
  const long long per_band = (long long)B * slices;
  long long bands = (8LL * kSMs + per_band - 1) / per_band;
  const long long most = N / (4LL * lanes);
  if (bands > most) bands = most;
  return bands > 1 ? (int)bands : 1;
}

template <typename T, int V>
cudaError_t launch(const void* x, float* partial, float* stats, int B, int N,
                   int C, int bands, cudaStream_t stream) {
  const int G = C / V;
  const int rows_per_band = (int)(((long long)N + bands - 1) / bands);
  dim3 grid((unsigned)bands, (unsigned)B,
            (unsigned)((G + kMomentThreads - 1) / kMomentThreads));
  moments_band_kernel<T, V><<<grid, kMomentThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, N, C, rows_per_band);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 rgrid((unsigned)((2 * C + kReduceCols - 1) / kReduceCols),
             (unsigned)B);
  moments_reduce_kernel<<<rgrid, dim3(kReduceCols, kReduceLanes), 0,
                          stream>>>(partial, stats, C, bands);
  return cudaGetLastError();
}

// 16-byte groups where every row starts 16-byte aligned, else one element.
template <typename T>
cudaError_t dispatch(const void* x, float* partial, float* stats, int B,
                     int N, int C, int bands, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0 && aligned16(x))
    return launch<T, V>(x, partial, stats, B, N, C, bands, stream);
  return launch<T, 1>(x, partial, stats, B, N, C, bands, stream);
}

}  // namespace
}  // namespace dtp

// Row bands of a call over x (B, N, C) of `itemsize`-byte elements; the
// caller passes them to dtp_spatial_moments with a workspace of
// B * bands * 2 * C floats.
extern "C" int dtp_moments_bands(int B, int N, int C, int itemsize) {
  if (B <= 0 || N <= 0 || C <= 0 || itemsize <= 0 || 16 % itemsize != 0)
    return 1;
  return dtp::plan_bands(B, N, C, itemsize);
}

// K14: x (B, N, C) contiguous, dtype 0 fp32, 1 bf16, 2 fp16; partial
// B * bands * 2 * C floats; stats (B, 2, C) fp32.
extern "C" cudaError_t dtp_spatial_moments(const void* x, void* partial,
                                           void* stats, int B, int N, int C,
                                           int bands, int dtype,
                                           void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || bands <= 0 || bands > 65535 ||
      B > 65535 || partial == nullptr || stats == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  switch (dtype) {
    case 0:
      return dtp::dispatch<float>(x, p, st, B, N, C, bands, s);
    case 1:
      return dtp::dispatch<__nv_bfloat16>(x, p, st, B, N, C, bands, s);
    case 2:
      return dtp::dispatch<__half>(x, p, st, B, N, C, bands, s);
    default:
      return cudaErrorInvalidValue;
  }
}
