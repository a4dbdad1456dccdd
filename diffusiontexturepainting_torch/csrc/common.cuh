// Helpers shared by the hand-written kernels of this package.
//
// Every kernel has a plain C entry point that launches on the caller's
// stream and returns cudaGetLastError(); the Python wrappers bind them
// with ctypes and raise on a nonzero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtp {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Copies one 16-byte chunk (16 / sizeof(T) elements) from global to shared
// memory. Elements at index >= nvalid are written as zero and never read,
// so nvalid <= 0 zero-fills without touching `src`. `vec` says that the
// row's element count and base pointer allow aligned 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int nvalid,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && nvalid >= V) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      dst[e] = (e < nvalid) ? src[e] : from_float<T>(0.0f);
    }
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace dtp

// Each source builds into its own shared library, so each carries one copy.
extern "C" const char* dtp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
