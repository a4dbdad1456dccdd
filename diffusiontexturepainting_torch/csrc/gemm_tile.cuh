// The block-level GEMM step shared by the conv family (conv3x3.cu) and the
// GEGLU feed-forward (ff_geglu.cu): a BM x BN fp32 accumulator per block of
// 256 threads, fed BK-deep operand tiles from shared memory.
//
//   bf16: 128 x 128 x 32 tiles, 8 warps as 4 (M) x 2 (N), each warp a
//         32 x 64 sub-tile of 2 x 4 WMMA 16x16x16 fragments (mma.sync).
//   fp32: 64 x 64 x 16 tiles, 16 x 16 threads, each a 4 x 4 register tile.
//
// A is row-major (BM rows of BK, leading dimension `lda`); B is row-major
// (BK rows of BN, leading dimension TL::LDB). The epilogue hands every
// accumulator element to a callback store(row, col, value).
#pragma once

#include <mma.h>

#include "common.cuh"

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

struct MathBF16 {
  using TL = Tile<__nv_bfloat16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[2][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }

  // `lda` must be a multiple of 8 and As 32-byte aligned (WMMA loads).
  __device__ void step(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                       int tid, int lda = TL::LDA) {
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * lda + kk,
                               lda);
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

  // `scratch`: 8 warps x 256 floats of shared memory that is free by now.
  template <class Store>
  __device__ void epilogue(float* scratch, int tid, Store store) {
    using namespace nvcuda;
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

struct MathF32 {
  using TL = Tile<float>;
  float acc[4][4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void step(const float* As, const float* Bs, int tid,
                       int lda = TL::LDA) {
    const int tm = tid >> 4, tn = tid & 15;
#pragma unroll
    for (int k = 0; k < TL::BK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(tm * 4 + i) * lda + k];
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

}  // namespace
}  // namespace dtp
