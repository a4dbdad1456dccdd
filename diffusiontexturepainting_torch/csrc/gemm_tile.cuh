// The block-level GEMM step of the FMA twins (conv3x3.cu, ff_geglu.cu,
// conv_staged.cu, conv_arms.cu): a BM x BN fp32 accumulator per block of
// 256 threads, fed BK-deep operand tiles from shared memory: 64 x 64 x 16
// tiles, 16 x 16 threads, each a 4 x 4 register tile. (Their bf16
// functions run the wgmma/TMA kernels of the *_sm90.cu sources.)
//
// A is row-major (BM rows of BK, leading dimension `lda`); B is row-major
// (BK rows of BN, leading dimension TL::LDB). The epilogue hands every
// accumulator element to a callback store(row, col, value).
#pragma once

#include "common.cuh"

namespace dtp {
namespace {

constexpr int kThreads = 256;

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDA = BK + 4, LDB = BN + 4;
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
struct MathFor<float> { using type = MathF32; };

}  // namespace
}  // namespace dtp
