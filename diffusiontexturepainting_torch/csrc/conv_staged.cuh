// The staged-window step shared by the conv family's staged-tile mode
// (conv_staged.cu) and its A/B arms (conv_arms.cu): the output patch a block
// owns, and one BK step of the block GEMM (gemm_tile.cuh) whose A operand is
// read from a window of input pixels staged in shared memory.
#pragma once

#include "gemm_tile.cuh"

namespace dtp {
namespace {

// The output patch of a block (TH * TW == the tile's BM) and the window's
// leading dimension: its rows keep the 16-byte alignment of the staging
// stores. The staged-tile kernels run in fp32 only (their bf16 functions
// run the wgmma/TMA kernels of gn_conv_sm90.cu).
template <typename T>
struct Patch;
template <>
struct Patch<float> {
  static constexpr int TH = 4, TW = 16, LDW = 20;
};

// One BK step of the fp32 tile from the staged window, whose rows are WW
// pixels of LDW elements: patch row r reads its pixels from window row
// r * row_stride + row0, from column col0 on (a 3x3 tap (di, dj) of a halo
// window: row_stride 1, row0 di, col0 dj). Thread (tm, tn) owns tile rows
// 4*tm .. 4*tm + 3, which are pixels 4*(tm & 3) .. + 3 of patch row tm >> 2.
template <int WW, int LDW>
__device__ __forceinline__ void staged_step(MathF32& m, const float* win,
                                            const float* Bs, int tid,
                                            int row_stride, int row0,
                                            int col0) {
  using TL = Tile<float>;
  const int tm = tid >> 4, tn = tid & 15;
  const float* a0 =
      win +
      (((tm >> 2) * row_stride + row0) * WW + (tm & 3) * 4 + col0) * LDW;
#pragma unroll
  for (int k = 0; k < TL::BK; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * LDW + k];
    const float4 b =
        *reinterpret_cast<const float4*>(Bs + k * TL::LDB + tn * 4);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m.acc[i][j] = fmaf(a[i], bv[j], m.acc[i][j]);
  }
}

}  // namespace
}  // namespace dtp
