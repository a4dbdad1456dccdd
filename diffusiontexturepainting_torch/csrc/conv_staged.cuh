// The staged-window step shared by the conv family's staged-tile mode
// (conv_staged.cu) and its A/B arms (conv_arms.cu): the output patch a block
// owns, and one BK step of the block GEMM (gemm_tile.cuh) whose A operand is
// read from a window of input pixels staged in shared memory.
#pragma once

#include "gemm_tile.cuh"

namespace dtp {
namespace {

// The output patch of a block (TH * TW == the tile's BM) and the window's
// leading dimension: in bf16 LDW * 2 is a multiple of 32 bytes, so every
// shifted fragment starts 256-bit aligned, as WMMA loads need; in fp32 the
// rows keep the 16-byte alignment of the staging stores.
template <typename T>
struct Patch;
template <>
struct Patch<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 16, LDW = 48;
};
template <>
struct Patch<float> {
  static constexpr int TH = 4, TW = 16, LDW = 20;
};

// One BK step of the bf16 tile from the staged window, whose rows are WW
// pixels of LDW elements: patch row r reads its 16 pixels from window row
// r * row_stride + row0, from column col0 on (a 3x3 tap (di, dj) of a halo
// window: row_stride 1, row0 di, col0 dj). Warp (wm, wn) owns patch rows
// 2*wm and 2*wm + 1, one 16-row fragment each.
template <int WW, int LDW>
__device__ __forceinline__ void staged_step(MathBF16& m,
                                            const __nv_bfloat16* win,
                                            const __nv_bfloat16* Bs, int tid,
                                            int row_stride, int row0,
                                            int col0) {
  using namespace nvcuda;
  using TL = Tile<__nv_bfloat16>;
  const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int kk = 0; kk < TL::BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(
          fa[i],
          win + (((wm * 2 + i) * row_stride + row0) * WW + col0) * LDW + kk,
          LDW);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(fb[j], Bs + kk * TL::LDB + wn * 64 + j * 16,
                             TL::LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::mma_sync(m.acc[i][j], fa[i], fb[j], m.acc[i][j]);
  }
}

// The fp32 twin: thread (tm, tn) owns tile rows 4*tm .. 4*tm + 3, which are
// pixels 4*(tm & 3) .. + 3 of patch row tm >> 2.
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
