// Z-buffered barycentric triangle rasterization: the painting client's
// stamp render and its UV-space back-projection (client/render.py).
//
// Replaces no Pallas kernel: the JAX package rasterizes with a dense XLA
// formulation (diffusiontexturepainting_tpu/ops/raster.py:24 rasterize,
// (H*W, F) arrays of edge functions, barycentrics and depths and an argmax
// over faces), itself the counterpart of kaolin's CUDA rasterizer that the
// reference client calls (util/render.py:76-83, 156-176). At the painter's
// 256^2 view of a 65k-face mesh each of those arrays holds 4.3e9 elements;
// here each face touches only the pixels of its bounding box.
//
// What it computes: face_vertices_image (F, 3, 2) NDC (y down), face
// vertex depths (F, 3), per-corner features (F, 3, C), an optional valid
// mask (F,) ->
//   face_idx[p] = the face whose inclusive inside test (b0, b1, b2 >= 0)
//                 holds at pixel centre p with the greatest z, the lowest
//                 face index on equal z (jnp.argmax's pick), -1 where none;
//   out[p][c]   = b0 f0c + b1 f1c + b2 f2c of that face, 0 where none,
//                 as fma(b2, f2c, fma(b1, f1c, b0 f0c)), each fma through
//                 float64 (the JAX einsum's fused multiply-adds on the CPU).
// A face with |area| < 1e-12 covers no pixel (the JAX package substitutes
// an area of 1e-12 there, so a face of three coincident corners covers the
// whole viewport: not copied, see ROADMAP.md).
//
// Every fp32 step rounds as the plain version (ops/raster.py
// rasterize_plain) and the JAX package round it, through the _rn
// intrinsics so that nvcc contracts nothing into an FMA: the pixel centre
// ((i + 0.5) / W) * 2 - 1; the edge function (b - a).x (p - a).y -
// (b - a).y (p - a).x, the area the same way; w / area; z as
// (b0 z0 + b1 z1) + b2 z2; the features' fused multiply-adds through
// float64 as there. On shared edges the inclusive test and z ties
// decide which face owns a pixel (in the back-projection every z is 0), so
// face_idx and the features equal the plain version's bit for bit.
//
// Two passes behind one entry, on the caller's stream:
//   cover:   one warp a face (8 a block); gridDim.y slices of each face's
//            bounding box, widened by a pixel each side (the exact test,
//            not the box, decides coverage), over the lanes. A covered
//            pixel takes atomicMax of the 64-bit key
//            (order-preserving bits of z) << 32 | (0xFFFFFFFF - face);
//            key 0 means no face.
//   resolve: one thread a pixel decodes its key, recomputes the face's
//            barycentrics and writes the features and face_idx.
// What bounds it on the H100: bytes and latency, not operations. A face
// reads 9 + 3C floats; a pixel is written once (C + 1 values) beside its
// 8-byte key. Faces of a stamp view cover a few pixels each, so most warps
// retire after their box test; the atomics of a pixel come from the faces
// over it only.
#include "common.cuh"

namespace dtp {
namespace {

constexpr int kWarps = 8;  // faces a cover block
constexpr int kResolveThreads = 256;
constexpr float kMinArea = 1e-12f;

__device__ __forceinline__ float pixel_center(int i, int n) {
  return __fsub_rn(
      __fmul_rn(__fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                          static_cast<float>(n)),
                2.0f),
      1.0f);
}

// cross(b - a, p - a)
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay);
  const float apx = __fsub_rn(px, ax), apy = __fsub_rn(py, ay);
  return __fsub_rn(__fmul_rn(abx, apy), __fmul_rn(aby, apx));
}

// a * b + c rounded to fp32 from float64 (a * b is exact there): the
// plain version's evaluation of the JAX einsum's fused multiply-adds
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

struct Tri {
  float x0, y0, x1, y1, x2, y2, area;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ fvi,
                                        int f) {
  const float* v = fvi + 6ll * f;
  Tri t{v[0], v[1], v[2], v[3], v[4], v[5], 0.0f};
  t.area = edge(t.x0, t.y0, t.x1, t.y1, t.x2, t.y2);
  return t;
}

// b_i = w_i / area, w0 = edge(v1, v2, p), w1 = edge(v2, v0, p),
// w2 = edge(v0, v1, p); true where all three are >= 0 (NaN is outside)
__device__ __forceinline__ bool bary(const Tri& t, float px, float py,
                                     float& b0, float& b1, float& b2) {
  b0 = __fdiv_rn(edge(t.x1, t.y1, t.x2, t.y2, px, py), t.area);
  b1 = __fdiv_rn(edge(t.x2, t.y2, t.x0, t.y0, px, py), t.area);
  b2 = __fdiv_rn(edge(t.x0, t.y0, t.x1, t.y1, px, py), t.area);
  return b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f;
}

// The pixel range [lo, hi] whose centres can lie in [vmin, vmax]: centre i
// is at (i + 0.5) * 2 / n - 1, one pixel of margin each side.
__device__ __forceinline__ void pixel_range(float vmin, float vmax, int n,
                                            int& lo, int& hi) {
  const float half = 0.5f * static_cast<float>(n);
  const float top = static_cast<float>(n) + 1.0f;  // clamped before the
  // conversions to int, which a far corner would overflow
  const float a = fminf(fmaxf((vmin + 1.0f) * half - 0.5f, -2.0f), top);
  const float b = fminf(fmaxf((vmax + 1.0f) * half - 0.5f, -2.0f), top);
  lo = max(static_cast<int>(floorf(a)) - 1, 0);
  hi = min(static_cast<int>(ceilf(b)) + 1, n - 1);
}

__global__ void __launch_bounds__(kWarps * 32)
raster_cover_kernel(const float* __restrict__ fvi,
                    const float* __restrict__ fz,
                    const uint8_t* __restrict__ valid,
                    unsigned long long* __restrict__ keys, int F, int H,
                    int W) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= F || (valid != nullptr && !valid[f])) return;
  const Tri t = load_tri(fvi, f);
  if (!(fabsf(t.area) >= kMinArea)) return;  // degenerate, or not finite
  if (!isfinite(t.x0) || !isfinite(t.y0) || !isfinite(t.x1) ||
      !isfinite(t.y1) || !isfinite(t.x2) || !isfinite(t.y2))
    return;
  int i0, i1, j0, j1;  // columns, rows
  pixel_range(fminf(fminf(t.x0, t.x1), t.x2),
              fmaxf(fmaxf(t.x0, t.x1), t.x2), W, i0, i1);
  pixel_range(fminf(fminf(t.y0, t.y1), t.y2),
              fmaxf(fmaxf(t.y0, t.y1), t.y2), H, j0, j1);
  if (i0 > i1 || j0 > j1) return;
  const float z0 = fz[3ll * f], z1 = fz[3ll * f + 1], z2 = fz[3ll * f + 2];
  const int bw = i1 - i0 + 1;
  const long long n = static_cast<long long>(bw) * (j1 - j0 + 1);
  const unsigned tag = 0xFFFFFFFFu - static_cast<unsigned>(f);
  for (long long k = static_cast<long long>(blockIdx.y) * 32 + lane; k < n;
       k += 32ll * gridDim.y) {
    const int j = j0 + static_cast<int>(k / bw);
    const int i = i0 + static_cast<int>(k % bw);
    float b0, b1, b2;
    if (!bary(t, pixel_center(i, W), pixel_center(j, H), b0, b1, b2))
      continue;
    float z = __fadd_rn(__fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1)),
                        __fmul_rn(b2, z2));
    if (isnan(z)) continue;
    z = __fadd_rn(z, 0.0f);  // -0 -> +0: the two compare equal
    unsigned u = __float_as_uint(z);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    atomicMax(keys + static_cast<long long>(j) * W + i,
              (static_cast<unsigned long long>(u) << 32) | tag);
  }
}

__global__ void __launch_bounds__(kResolveThreads)
raster_resolve_kernel(const float* __restrict__ fvi,
                      const float* __restrict__ feat,
                      const unsigned long long* __restrict__ keys,
                      float* __restrict__ out, int* __restrict__ face_idx,
                      int H, int W, int C) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= static_cast<long long>(H) * W) return;
  const unsigned long long key = keys[p];
  float* o = out + p * C;
  if (key == 0ull) {
    face_idx[p] = -1;
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  const int f = static_cast<int>(0xFFFFFFFFu -
                                 static_cast<unsigned>(key & 0xFFFFFFFFull));
  face_idx[p] = f;
  const Tri t = load_tri(fvi, f);
  const int i = static_cast<int>(p % W), j = static_cast<int>(p / W);
  float b0, b1, b2;
  bary(t, pixel_center(i, W), pixel_center(j, H), b0, b1, b2);
  const float* f0 = feat + 3ll * C * f;
  const float *f1 = f0 + C, *f2 = f0 + 2 * C;
  for (int c = 0; c < C; ++c) {
    o[c] = fma_f64(b2, f2[c], fma_f64(b1, f1[c], __fmul_rn(b0, f0[c])));
  }
}

}  // namespace
}  // namespace dtp

// keys: H*W 64-bit words of scratch (zeroed here); valid may be null.
// slices: gridDim.y of the cover pass, the ways each face's box is cut.
extern "C" int dtp_rasterize(const float* fvi, const float* fz,
                             const float* feat, const uint8_t* valid,
                             unsigned long long* keys, float* out,
                             int* face_idx, int F, int H, int W, int C,
                             int slices, cudaStream_t stream) {
  using namespace dtp;
  const long long P = static_cast<long long>(H) * W;
  cudaError_t err = cudaMemsetAsync(keys, 0, P * sizeof(*keys), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F > 0) {
    raster_cover_kernel<<<dim3((F + kWarps - 1) / kWarps, slices),
                          kWarps * 32, 0, stream>>>(fvi, fz, valid, keys, F,
                                                    H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_resolve_kernel<<<static_cast<unsigned>(
                              (P + kResolveThreads - 1) / kResolveThreads),
                          kResolveThreads, 0, stream>>>(fvi, feat, keys, out,
                                                        face_idx, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
