// The conv family's staged-tile mode: 3x3 SAME and nearest-x2 upsample
// convs, NHWC, whose blocks copy their input window into shared memory
// once per channel chunk and read every tap from there, with an optional
// GroupNorm prologue that derives its affine from per-(image, channel)
// statistics inside the kernel.
//
// Replaces (TPU, diffusiontexturepainting_tpu/ops/conv3x3.py):
//   dtp_conv3x3_staged             <- _conv_kernel_inpad (K12a), under the
//                                     port's _IN_PAD switch, and
//                                     _conv3x3_stream / _conv_stream_kernel
//                                     (K11), in fp32 only: the FMA twin.
//                                     In bf16 K12a and K11 run the PLAIN
//                                     mode of csrc/gn_conv_sm90.cu (K7's
//                                     kernel: TMA's out-of-bounds zeros are
//                                     K12a's on-chip padding, its windows
//                                     K11's streamed rows), and this entry
//                                     refuses bf16: its SAME mode serves
//                                     nothing in bf16 any more
//   dtp_upsample2x_conv3x3_staged  <- _upconv_pallas / _upconv_kernel
//                                     (K12b), under _IN_PAD, in fp32 only:
//                                     the FMA twin. In bf16 K12b runs the
//                                     upsample mode of csrc/gn_conv_sm90.cu
//                                     (K4's kernel: TMA's out-of-bounds
//                                     zeros are K12b's on-chip padding), and
//                                     this entry refuses bf16
//   dtp_gn_silu_conv3x3_staged     <- gn_silu_conv3x3 / _gn_conv_kernel
//                                     (K10), after csrc/moments.cu's
//                                     statistics pass over x, in fp32
//                                     only: the FMA twin. In bf16 K10 runs
//                                     the affine mode of csrc/
//                                     gn_conv_sm90.cu (the fold in the CTA,
//                                     one rounding), and this entry refuses
//                                     bf16
//
// What they compute:
//   SAME: out[b,y,x,n] = bias[n] + sum_{di,dj,c} v[b,y+di-1,x+dj-1,c]
//                                                * w[di,dj,c,n]
//         with v = x, or in the GroupNorm mode (GN)
//         v = round_T(silu(x*a[b,c] + c[b,c])) computed in fp32 and zero
//         outside the image (silu(0*a + c) != 0, so the border skips the
//         prologue), where per group g of Cin/G channels
//           n = H*W*Cin/G, mean = S1_g/n, var = S2_g/n - mean^2,
//           a = rsqrt(var + eps)*scale[c], c = shift[c] - mean*a
//         from the fp32 sums S1, S2 of x; then
//         y = acc + bias[n] + temb[b,n] + residual[b,y,x,n] in fp32 and one
//         rounding to T (the TPU kernel's order; K1/K5 of csrc/conv3x3.cu
//         round a, c, the affine and the conv before the residual).
//   UP:   conv3x3(nearest_x2(x)) as four parity planes (ry, rx), each 2x2
//         folded taps over the source image, w16[(ry*2+rx)*4 + ai*2+bi]:
//         out[b,2y+ry,2x+rx,n] = bias[n] + sum_{ai,bi,c}
//                x[b,y+ry+ai-1,x+rx+bi-1,c] * w16[...,c,n]
//         Every tap of every plane reads the same (TH+2) x (TW+2) window of
//         the source patch.
//
// The design: a block owns a TH x TW patch of one image's output pixels
// (4 x 16 = 64 GEMM rows) and one Cout tile
// of BN columns (and, in UP, one parity plane). For each chunk of BK input
// channels it copies the patch's halo window, (TH+2) x (TW+2) x BK, into
// shared memory once, writing zeros where the window leaves the image:
// SAME padding done on chip, the Hopper counterpart of K12's zero-bordered
// VMEM scratch and of K11's row window with halo. The 9 taps (SAME, GN) or
// the plane's 4 folded taps (UP) then read their A operands from that
// window: a tap is the window shifted by (dy, dx). The GroupNorm prologue
// runs once per staged element, not once per tap. B (one tap's BK x BN
// weights) is loaded per tap. The fp32 FMA tile (csrc/gemm_tile.cuh). No
// split-K and no atomics: every run gives the same bits.
//
// What bounds it on the H100: the fp32 FMA rate at the UNet's and VAE's
// shapes (K = 9*Cin up to 23040), fed by an un-pipelined loop (stage,
// sync, load B, sync, FMA, sync); at the UNet's 4x4 and 8x8 levels a patch
// is mostly outside the image, and with no split-K the small levels run
// few blocks. Plain loads only: the twins of the bf16 wgmma/TMA kernels.
#include "conv_staged.cuh"

namespace dtp {
namespace {

enum StagedMode : int {
  kSame = 0,  // 3x3 SAME conv (fp32 only)
  kUp = 1,    // nearest x2 + 3x3 conv, as four parity planes of 2x2 taps
              // (fp32 only)
  kGn = 2,    // 3x3 SAME conv of the GroupNorm -> SiLU prologue's output
};

constexpr int kMaxGroups = 128;

template <typename T>
struct StagedArgs {
  const T* x;          // (B, H, W, Cin)
  const T* w;          // SAME (9, Cin, Cout); UP (16, Cin, Cout)
  const T* bias;       // (Cout,) or null
  const float* stats;  // (B, 2, Cin) fp32 sums of x and x^2 (GN)
  const T* gn_scale;   // (Cin,) with stats
  const T* gn_shift;   // (Cin,) with stats
  const T* temb;       // (B, Cout) or null
  const T* residual;   // (B, H, W, Cout) or null
  T* out;
  float eps;
  int B, H, W, Cin, Cout, groups, tiles_y, tiles_x;
  bool vec_x, vec_w;
};

// Grid: x = image * patches, y = Cout tiles, z = parity plane (UP).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const StagedArgs<T> p) {
  constexpr bool UP = MODE == kUp;
  constexpr bool gn = MODE == kGn;
  using TL = Tile<T>;
  using PT = Patch<T>;
  constexpr int TH = PT::TH, TW = PT::TW, LDW = PT::LDW;
  constexpr int WH = TH + 2, WW = TW + 2;
  constexpr int BK = TL::BK;
  constexpr int V = 16 / sizeof(T);
  constexpr int W_CPP = BK / V;  // 16-byte chunks per window pixel
  constexpr int WIN_CHUNKS = WH * WW * W_CPP;
  constexpr int B_CPR = TL::BN / V;
  constexpr int B_CHUNKS = BK * B_CPR / kThreads;
  constexpr int kTaps = UP ? 4 : 9;
  static_assert(TH * TW == TL::BM, "one patch per tile");
  static_assert(B_CHUNKS * kThreads == BK * B_CPR, "B tile split");
  // 16-byte rows for the staging stores
  static_assert(LDW >= BK && (LDW * sizeof(T)) % 16 == 0, "window rows");

  __shared__ __align__(128) T win[WH * WW * LDW];
  __shared__ __align__(128) T Bs[BK * TL::LDB];
  __shared__ float gn_a[BK], gn_c[BK];
  __shared__ float g_mean[kMaxGroups], g_inv[kMaxGroups];

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tid = threadIdx.x;
  const int per_image = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_image;
  const int patch = blockIdx.x - b * per_image;
  const int y0 = (patch / p.tiles_x) * TH, x0 = (patch % p.tiles_x) * TW;
  const int n0 = blockIdx.y * TL::BN;
  const int plane = UP ? blockIdx.z : 0;
  const int ry = plane >> 1, rx = plane & 1;
  const int cpg = gn ? Cin / p.groups : 1;

  // the image's group mean and 1/std, once per block
  if constexpr (gn) {
    const float n = (float)((long long)H * W * cpg);
    const float* s = p.stats + (size_t)b * 2 * Cin;
    for (int g = tid; g < p.groups; g += kThreads) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
        s1 += s[c];
        s2 += s[Cin + c];
      }
      const float mean = s1 / n;
      g_mean[g] = mean;
      g_inv[g] = rsqrtf(s2 / n - mean * mean + p.eps);
    }
    __syncthreads();
  }

  typename MathFor<T>::type math;
  math.init();

  for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
    if constexpr (gn) {
      if (tid < BK) {
        const int c = ci0 + tid;
        float a = 0.0f, sh = 0.0f;
        if (c < Cin) {
          const int g = c / cpg;
          a = g_inv[g] * to_float(p.gn_scale[c]);
          sh = to_float(p.gn_shift[c]) - g_mean[g] * a;
        }
        gn_a[tid] = a;
        gn_c[tid] = sh;
      }
      __syncthreads();
    }
    // the halo window of this channel chunk, zero outside the image
    for (int i = tid; i < WIN_CHUNKS; i += kThreads) {
      const int pix = i / W_CPP, col = (i - pix * W_CPP) * V;
      const int wy = pix / WW, wx = pix - wy * WW;
      const int yy = y0 + wy - 1, xx = x0 + wx - 1;
      const bool inb = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const int nvalid = inb ? Cin - (ci0 + col) : 0;
      const T* src =
          inb ? p.x + (((size_t)b * H + yy) * W + xx) * Cin + ci0 + col : p.x;
      T* dst = win + pix * LDW + col;
      load_chunk(dst, src, nvalid, p.vec_x);
      if (gn && nvalid > 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (e < nvalid) {
            const float t =
                to_float(dst[e]) * gn_a[col + e] + gn_c[col + e];
            dst[e] = from_float<T>(t / (1.0f + __expf(-t)));
          }
        }
      }
    }
    for (int tap = 0; tap < kTaps; ++tap) {
      int dy, dx;
      const T* wt;
      if (UP) {
        dy = ry + (tap >> 1) - 1;
        dx = rx + (tap & 1) - 1;
        wt = p.w + (size_t)(plane * 4 + tap) * Cin * Cout;
      } else {
        dy = tap / 3 - 1;
        dx = tap % 3 - 1;
        wt = p.w + (size_t)tap * Cin * Cout;
      }
#pragma unroll
      for (int i = 0; i < B_CHUNKS; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / B_CPR, col = (c % B_CPR) * V;
        const int k = ci0 + r, n = n0 + col;
        const bool ok = k < Cin;
        const T* src = ok ? wt + (size_t)k * Cout + n : wt;
        load_chunk(Bs + r * TL::LDB + col, src, ok ? Cout - n : 0, p.vec_w);
      }
      __syncthreads();  // the window (first tap) and this tap's B are in
      staged_step<WW, LDW>(math, win, Bs, tid, 1, dy + 1, dx + 1);
      __syncthreads();  // before the next B or the next chunk's window
    }
  }

  auto store = [&](int lr, int lc, float v) {
    const int y = y0 + lr / TW, xq = x0 + lr % TW, n = n0 + lc;
    if (y >= H || xq >= W || n >= Cout) return;
    const size_t o =
        UP ? (((size_t)b * 2 * H + 2 * y + ry) * (2 * W) + 2 * xq + rx) *
                     Cout + n
           : (((size_t)b * H + y) * W + xq) * Cout + n;
    if (p.bias != nullptr) v += to_float(p.bias[n]);
    if (p.temb != nullptr) v += to_float(p.temb[(size_t)b * Cout + n]);
    if (p.residual != nullptr) v += to_float(p.residual[o]);
    p.out[o] = from_float<T>(v);
  };
  math.epilogue(reinterpret_cast<float*>(win), tid, store);
}

template <typename T, int MODE>
cudaError_t launch(StagedArgs<T> p, cudaStream_t stream) {
  using TL = Tile<T>;
  using PT = Patch<T>;
  constexpr int V = 16 / sizeof(T);
  if (p.B <= 0 || p.H <= 0 || p.W <= 0 || p.Cin <= 0 || p.Cout <= 0 ||
      p.x == nullptr || p.w == nullptr || p.out == nullptr)
    return cudaErrorInvalidValue;
  if (MODE == kGn &&
      (p.stats == nullptr || p.groups <= 0 || p.groups > kMaxGroups ||
       p.Cin % p.groups != 0 || p.gn_scale == nullptr ||
       p.gn_shift == nullptr))
    return cudaErrorInvalidValue;
  p.tiles_y = (p.H + PT::TH - 1) / PT::TH;
  p.tiles_x = (p.W + PT::TW - 1) / PT::TW;
  const long long blocks = (long long)p.B * p.tiles_y * p.tiles_x;
  const long long col_tiles = (p.Cout + TL::BN - 1) / TL::BN;
  if (blocks > 0x7fffffffLL || col_tiles > 65535) return cudaErrorInvalidValue;
  p.vec_x = p.Cin % V == 0 && aligned16(p.x);
  p.vec_w = p.Cout % V == 0 && aligned16(p.w);
  dim3 grid((unsigned)blocks, (unsigned)col_tiles, MODE == kUp ? 4u : 1u);
  staged_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const void* x, const void* w, const void* bias,
                     const float* stats, const void* gn_scale,
                     const void* gn_shift, const void* temb,
                     const void* residual, void* out, float eps, int B, int H,
                     int W, int Cin, int Cout, int groups, int is_bf16,
                     void* stream) {
  // bf16 SAME is K7's kernel, bf16 UP K4's and bf16 GN K10's
  // (csrc/gn_conv_sm90.cu): not instantiated
  if (is_bf16) return cudaErrorInvalidValue;
  StagedArgs<float> p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.stats = stats;
  p.gn_scale = static_cast<const float*>(gn_scale);
  p.gn_shift = static_cast<const float*>(gn_shift);
  p.temb = static_cast<const float*>(temb);
  p.residual = static_cast<const float*>(residual);
  p.out = static_cast<float*>(out);
  p.eps = eps;
  p.B = B, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.groups = groups;
  return launch<float, MODE>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace dtp

// K12a / K11 in fp32: x (B,H,W,Cin), w (3,3,Cin,Cout), bias (Cout,),
// out (B,H,W,Cout), all fp32; is_bf16 returns cudaErrorInvalidValue (bf16
// K12a and K11 run dtp_conv3x3_sm90 of csrc/gn_conv_sm90.cu).
extern "C" cudaError_t dtp_conv3x3_staged(const void* x, const void* w,
                                          const void* bias, void* out, int B,
                                          int H, int W, int Cin, int Cout,
                                          int is_bf16, void* stream) {
  return dtp::dispatch<dtp::kSame>(x, w, bias, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, out, 0.0f, B, H, W, Cin,
                                   Cout, 0, is_bf16, stream);
}

// K12b in fp32: x (B,H,W,Cin), w16 (16,Cin,Cout) folded taps, bias
// (Cout,), out (B,2H,2W,Cout), all fp32; is_bf16 returns
// cudaErrorInvalidValue (bf16 K12b runs dtp_upsample2x_conv3x3_sm90 of
// csrc/gn_conv_sm90.cu).
extern "C" cudaError_t dtp_upsample2x_conv3x3_staged(
    const void* x, const void* w16, const void* bias, void* out, int B,
    int H, int W, int Cin, int Cout, int is_bf16, void* stream) {
  return dtp::dispatch<dtp::kUp>(x, w16, bias, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, out, 0.0f, B, H, W, Cin,
                                 Cout, 0, is_bf16, stream);
}

// K10's conv in fp32: x (B,H,W,Cin); stats (B,2,Cin) sums of x and x^2
// over H, W (csrc/moments.cu); scale, shift (Cin,) the GroupNorm's affine
// with `groups` groups (Cin % groups == 0, at most 128); w (3,3,Cin,Cout);
// bias (Cout,) or null; temb (B,Cout) or null; residual (B,H,W,Cout) or
// null; out (B,H,W,Cout); all fp32. is_bf16 returns cudaErrorInvalidValue
// (bf16 K10 runs dtp_gn_silu_conv3x3_sm90 of csrc/gn_conv_sm90.cu).
extern "C" cudaError_t dtp_gn_silu_conv3x3_staged(
    const void* x, const void* stats, const void* scale, const void* shift,
    const void* w, const void* bias, const void* temb, const void* residual,
    void* out, float eps, int B, int H, int W, int Cin, int Cout, int groups,
    int is_bf16, void* stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  return dtp::dispatch<dtp::kGn>(
      x, w, bias, static_cast<const float*>(stats), scale, shift, temb,
      residual, out, eps, B, H, W, Cin, Cout, groups, is_bf16, stream);
}
