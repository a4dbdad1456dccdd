"""Chained GroupNorm -> SiLU -> 3x3 conv with residual and statistics
epilogues, and the x2-upsample and stride-2 downsample convs with
statistics, NHWC.

Port of diffusiontexturepainting_tpu/ops/gn_conv_stream.py (and of
ops/conv3x3.py gn_conv_resident, which computes the same function). Each
conv emits the fp32 (sum, sumsq) per (batch, channel) of its output, so the
next GroupNorm folds into a per-(B, C) affine (groupnorm.gn_affine_from_stats)
with no pass of its own over the tensor:

    h1, s1 = gn_conv(x,  affine(s_x), conv1)          # GN1 + SiLU + conv1
    y,  sy = gn_conv(h1, affine(s1),  conv2, res=x')  # GN2 + SiLU + conv2

Kernels (csrc/conv3x3.cu, the conv family's fused modes, and two sm_90a
kernels); a wrapper takes the plain version only for a tensor on the CPU,
and for a CUDA tensor it launches the kernel or raises:

  gn_conv_resident  kernel K1 (replaces conv3x3.py _gn_conv_resident_pallas /
                    _gn_res_kernel), the UNet's resnets
  gn_conv_stream    kernel K5 (replaces gn_conv_stream.py
                    _stream_fused_pallas / _kernel), the VAE's resnets and
                    heads; the same kernel as K1, counted apart. In bf16 a
                    warp-specialised wgmma/TMA implicit GEMM with the
                    prologue once per staged element and its statistics in
                    the epilogue (csrc/gn_conv_sm90.cu; operands TMA cannot
                    describe raise ValueError; a head whose Cout is off 8
                    passes a zero-padded weight and `out_channels`), in fp32
                    the conv family's fused mode (its FMA twin)
  upconv_stream     kernel K6 (replaces gn_conv_stream.py
                    _upconv_stream_pallas / _upconv_stream_kernel)
  downconv_stream   kernel K9 (replaces gn_conv_stream.py
                    _downconv_stream_pallas / _downconv_kernel), the VAE
                    encoder's level transitions: in bf16 a warp-specialised
                    wgmma/TMA implicit GEMM with its statistics in the
                    epilogue (csrc/conv_sm90.cu; operands TMA cannot
                    describe raise ValueError), in fp32 the conv family's
                    stride-2 mode (its FMA twin)

The bf16 K4 (ops/conv3x3.py upsample2x_conv3x3) runs the upsample mode of
csrc/gn_conv_sm90.cu; its plan, upconv_sm90_plan, is here beside K1/K5's,
with which it shares the tile geometry.

Statistics are (B, 2, C) fp32: row 0 the sum, row 1 the sum of squares over
the spatial axes (the TPU's 8-row padding is a sublane minimum and is not
kept). stats_of takes them of a tensor no conv produced, through kernel K14
(ops/groupnorm.py) on CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _cuda
from .conv3x3 import _KERNEL_DTYPES, _SPLIT_ARGTYPES, conv3x3_plain
from .groupnorm import spatial_moments, spatial_moments_plain

gn_conv_resident_launches = _cuda.LaunchCounter("gn_conv_resident")
gn_conv_stream_launches = _cuda.LaunchCounter("gn_conv_stream")
upconv_stream_launches = _cuda.LaunchCounter("upconv_stream")
downconv_stream_launches = _cuda.LaunchCounter("downsample_conv3x3_stats")

_GN_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9
                + (ctypes.c_void_p,))
_GN_SM90_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6
                     + (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 3
                     + (ctypes.c_void_p,))
_UP_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8
                + (ctypes.c_void_p,))
_DOWN_SM90_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
                       + (ctypes.c_void_p,))

# bf16 K9 (csrc/conv_sm90.cu), bf16 K1/K5 (csrc/gn_conv_sm90.cu) and what
# their plans read of the H100
DOWN_SM90_SOURCE = "conv_sm90"
GN_SM90_SOURCE = "gn_conv_sm90"
SM_COUNT = 132
SMEM_LIMIT = 232448


# --- GroupNorm statistics algebra (fp32) ---


def stats_of(x):
    """(B, 2, C) fp32 (sum, sumsq) over the spatial axes of an NHWC tensor,
    for a layer input that did not come from a conv's epilogue (kernel K14
    on CUDA)."""
    return spatial_moments(x)


def shift_stats_for_temb(stats, temb, n_spatial: int):
    """Statistics of h + t[:, None, None, :] given those of h: the UNet adds
    the time embedding between conv1 and GN2; folding it here and into the
    next affine (c + t*a) leaves h + t unmaterialized."""
    t = temb.float()
    s1 = stats[:, 0] + n_spatial * t
    s2 = stats[:, 1] + 2.0 * t * stats[:, 0] + n_spatial * t * t
    return torch.stack([s1, s2], dim=1)


# --- plain versions ---


def gn_conv3x3_plain(x, a, c, w, b, residual=None, want_stats=True,
                     apply_gn=True):
    """silu(x*a + c) -> 3x3 SAME conv + b -> round -> + residual (in x's
    dtype), and the fp32 statistics of the result (port of
    gn_conv_stream._reference). a, c: (B, Cin) fp32, rounded to x's dtype
    before use; b may be None. The prologue runs in x's dtype, as the
    module path's GroupNorm applies its affine; in bf16 the conv rounds
    before the bias add, one rounding more than the kernel."""
    if apply_gn:
        dt = x.dtype
        v = x * a[:, None, None, :].to(dt) + c[:, None, None, :].to(dt)
        v = v * torch.sigmoid(v)
    else:
        v = x
    bias = b if b is not None else torch.zeros(w.shape[-1], dtype=x.dtype,
                                               device=x.device)
    y = conv3x3_plain(v, w, bias)
    if residual is not None:
        y = y + residual
    return y, (spatial_moments_plain(y) if want_stats else None)


def upconv_stream_plain(x, w, b, want_stats=True):
    """Nearest x2 + 3x3 conv + b, with fp32 statistics of the output before
    its rounding to x's dtype (port of _upconv_stream_reference; in bf16
    the conv rounds before the bias add, one rounding more than the
    kernel)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = F.conv2d(up.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return _bias_stats_round(y, b, x.dtype, want_stats)


def downconv_stream_plain(x, w, b, want_stats=True):
    """3x3 stride-2 conv over x padded by one zero row below and one zero
    column to the right, + b, with fp32 statistics of the output before its
    rounding to x's dtype: (out (B,H/2,W/2,Cout), stats or None) (port of
    _downconv_reference; in bf16 the conv rounds before the bias add, one
    rounding more than the kernel)."""
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2)
    return _bias_stats_round(y, b, x.dtype, want_stats)


def _bias_stats_round(y_nchw, b, dtype, want_stats):
    """The plain resampling convs' epilogue: + b in fp32, statistics of
    that, then the rounding to `dtype`."""
    y = y_nchw.permute(0, 2, 3, 1).float()
    if b is not None:
        y = y + b.float()
    stats = spatial_moments_plain(y) if want_stats else None
    return y.to(dtype).contiguous(), stats


# --- the bf16 K9's host plan (csrc/conv_sm90.cu plan) ---


def downconv_sm90_plan(B: int, H: int, W: int, cin: int, cout: int,
                       consumers: int | None = None) -> dict:
    """The tile bf16 K9 launches for x (B, H, W, cin) and cout output
    channels: `consumers` warpgroups of 64 output pixels (4 rows of 16
    columns each) by 128 channels, two unless that grid would leave more
    than half of the SMs idle (or as forced); K steps of 64 input channels
    over the 9 taps through `stages` stages of A and B; its dynamic shared
    memory (the stages, the bf16 output staging, the per-warp statistics,
    the mbarriers, 1024 bytes of alignment); the grid of n_tiles x m_tiles
    CTAs, m_tiles = B x tiles_h x tiles_w."""
    def of(nc):
        rows, pix, stages = 4 * nc, 64 * nc, 4
        smem = (stages * (pix * 128 + 64 * 128 * 2) + pix * 128 * 2
                + 4 * nc * 2 * 128 * 4 + 8 * 2 * stages + 1024)
        tiles_h, tiles_w = -(-(H // 2) // rows), -(-(W // 2) // 16)
        return dict(consumers=nc, rows=rows, cols=16, bn=128, bk=64,
                    stages=stages, smem=smem, tiles_h=tiles_h,
                    tiles_w=tiles_w, m_tiles=B * tiles_h * tiles_w,
                    n_tiles=-(-cout // 128), k_steps=9 * -(-cin // 64))
    two = of(2)
    if consumers == 2 or (consumers is None and
                          2 * two["m_tiles"] * two["n_tiles"] >= SM_COUNT):
        return two
    return of(1)


def downconv_tma_describable(x, w) -> bool:
    """Whether TMA can read bf16 K9's operands: 16-byte-aligned bases and
    Cin, Cout multiples of 8 (rows of whole 16 bytes)."""
    return (x.shape[-1] % 8 == 0 and w.shape[-1] % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


# --- the bf16 K1/K5's and K4's host plans (csrc/gn_conv_sm90.cu plan,
# up_plan) ---

GN_BN, GN_BK, GN_WIN_STAGES, GN_MAX_B_STAGES = 128, 64, 2, 8
GN_B_BYTES = GN_BK * GN_BN * 2  # one tap's weights of a chunk
UP_PLANES, UP_MAX_B_STAGES = 4, 12


def _gn_tile(B, H, W, cin, cout, nc):
    """The geometry of a tile of 64 * nc pixels (the source's plan_of):
    `nb` whole images of `rows` x `tw` pixels (tw 4, 8 or 16 from W; rows
    a multiple of 16 / tw) where they fit, else `rows` x `tw` of one image;
    its input window of nb x (rows+2) x (tw+2) lines of 64 channels; the
    M x N grid by 128 channels; K in chunks of 64 channels."""
    pix = 64 * nc
    tw = 4 if W <= 4 else 8 if W <= 8 else 16
    if W <= tw and H * tw <= pix:
        unit = 16 // tw
        rows = -(-H // unit) * unit
        nb = min(pix // (rows * tw), B)
        tiles_h = tiles_w = 1
        m_tiles = -(-B // nb)
    else:
        rows, nb = pix // tw, 1
        tiles_h, tiles_w = -(-H // rows), -(-W // tw)
        m_tiles = B * tiles_h * tiles_w
    win_lines = nb * (rows + 2) * (tw + 2)
    return dict(tw=tw, rows=rows, nb=nb, win_lines=win_lines,
                win_bytes=-(-win_lines * 128 // 1024) * 1024,
                tiles_h=tiles_h, tiles_w=tiles_w, tpi=tiles_h * tiles_w,
                m_tiles=m_tiles, n_tiles=-(-cout // GN_BN),
                chunks=-(-cin // GN_BK), bn=GN_BN, bk=GN_BK)


def _split(p, splits):
    """K split into runs of whole chunks over as many CTAs as fill the SMs
    once where the tiles do not (or as forced): sets per_split, splits."""
    ctas = p["m_tiles"] * p["n_tiles"]
    s = splits if splits else (1 if ctas >= SM_COUNT else SM_COUNT // ctas)
    s = min(s, p["chunks"])
    per = -(-p["chunks"] // s)
    p["per_split"], p["splits"] = per, -(-p["chunks"] // per)


@functools.lru_cache(maxsize=None)
def gn_conv_sm90_plan(B: int, H: int, W: int, cin: int, cout: int,
                      cs: int | None = None, want_stats: bool = True,
                      consumers: int | None = None,
                      splits: int | None = None) -> dict:
    """The tile bf16 K1/K5 launches for x (B, H, W, cin) and a weight of
    cout output channels, cs of them stored (cout when None): `consumers`
    warpgroups of 64 output pixels, a tile of `nb` whole images of `rows`
    x `tw` pixels (tw 4, 8 or 16 from W; rows a multiple of 16 / tw) where
    they fit, else `rows` x `tw` of one image; by 128 channels. Two
    consumers unless that grid would leave more than half of the SMs
    idle; then K (ceil(cin/64) chunks of 64 channels x 9 taps) split into
    runs of whole chunks over as many CTAs as fill the SMs once (or as
    forced). Its dynamic shared memory: two staged input windows of
    nb x (rows+2) x (tw+2) pixels x 64 channels and two buffers V of the
    prologue's output (each rounded up to 1 KiB; the bf16 output staging
    aliases them), `stages` B stages of 64 x 128 weights, the per-warp
    statistics, the mbarriers and split flag, 1024 bytes of alignment.
    `work_floats`: the one buffer beside the output: the (B, 2, cs)
    statistics, the tile partials when an image spans tiles, the split
    tiles and counters. Cached: the dict is shared, read it only."""
    cs = cout if cs is None else cs

    def of(nc):
        t = _gn_tile(B, H, W, cin, cout, nc)
        region0 = max(4 * t["win_bytes"], 64 * nc * GN_BN * 2)
        fixed = (region0 + 4 * nc * 2 * GN_BN * 4
                 + 8 * 2 * (GN_WIN_STAGES + GN_MAX_B_STAGES) + 16 + 1024)
        stages = min(GN_MAX_B_STAGES, (SMEM_LIMIT - fixed) // GN_B_BYTES)
        return dict(consumers=nc, **t, stages=stages,
                    smem=fixed + stages * GN_B_BYTES)

    p = of(2)
    if not (consumers == 2 or (consumers is None and
                               2 * p["m_tiles"] * p["n_tiles"] >= SM_COUNT)):
        p = of(1)
    _split(p, splits)
    ctas = p["m_tiles"] * p["n_tiles"]
    p["work_floats"] = (
        (2 * B * cs if want_stats else 0)
        + (2 * B * p["tpi"] * cs if want_stats and p["tpi"] > 1 else 0)
        + (ctas * p["splits"] * 64 * p["consumers"] * GN_BN + ctas
           if p["splits"] > 1 else 0))
    return p


@functools.lru_cache(maxsize=None)
def upconv_sm90_plan(B: int, H: int, W: int, cin: int, cout: int,
                     splits: int | None = None) -> dict:
    """The tile bf16 K4 launches for the source x (B, H, W, cin) and cout
    output channels: the tile of one K1/K5 consumer warpgroup (64 source
    pixels; _gn_tile) by 128 channels, for all four parity planes, one
    warpgroup a plane; two staged input windows (each rounded up to 1 KiB)
    and `stages` B stages of 64 x 128 folded weights, a multiple of the
    four planes, each plane's in turn (the bf16 output staging of 4 x 64 x
    128 aliases them); the mbarriers and split flag, 1024 bytes of
    alignment. K
    (ceil(cin/64) chunks x 16 taps) split as K1/K5 split it (or as
    forced). `work_floats`: the split tiles and counters, 0 without a
    split. Cached: the dict is shared, read it only."""
    p = dict(consumers=UP_PLANES, **_gn_tile(B, H, W, cin, cout, 1))
    fixed = (GN_WIN_STAGES * p["win_bytes"]
             + 8 * (2 * GN_WIN_STAGES + UP_MAX_B_STAGES) + 16 + 1024)
    p["stages"] = min(UP_MAX_B_STAGES, (SMEM_LIMIT - fixed) // GN_B_BYTES
                      // UP_PLANES * UP_PLANES)
    p["smem"] = fixed + p["stages"] * GN_B_BYTES
    _split(p, splits)
    ctas = p["m_tiles"] * p["n_tiles"]
    p["work_floats"] = (ctas * p["splits"] * 64 * UP_PLANES * GN_BN + ctas
                        if p["splits"] > 1 else 0)
    return p


def upconv_tma_describable(x, taps) -> bool:
    """Whether TMA can read bf16 K4's operands: Cin and Cout multiples of 8
    (rows of whole 16 bytes) and 16-byte-aligned bases."""
    return (x.shape[-1] % 8 == 0 and taps.shape[-1] % 8 == 0
            and x.data_ptr() % 16 == 0 and taps.data_ptr() % 16 == 0)


def gn_conv_tma_describable(x, w) -> bool:
    """Whether TMA can read bf16 K1/K5's operands: Cin and the weight's
    Cout multiples of 8 (rows of whole 16 bytes), 16-byte-aligned bases and
    a tap stride of whole 16 bytes (a slice of a wider weight's input
    channels included)."""
    return (x.shape[-1] % 8 == 0 and w.shape[-1] % 8 == 0
            and w.stride(1) % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def pad_cout(w, b):
    """(w, b) with the output channels zero-padded to a multiple of 8: what
    a head whose Cout TMA cannot describe (the VAE decoder's 3 channels)
    hands bf16 K5, with out_channels = the real Cout."""
    pad = -w.shape[-1] % 8
    if not pad:
        return w, b
    w8 = F.pad(w, (0, pad))
    return w8, (None if b is None else F.pad(b, (0, pad)))


# --- kernels ---


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, x, w, taps, *optional, w_view=False):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share bf16 or fp32, got "
                        f"{x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.shape[-2] != x.shape[-1] or w.shape[:-2] != taps:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if w_view:
        # a slice of a wider weight's input channels: the kernel reads the
        # taps stride(1) elements apart
        cin, cout = w.shape[-2:]
        if w.stride() != (3 * w.stride(1), w.stride(1), cout, 1) \
                or w.device != x.device:
            raise ValueError(f"{name}: weight strides {w.stride()}")
        w = None
    for t in (x, w) + tuple(t for t in optional if t is not None):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{x.device}")


def _workspaces(x, out, splits, want_stats, hw):
    B, cout = x.shape[0], out.shape[-1]
    partial = stats = ws = None
    if splits > 1 or want_stats:
        partial = torch.empty(splits * out.numel(), dtype=torch.float32,
                              device=x.device)
    if want_stats:
        n = _cuda.function("conv3x3", "dtp_stats_workspace_floats",
                           (ctypes.c_int,) * 3)(B, hw, cout)
        ws = torch.empty(n, dtype=torch.float32, device=x.device)
        stats = torch.empty((B, 2, cout), dtype=torch.float32,
                            device=x.device)
    return partial, ws, stats


def _gn_conv3x3(x, a, c, w, b, residual=None, want_stats=True,
                apply_gn=True, counter=None, out_channels=None,
                consumers=None, splits=None):
    """The fused conv (K1/K5's function) behind gn_conv_resident and
    gn_conv_stream: returns (out, stats or None).
    x (B,H,W,Cin); a, c (B,Cin) fp32 folded GroupNorm affine (unused when
    apply_gn is False); w (3,3,Cin,Cout); b (Cout,) or None; residual
    (B,H,W,Cout) or None. w may be a slice w_full[:, :, lo:hi] of a wider
    weight (the split concat conv); the kernel reads it in place.
    out_channels: w and b are zero-padded past the real Cout (pad_cout),
    and the output, residual and statistics have out_channels channels.
    On CUDA the launch is added to `counter`; bf16 runs
    csrc/gn_conv_sm90.cu (`consumers` 1 or 2 and `splits` force its tile
    and split of K: the tests and tools/sm90_plans.py call this entry
    with them), fp32 csrc/conv3x3.cu."""
    cs = w.shape[-1] if out_channels is None else out_channels
    if x.device.type == "cpu":
        if out_channels is not None:
            w, b = w[..., :cs], (None if b is None else b[:cs])
        return gn_conv3x3_plain(x, a, c, w, b, residual, want_stats,
                                apply_gn)
    _check("gn_conv3x3", x, w, (3, 3), b, residual, w_view=True)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    key = _shape_key(x, w, b, residual, want_stats, apply_gn, out_channels)
    if not 0 < cs <= cout or (b is not None and (b.shape != (cout,)
                                                 or b.dtype != x.dtype)):
        raise ValueError(f"gn_conv3x3: bias or out_channels {cs} do not fit "
                         f"w {tuple(w.shape)} {x.dtype}")
    if residual is not None and (residual.shape != (B, H, W, cs)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"gn_conv3x3: residual {tuple(residual.shape)} "
                         f"{residual.dtype} is not the output's "
                         f"{(B, H, W, cs)} {x.dtype}")
    if apply_gn:
        for t in (a, c):
            if t.shape != (B, cin) or t.device != x.device:
                raise ValueError(f"gn_conv3x3: expected a, c {(B, cin)} on "
                                 f"{x.device}, got {tuple(t.shape)}")
    if x.dtype == torch.bfloat16:
        if not gn_conv_tma_describable(x, w):
            raise ValueError("gn_conv3x3: TMA needs Cin and Cout multiples "
                             "of 8 and 16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)} strides "
                             f"{w.stride()}")
        if apply_gn:
            a, c = (t if t.dtype == torch.float32 and t.stride(1) == 1
                    else t.float().contiguous() for t in (a, c))
        plan = gn_conv_sm90_plan(B, H, W, cin, cout, cs, want_stats,
                                 consumers, splits)
        out = torch.empty((B, H, W, cs), dtype=x.dtype, device=x.device)
        # one allocation: the (B, 2, Cs) statistics first, then any tile
        # partials, split tiles and counters
        n = 2 * B * cs if want_stats else 0
        stats = work = None
        if plan["work_floats"] == n > 0:
            stats = work = torch.empty((B, 2, cs), dtype=torch.float32,
                                       device=x.device)
        elif plan["work_floats"]:
            work = torch.empty(plan["work_floats"], dtype=torch.float32,
                               device=x.device)
            stats = work[:n].view(B, 2, cs) if want_stats else None
        symbol = "dtp_gn_conv3x3_sm90"
        fn = _cuda.function(GN_SM90_SOURCE, symbol, _GN_SM90_ARGTYPES)
        code = fn(x.data_ptr(), _ptr(a) if apply_gn else None,
                  _ptr(c) if apply_gn else None, w.data_ptr(), _ptr(b),
                  _ptr(residual), out.data_ptr(), _ptr(work), B, H, W, cin,
                  cout, cs, w.stride(1), a.stride(0) if apply_gn else 0,
                  c.stride(0) if apply_gn else 0, int(want_stats),
                  consumers or 0, splits or 0, _cuda.stream_of(x))
        _cuda.check(GN_SM90_SOURCE, symbol, code)
        if counter is not None:
            counter.record(key)
        return out, stats
    dt = x.dtype
    if out_channels is not None:
        w = w[..., :cs].contiguous()
        b = None if b is None else b[:cs]
        cout = cs
    if apply_gn:
        a = a.to(dt).contiguous()
        c = c.to(dt).contiguous()
    else:
        a = c = None
    out = torch.empty((B, H, W, cout), dtype=dt, device=x.device)
    splits = _cuda.function("conv3x3", "dtp_conv3x3_splits",
                            _SPLIT_ARGTYPES)(B, H, W, cin, cout, 0)
    partial, ws, stats = _workspaces(x, out, splits, want_stats, H * W)
    fn = _cuda.function("conv3x3", "dtp_gn_conv3x3", _GN_ARGTYPES)
    code = fn(x.data_ptr(), _ptr(a), _ptr(c), w.data_ptr(), _ptr(b),
              _ptr(residual), out.data_ptr(), _ptr(partial), _ptr(ws),
              _ptr(stats), B, H, W, cin, cout, w.stride(1), splits,
              int(want_stats), 0, _cuda.stream_of(x))
    _cuda.check("conv3x3", "dtp_gn_conv3x3", code)
    if counter is not None:
        counter.record(key)
    return out, stats


def _shape_key(x, w, b, residual, want_stats, apply_gn, out_channels=None):
    """The function's shape: the weight as (3, 3, Cin, the real Cout)."""
    w_shape = tuple(w.shape[:-1]) + (out_channels or w.shape[-1],)
    return (tuple(x.shape), w_shape, b is not None, residual is not None,
            bool(want_stats), bool(apply_gn))


def gn_conv_resident(x, a, c, w, b, residual=None, want_stats=True,
                     apply_gn=True, out_channels=None):
    """The UNet resnets' fused conv (kernel K1 on CUDA)."""
    return _gn_conv3x3(x, a, c, w, b, residual, want_stats, apply_gn,
                       gn_conv_resident_launches, out_channels)


def gn_conv_stream(x, a, c, w, b, residual=None, want_stats=True,
                   apply_gn=True, out_channels=None):
    """The VAE's fused conv (kernel K5 on CUDA; the same kernel as K1).
    out_channels: w and b are zero-padded past the real Cout (pad_cout),
    as the VAE decoder's 3-channel head passes them."""
    return _gn_conv3x3(x, a, c, w, b, residual, want_stats, apply_gn,
                       gn_conv_stream_launches, out_channels)


def upconv_stream(x, w, b, taps, want_stats=True):
    """conv3x3(nearest_x2(x)) + b with fp32 statistics of the pre-rounding
    output: (out (B,2H,2W,Cout), stats or None). w (3,3,Cin,Cout) is read
    by the plain version on CPU; taps, the same weights through
    conv3x3.fold_upsample_weights, by kernel K6 on CUDA."""
    if x.device.type == "cpu":
        return upconv_stream_plain(x, w, b, want_stats)
    _check("upconv_stream", x, taps, (16,), b)
    B, H, W, cin = x.shape
    cout = taps.shape[-1]
    if b is not None and (b.shape != (cout,) or b.dtype != x.dtype):
        raise ValueError(f"upconv_stream: bias {tuple(b.shape)} {b.dtype}")
    out = torch.empty((B, 2 * H, 2 * W, cout), dtype=x.dtype,
                      device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    splits = _cuda.function("conv3x3", "dtp_upsample2x_conv3x3_splits",
                            _SPLIT_ARGTYPES)(B, H, W, cin, cout, bf16)
    partial, ws, stats = _workspaces(x, out, splits, want_stats, 4 * H * W)
    fn = _cuda.function("conv3x3", "dtp_upsample2x_conv3x3_stats",
                        _UP_ARGTYPES)
    code = fn(x.data_ptr(), taps.data_ptr(), _ptr(b), out.data_ptr(),
              _ptr(partial), _ptr(ws), _ptr(stats), B, H, W, cin, cout,
              splits, int(want_stats), bf16, _cuda.stream_of(x))
    _cuda.check("conv3x3", "dtp_upsample2x_conv3x3_stats", code)
    upconv_stream_launches.record((tuple(x.shape), (3, 3, cin, cout),
                                   bool(want_stats)))
    return out, stats


def downconv_stream(x, w, b, want_stats=True, consumers=None):
    """The VAE encoder's level transition: 3x3 stride-2 conv with the
    (0,1),(0,1) pad + b, and fp32 statistics of the pre-rounding output:
    (out (B,H/2,W/2,Cout), stats or None); kernel K9 on CUDA (bf16:
    csrc/conv_sm90.cu, which needs Cin and Cout multiples of 8 and
    16-byte-aligned bases, else ValueError; `consumers` 1 or 2 forces its
    tile, for probes; fp32: csrc/conv3x3.cu)."""
    if x.device.type == "cpu":
        return downconv_stream_plain(x, w, b, want_stats)
    _check("downconv_stream", x, w, (3, 3), b)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    if H < 2 or W < 2:
        raise ValueError(f"downconv_stream: input {tuple(x.shape)} has no "
                         "stride-2 output")
    if b is not None and (b.shape != (cout,) or b.dtype != x.dtype):
        raise ValueError(f"downconv_stream: bias {tuple(b.shape)} {b.dtype}")
    out = torch.empty((B, H // 2, W // 2, cout), dtype=x.dtype,
                      device=x.device)
    key = (tuple(x.shape), tuple(w.shape), bool(want_stats))
    if x.dtype == torch.bfloat16:
        if not downconv_tma_describable(x, w):
            raise ValueError("downconv_stream: TMA needs Cin and Cout "
                             "multiples of 8 and 16-byte-aligned bases, got "
                             f"x {tuple(x.shape)}, w {tuple(w.shape)}")
        stats = partial = None
        if want_stats:
            # one allocation: the (B, 2, Cout) sums, then the tile partials
            plan = downconv_sm90_plan(B, H, W, cin, cout, consumers)
            buf = torch.empty(2 * cout * (B + plan["m_tiles"]),
                              dtype=torch.float32, device=x.device)
            stats = buf[:2 * cout * B].view(B, 2, cout)
            partial = buf[2 * cout * B:]
        symbol = "dtp_downsample_conv3x3_stats_sm90"
        fn = _cuda.function(DOWN_SM90_SOURCE, symbol, _DOWN_SM90_ARGTYPES)
        code = fn(x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(),
                  _ptr(partial), _ptr(stats), B, H, W, cin, cout,
                  int(want_stats), consumers or 0, _cuda.stream_of(x))
        _cuda.check(DOWN_SM90_SOURCE, symbol, code)
        downconv_stream_launches.record(key)
        return out, stats
    splits = _cuda.function("conv3x3", "dtp_downsample_conv3x3_splits",
                            _SPLIT_ARGTYPES)(B, H, W, cin, cout, 0)
    partial, ws, stats = _workspaces(x, out, splits, want_stats,
                                     (H // 2) * (W // 2))
    fn = _cuda.function("conv3x3", "dtp_downsample_conv3x3_stats",
                        _UP_ARGTYPES)
    code = fn(x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(),
              _ptr(partial), _ptr(ws), _ptr(stats), B, H, W, cin, cout,
              splits, int(want_stats), 0, _cuda.stream_of(x))
    _cuda.check("conv3x3", "dtp_downsample_conv3x3_stats", code)
    downconv_stream_launches.record(key)
    return out, stats
