"""Chained GroupNorm -> SiLU -> 3x3 conv with residual and statistics
epilogues, and the x2-upsample conv with statistics, NHWC.

Port of diffusiontexturepainting_tpu/ops/gn_conv_stream.py (and of
ops/conv3x3.py gn_conv_resident, which computes the same function). Each
conv emits the fp32 (sum, sumsq) per (batch, channel) of its output, so the
next GroupNorm folds into a per-(B, C) affine (gn_affine_from_stats) with no
pass of its own over the tensor:

    h1, s1 = gn_conv(x,  affine(s_x), conv1)          # GN1 + SiLU + conv1
    y,  sy = gn_conv(h1, affine(s1),  conv2, res=x')  # GN2 + SiLU + conv2

Kernels (csrc/conv3x3.cu, the conv family's fused modes); a wrapper takes
the plain version only for a tensor on the CPU, and for a CUDA tensor it
launches the kernel or raises:

  gn_conv_resident  kernel K1 (replaces conv3x3.py _gn_conv_resident_pallas /
                    _gn_res_kernel), the UNet's resnets
  gn_conv_stream    kernel K5 (replaces gn_conv_stream.py
                    _stream_fused_pallas / _kernel), the VAE's resnets and
                    heads; the same CUDA mode as K1, counted apart
  upconv_stream     kernel K6 (replaces gn_conv_stream.py
                    _upconv_stream_pallas / _upconv_stream_kernel)

Statistics are (B, 2, C) fp32: row 0 the sum, row 1 the sum of squares over
the spatial axes (the TPU's 8-row padding is a sublane minimum and is not
kept).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda
from .conv3x3 import _KERNEL_DTYPES, _SPLIT_ARGTYPES, conv3x3_plain

gn_conv_resident_launches = _cuda.LaunchCounter("gn_conv_resident")
gn_conv_stream_launches = _cuda.LaunchCounter("gn_conv_stream")
upconv_stream_launches = _cuda.LaunchCounter("upconv_stream")

_GN_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 9
                + (ctypes.c_void_p,))
_UP_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8
                + (ctypes.c_void_p,))


# --- GroupNorm statistics algebra (fp32) ---


def group_matrix(channels: int, num_groups: int, device=None):
    """(C, G) one-hot channel -> group matrix, fp32."""
    return torch.repeat_interleave(
        torch.eye(num_groups, device=device), channels // num_groups, dim=0)


def gn_affine_from_stats(stats, scale, bias, num_groups: int,
                         n_spatial: int, eps: float = 1e-5):
    """Fold chained (sum, sumsq) statistics (B, 2, C) and the GroupNorm's
    scale/bias into per-(B, C) fp32 a, c with GN(x)*scale + bias ==
    x*a + c. n_spatial: the spatial elements the statistics summed over."""
    c = stats.shape[-1]
    gmat = group_matrix(c, num_groups, stats.device)
    n = n_spatial * (c // num_groups)
    mean_g = stats[:, 0, :] @ gmat / n
    var_g = stats[:, 1, :] @ gmat / n - mean_g.square()
    inv_g = torch.rsqrt(var_g + eps)
    a = (inv_g @ gmat.t()) * scale.float()[None]
    return a, bias.float()[None] - (mean_g @ gmat.t()) * a


def stats_of(x):
    """(B, 2, C) fp32 (sum, sumsq) over the spatial axes of an NHWC tensor,
    for a layer input that did not come from a conv's epilogue."""
    xf = x.float()
    dims = tuple(range(1, x.dim() - 1))
    return torch.stack([xf.sum(dims), xf.square().sum(dims)], dim=1)


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
    return y, (stats_of(y) if want_stats else None)


def upconv_stream_plain(x, w, b, want_stats=True):
    """Nearest x2 + 3x3 conv + b, with fp32 statistics of the output before
    its rounding to x's dtype (port of _upconv_stream_reference; in bf16
    the conv rounds before the bias add, one rounding more than the
    kernel)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = F.conv2d(up.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).float()
    if b is not None:
        y = y + b.float()
    stats = stats_of(y) if want_stats else None
    return y.to(x.dtype).contiguous(), stats


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


def gn_conv3x3(x, a, c, w, b, residual=None, want_stats=True,
               apply_gn=True, counter=None):
    """The fused conv (K1/K5's function): returns (out, stats or None).
    x (B,H,W,Cin); a, c (B,Cin) fp32 folded GroupNorm affine (unused when
    apply_gn is False); w (3,3,Cin,Cout); b (Cout,) or None; residual
    (B,H,W,Cout) or None. w may be a slice w_full[:, :, lo:hi] of a wider
    weight (the split concat conv); the kernel reads it in place. On CUDA
    the launch is added to `counter`."""
    if x.device.type == "cpu":
        return gn_conv3x3_plain(x, a, c, w, b, residual, want_stats,
                                apply_gn)
    dt = x.dtype
    if apply_gn:
        a = a.to(dt).contiguous()
        c = c.to(dt).contiguous()
    else:
        a = c = None
    _check("gn_conv3x3", x, w, (3, 3), a, c, b, residual, w_view=True)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((B, H, W, cout), dtype=dt, device=x.device)
    if residual is not None and residual.shape != out.shape:
        raise ValueError(f"gn_conv3x3: residual {tuple(residual.shape)} is "
                         f"not the output's {tuple(out.shape)}")
    for t, shape in ((a, (B, cin)), (c, (B, cin)), (b, (cout,))):
        if t is not None and (t.shape != shape or t.dtype != dt):
            raise ValueError(f"gn_conv3x3: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if residual is not None and residual.dtype != dt:
        raise TypeError(f"gn_conv3x3: residual must be {dt}")
    bf16 = int(dt == torch.bfloat16)
    splits = _cuda.function("conv3x3", "dtp_conv3x3_splits",
                            _SPLIT_ARGTYPES)(B, H, W, cin, cout, bf16)
    partial, ws, stats = _workspaces(x, out, splits, want_stats, H * W)
    fn = _cuda.function("conv3x3", "dtp_gn_conv3x3", _GN_ARGTYPES)
    code = fn(x.data_ptr(), _ptr(a), _ptr(c), w.data_ptr(), _ptr(b),
              _ptr(residual), out.data_ptr(), _ptr(partial), _ptr(ws),
              _ptr(stats), B, H, W, cin, cout, w.stride(1), splits,
              int(want_stats), bf16,
              _cuda.stream_of(x))
    _cuda.check("conv3x3", "dtp_gn_conv3x3", code)
    if counter is not None:
        counter.record(_shape_key(x, w, b, residual, want_stats, apply_gn))
    return out, stats


def _shape_key(x, w, b, residual, want_stats, apply_gn):
    return (tuple(x.shape), tuple(w.shape), b is not None,
            residual is not None, bool(want_stats), bool(apply_gn))


def gn_conv_resident(x, a, c, w, b, residual=None, want_stats=True,
                     apply_gn=True):
    """The UNet resnets' fused conv (kernel K1 on CUDA)."""
    return gn_conv3x3(x, a, c, w, b, residual, want_stats, apply_gn,
                      counter=gn_conv_resident_launches)


def gn_conv_stream(x, a, c, w, b, residual=None, want_stats=True,
                   apply_gn=True):
    """The VAE's fused conv (kernel K5 on CUDA; the same mode as K1)."""
    return gn_conv3x3(x, a, c, w, b, residual, want_stats, apply_gn,
                      counter=gn_conv_stream_launches)


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
