"""GroupNorm statistics: the spatial moments of an NHWC tensor, and their
fold with a GroupNorm's scale and bias into a per-(B, C) affine.

Port of diffusiontexturepainting_tpu/ops/groupnorm.py spatial_moments:
(B, H, W, C) -> fp32 (sum, sum of squares) over the spatial axes, here one
(B, 2, C) tensor (row 0 the sum, row 1 the sum of squares), the statistics
layout of ops/gn_conv.py. The fused serving legs take it through
gn_conv.stats_of for every GroupNorm whose input no conv epilogue produced
(the UNet's resnet inputs and skips, the VAE's stem and mid blocks).

Kernel (csrc/moments.cu): spatial_moments is kernel K14 (replaces
groupnorm.py _stats_pallas / _stats_kernel): a band pass and a reduction
pass that adds the row bands in a fixed order, planned by shape
(moments_plan, the source's plan mirrored); one ctypes call and one
allocation a call. The wrapper takes the plain version only for a tensor
on the CPU, and for a CUDA tensor it launches the kernel or raises. The
JAX package left its kernel unwired because it broke XLA's fusion of the
GroupNorm apply with the reduce; here the apply already lives in the fused
convs' prologue, so nothing is lost.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda

spatial_moments_launches = _cuda.LaunchCounter("spatial_moments")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

# csrc/moments.cu's plan constants (H100: 132 SMs)
MOMENT_THREADS, SM_COUNT = 256, 132


@functools.lru_cache(maxsize=None)
def moments_plan(B: int, N: int, C: int, itemsize: int, vec: bool) -> dict:
    """K14's plan for x (B, N, C) of `itemsize`-byte elements, its rows read
    in 16-byte groups when `vec`: a band pass of up to 256 groups a block,
    as many bands as give about eight blocks an SM but at least 4 rows a
    row lane, then a reduction pass over `partial_floats` band partials.
    Cached: the dict is shared, read it only."""
    V = 16 // itemsize if vec else 1
    G = -(-C // V)
    gpb = min(G, MOMENT_THREADS)
    slices = -(-G // gpb)
    lanes = MOMENT_THREADS // gpb
    bands = -(-8 * SM_COUNT // (B * slices))
    bands = max(1, min(bands, N // (4 * lanes)))
    return dict(bands=bands, gpb=gpb, slices=slices,
                partial_floats=B * bands * 2 * C)


def spatial_moments_plain(x):
    """(B, 2, C) fp32 (sum, sumsq) over the middle axes of (B, ..., C)."""
    xf = x.float()
    dims = tuple(range(1, x.dim() - 1))
    return torch.stack([xf.sum(dims), xf.square().sum(dims)], dim=1)


def spatial_moments(x):
    """(B, H, W, C) of fp32, bf16 or fp16 -> (B, 2, C) fp32 (sum, sumsq)
    over H and W; kernel K14 on CUDA."""
    if x.device.type == "cpu":
        return spatial_moments_plain(x)
    stats = launch_moments("spatial_moments", x)
    spatial_moments_launches.record((tuple(x.shape),), x.dtype)
    return stats


def launch_moments(name, x):
    """K14's two launches over a CUDA tensor, uncounted: spatial_moments
    counts them, and ops/conv3x3.py gn_silu_conv3x3 runs them as the first
    half of its own kernel K10."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: fp32, bf16 or fp16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: a non-empty contiguous NHWC tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    item = x.element_size()
    vec = C % (16 // item) == 0 and x.data_ptr() % 16 == 0
    extra = moments_plan(B, H * W, C, item, vec)["partial_floats"]
    # one allocation: the (B, 2, C) statistics, then the band partials
    buf = torch.empty(2 * B * C + extra, dtype=torch.float32, device=x.device)
    stats, partial = buf[:2 * B * C].view(B, 2, C), buf[2 * B * C:]
    code = _cuda.function("moments", "dtp_spatial_moments", _ARGTYPES)(
        x.data_ptr(), partial.data_ptr(), stats.data_ptr(), B, H * W, C,
        _DTYPE_CODES[x.dtype], _cuda.stream_of(x))
    _cuda.check("moments", "dtp_spatial_moments", code)
    return stats


@functools.cache
def group_matrix(channels: int, num_groups: int, device=None):
    """(C, G) one-hot channel -> group matrix, fp32: a constant, built once
    per (C, G, device), so a GroupNorm fold issues no operation for it."""
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.repeat_interleave(
            torch.eye(num_groups, device=device), channels // num_groups,
            dim=0)


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


def gn_fold_per_channel(stats, scale, bias, num_groups: int, n_spatial: int,
                        eps: float = 1e-5):
    """gn_affine_from_stats's a, c (B, C) in fp32 as bf16 K10 folds them in
    its CTA (csrc/gn_conv_sm90.cu; conv_staged.cu's fp32 twin alike), the
    port's mirror of that arithmetic: per group of C/G channels, S1 and S2
    summed channel by channel in order, n = n_spatial * C/G, mean = S1/n,
    inv = rsqrt(S2/n - mean^2 + eps); then per channel a = inv * scale[c],
    c = bias[c] - mean * a. A group may cross the kernel's 8-channel loads
    and 64-channel chunks: each channel takes its own group's."""
    B, _, C = stats.shape
    cpg = C // num_groups
    st = stats.float().reshape(B, 2, num_groups, cpg)
    s1 = s2 = st.new_zeros((B, num_groups))
    for j in range(cpg):
        s1 = s1 + st[:, 0, :, j]
        s2 = s2 + st[:, 1, :, j]
    n = float(n_spatial * cpg)
    mean = s1 / n
    inv = torch.rsqrt(s2 / n - mean * mean + eps)
    a = inv.repeat_interleave(cpg, dim=1) * scale.float()[None]
    return a, bias.float()[None] - mean.repeat_interleave(cpg, dim=1) * a
