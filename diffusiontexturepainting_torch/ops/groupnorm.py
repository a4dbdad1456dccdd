"""GroupNorm statistics: the spatial moments of an NHWC tensor, and their
fold with a GroupNorm's scale and bias into a per-(B, C) affine.

Port of diffusiontexturepainting_tpu/ops/groupnorm.py spatial_moments:
(B, H, W, C) -> fp32 (sum, sum of squares) over the spatial axes, here one
(B, 2, C) tensor (row 0 the sum, row 1 the sum of squares), the statistics
layout of ops/gn_conv.py. The fused serving legs take it through
gn_conv.stats_of for every GroupNorm whose input no conv epilogue produced
(the UNet's resnet inputs and skips, the VAE's stem and mid blocks).

Kernel (csrc/moments.cu): spatial_moments is kernel K14 (replaces
groupnorm.py _stats_pallas / _stats_kernel), row bands reduced in a fixed
order; the wrapper takes the plain version only for a tensor on the CPU,
and for a CUDA tensor it launches the kernel or raises. The JAX package
left its kernel unwired because it broke XLA's fusion of the GroupNorm
apply with the reduce; here the apply already lives in the fused convs'
prologue, so nothing is lost.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda

spatial_moments_launches = _cuda.LaunchCounter("spatial_moments")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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
    spatial_moments_launches.record((tuple(x.shape),))
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
    bands = _cuda.function("moments", "dtp_moments_bands",
                           (ctypes.c_int,) * 4)(B, H * W, C, x.element_size())
    partial = torch.empty(B * bands * 2 * C, dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    code = _cuda.function("moments", "dtp_spatial_moments", _ARGTYPES)(
        x.data_ptr(), partial.data_ptr(), stats.data_ptr(), B, H * W, C,
        bands, _DTYPE_CODES[x.dtype], _cuda.stream_of(x))
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
