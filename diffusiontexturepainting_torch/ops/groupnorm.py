"""GroupNorm statistics: the spatial moments of an NHWC tensor.

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
    if x.device.type != "cuda":
        raise ValueError(f"spatial_moments: tensors must be on CPU or CUDA, "
                         f"got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"spatial_moments: fp32, bf16 or fp16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"spatial_moments: a non-empty contiguous NHWC "
                         f"tensor, got {tuple(x.shape)} strides "
                         f"{x.stride()}")
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
    spatial_moments_launches.record((tuple(x.shape),))
    return stats
