"""Image resizes with torch F.interpolate conventions, as two small matmuls.

Port of diffusiontexturepainting_tpu/ops/resize.py. The separable weight
matrices are the same float64 numpy construction, so bicubic align-corners
edges (the brush preprocess) match the JAX package exactly; the resize
itself is out = W_h @ img @ W_w^T.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import device_constant


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch uses a=-0.75)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0),
    )


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, mode: str,
                   align_corners: bool) -> np.ndarray:
    """(out_size, in_size) float32 interpolation matrix (read-only)."""
    if in_size == out_size:
        w = np.eye(out_size, dtype=np.float32)
        w.flags.writeable = False
        return w
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) \
            / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5

    w = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "bilinear":
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        for o in range(out_size):
            lo = int(np.clip(i0[o], 0, in_size - 1))
            hi = int(np.clip(i0[o] + 1, 0, in_size - 1))
            w[o, lo] += 1.0 - frac[o]
            w[o, hi] += frac[o]
    elif mode == "bicubic":
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        for o in range(out_size):
            for tap in range(-1, 3):
                wt = _cubic_kernel(np.array(tap - frac[o]))
                idx = int(np.clip(i0[o] + tap, 0, in_size - 1))
                w[o, idx] += float(wt)
    elif mode == "nearest":
        idx = np.floor(np.arange(out_size) * (in_size / out_size)) \
            .astype(np.int64)
        idx = np.clip(idx, 0, in_size - 1)
        w[np.arange(out_size), idx] = 1.0
    else:
        raise ValueError(f"unknown mode {mode}")
    w = w.astype(np.float32)
    w.flags.writeable = False
    return w


def resize2d(img, out_h: int, out_w: int, mode: str = "bilinear",
             align_corners: bool = False):
    """Resize (..., H, W, C) images via separable weight matmuls, with
    torch F.interpolate semantics ("nearest": floor index mapping;
    "bilinear"/"bicubic" with align_corners True or False)."""
    h, w = img.shape[-3], img.shape[-2]
    if mode == "nearest":
        align_corners = False
    wh = device_constant(_resize_matrix(h, out_h, mode, align_corners),
                         img.device, img.dtype)
    ww = device_constant(_resize_matrix(w, out_w, mode, align_corners),
                         img.device, img.dtype)
    out = torch.einsum("oh,...hwc->...owc", wh, img)
    return torch.einsum("pw,...owc->...opc", ww, out)


def nearest_downsample(img, factor: int):
    """Exact x1/factor nearest downsample of (..., H, W, C): strided slice."""
    return img[..., ::factor, ::factor, :]
