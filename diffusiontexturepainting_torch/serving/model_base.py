"""Host-side image helpers of the serving model contract.

The same functions as the JAX package's serving/model_base.py (tests hold
them equal on the same inputs): numpy HWC images, uint8 or float in [0, 1].
"""

from __future__ import annotations

import hashlib

import numpy as np


def ensure_float01(image: np.ndarray) -> np.ndarray:
    """uint8 [0,255] or float [0,1] -> float32 [0,1]."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


def float01_to_uint8(image: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, truncating (as `(img * 255).to(uint8)`)."""
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)


def preview_brush_context(brush_image: np.ndarray, res: int) -> np.ndarray:
    """(res, res, 4) float32 canvas whose top-left quadrant is the brush,
    known (alpha 1); the rest is empty. The brush preview's input."""
    canvas = np.zeros((res, res, 4), dtype=np.float32)
    center = res // 2
    canvas[..., :3] = np.asarray(brush_image, np.float32)[:res, :res, :3]
    canvas[:center, :center, 3] = 1.0
    canvas[..., :3] *= canvas[..., 3:4]
    return canvas


def crop_resize_square(image: np.ndarray, width: int) -> np.ndarray:
    """Center-crop to a square, then resize to `width` (bilinear, half-pixel
    centers); uint8 stays uint8."""
    h, w = image.shape[:2]
    side = min(h, w)
    if width is None or width <= 0:
        width = side
    top, left = (h - side) // 2, (w - side) // 2
    image = image[top:top + side, left:left + side]
    if side == width:
        return image
    img = ensure_float01(image)
    pos = (np.arange(width) + 0.5) * (side / width) - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, side - 1)
    i1 = np.clip(i0 + 1, 0, side - 1)
    frac = np.clip(pos - i0, 0.0, 1.0)
    wy, wx = frac[:, None, None], frac[None, :, None]
    top_row = img[i0][:, i0] * (1 - wx) + img[i0][:, i1] * wx
    bottom_row = img[i1][:, i0] * (1 - wx) + img[i1][:, i1] * wx
    out = top_row * (1 - wy) + bottom_row * wy
    if image.dtype == np.uint8:
        return float01_to_uint8(out)
    return out.astype(image.dtype)


def procedural_brush(prompt: str, size: int = 256) -> np.ndarray:
    """A prompt's brush: (size, size, 3) uint8 colored noise over 8-pixel
    blocks, seeded by the prompt's sha256 (not hash(), which is salted per
    process), so the same prompt gives the same brush in every run. The
    JAX package's client/nvcf_txt2img.py procedural_brush."""
    seed = int.from_bytes(
        hashlib.sha256(prompt.encode("utf-8")).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    base = rng.random((size // 8, size // 8, 3))
    img = np.kron(base, np.ones((8, 8, 1)))
    img += 0.15 * rng.standard_normal((size, size, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def validate_session_canvas(canvas_u8: np.ndarray, res: int) -> np.ndarray:
    """A stroke session's canvas: (H, W, 4) uint8 RGBA, at least res^2."""
    canvas_u8 = np.asarray(canvas_u8)
    if canvas_u8.dtype != np.uint8 or canvas_u8.ndim != 3 \
            or canvas_u8.shape[2] != 4:
        raise ValueError("session canvas must be (H, W, 4) uint8 RGBA")
    if canvas_u8.shape[0] < res or canvas_u8.shape[1] < res:
        raise ValueError(
            f"session canvas {canvas_u8.shape[:2]} smaller than the "
            f"stamp window {res}x{res}")
    return canvas_u8
