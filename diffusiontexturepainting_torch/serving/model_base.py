"""The serving model contract and its host-side image helpers.

The same class and functions as the JAX package's serving/model_base.py
(tests hold them equal on the same inputs): numpy HWC images, uint8 or
float in [0, 1]. ConditionalInpainterBase gives a model that implements
resolution / set_brush / generate_raw the host composite, the brush
preview's canvas and stroke sessions on a host canvas (the mock,
client/mock_model.py, serves through it); TorchConditionalInpainter keeps
its canvas on the device instead.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod

import numpy as np


class ConditionalInpainterBase(ABC):
    """Contract every inpainter (torch, mock) implements."""

    @abstractmethod
    def resolution(self) -> int:
        """Internal canvas resolution of the model (square)."""

    @abstractmethod
    def set_brush(self, image: np.ndarray) -> None:
        """The brush: (H, W, 3) uint8 or float32 [0, 1] texture image."""

    @abstractmethod
    def generate_raw(self, canvas: np.ndarray, **settings) -> np.ndarray:
        """(H, W, 4) float32 [0, 1] canvas (A = painted) -> (H, W, 3)
        float32 [0, 1] new content, known areas possibly repainted."""

    def generate(self, canvas: np.ndarray, **settings) -> np.ndarray:
        """generate_raw composited over the canvas: canvas_rgb * alpha +
        result * (1 - alpha)."""
        result = self.generate_raw(canvas, **settings)
        alpha = canvas[..., 3:4].astype(np.float32)
        return (canvas[..., :3].astype(np.float32) * alpha
                + result[..., :3] * (1.0 - alpha))

    def create_preview_brush_context(self, brush_image: np.ndarray):
        """The brush preview's canvas: the brush known in the top-left
        quadrant."""
        return preview_brush_context(brush_image, self.resolution())

    # --- stroke sessions on a host canvas (pipeline/session.py documents
    # the protocol): each STAMP_AT crops a res^2 window, inpaints it
    # through `generate` and writes the composite and alpha 255 back
    # inside the stamp edge mask

    def begin_session(self, canvas_u8: np.ndarray) -> None:
        canvas_u8 = validate_session_canvas(canvas_u8, self.resolution())
        self._session_canvas = canvas_u8.copy()

    def session_active(self) -> bool:
        return getattr(self, "_session_canvas", None) is not None

    def stamp_at(self, x0: int, y0: int, return_pixels: bool = True,
                 overpaint: bool = False, **settings):
        """One stamp into the canvas with its window at (x0, y0), clamped
        to fit; the composited res^2 crop as uint8 RGB when
        return_pixels, else None."""
        from ..pipeline.session import overpaint_margin, STAMP_EDGE_MARGIN

        canvas = self._require_session()
        res = self.resolution()
        y0 = int(np.clip(y0, 0, canvas.shape[0] - res))
        x0 = int(np.clip(x0, 0, canvas.shape[1] - res))
        crop = ensure_float01(canvas[y0:y0 + res, x0:x0 + res])
        if overpaint:
            m = overpaint_margin(res)
            crop[m:res - m, m:res - m, 3] = 0.0
            crop[..., :3] *= crop[..., 3:4]
        comp_u8 = float01_to_uint8(self.generate(crop, **settings))
        m = STAMP_EDGE_MARGIN
        window = canvas[y0:y0 + res, x0:x0 + res]
        window[m:res - m, m:res - m, :3] = comp_u8[m:res - m, m:res - m]
        window[m:res - m, m:res - m, 3] = 255
        return comp_u8 if return_pixels else None

    def erase_at(self, x0: int, y0: int, return_pixels: bool = True):
        """Zero RGBA under the erase circle of the window at (x0, y0)."""
        from ..pipeline.session import circle_mask

        canvas = self._require_session()
        res = self.resolution()
        y0 = int(np.clip(y0, 0, canvas.shape[0] - res))
        x0 = int(np.clip(x0, 0, canvas.shape[1] - res))
        window = canvas[y0:y0 + res, x0:x0 + res]
        window[circle_mask(res)] = 0
        return window[..., :3].copy() if return_pixels else None

    def fetch_canvas(self) -> np.ndarray:
        return self._require_session().copy()

    def sync_session(self) -> None:
        """Stamps are synchronous here: nothing to wait for."""
        self._require_session()

    def end_session(self) -> None:
        self._session_canvas = None

    def _require_session(self) -> np.ndarray:
        canvas = getattr(self, "_session_canvas", None)
        if canvas is None:
            raise RuntimeError("no active stroke session (BEGIN_SESSION "
                               "first)")
        return canvas


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
