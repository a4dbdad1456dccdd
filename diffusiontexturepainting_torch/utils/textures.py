"""Texture creation helpers.

Port of diffusiontexturepainting_tpu/utils/textures.py (numpy there and
here): the checkerboard stands in for the reference's Warp GPU kernel
(kit_app/.../util/materials.py:152-175, N11 in SURVEY.md).
"""

from __future__ import annotations

import numpy as np


def checkerboard(width: int, height: int | None = None, cell: int = 32,
                 color_a=(0.8, 0.8, 0.8), color_b=(0.5, 0.5, 0.5)) -> np.ndarray:
    """(H, W, 4) float32 RGBA checkerboard."""
    height = height or width
    yy, xx = np.meshgrid(np.arange(height) // cell, np.arange(width) // cell,
                         indexing="ij")
    parity = ((yy + xx) % 2).astype(np.float32)[..., None]
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    rgb = parity * a + (1.0 - parity) * b
    alpha = np.ones((height, width, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)


def blank(width: int, height: int | None = None,
          color=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    height = height or width
    return np.broadcast_to(np.asarray(color, np.float32),
                           (height, width, 4)).copy()
