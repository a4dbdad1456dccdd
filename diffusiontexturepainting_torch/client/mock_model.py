"""Mock inpainter: returns the brush image as the "generated" stamp.

Port of diffusiontexturepainting_tpu/client/mock_model.py, a stand-in for
protocol and UI testing that needs no card and no torch model (`serving.run
--mock`); its replies equal the JAX mock's byte for byte.
"""

from __future__ import annotations

import numpy as np

from ..serving.model_base import (
    ConditionalInpainterBase,
    crop_resize_square,
    ensure_float01,
)


class MockConditionalInpainter(ConditionalInpainterBase):
    def __init__(self, resolution: int = 256):
        self._resolution = int(resolution)
        self.image = np.zeros((self._resolution, self._resolution, 3),
                              np.float32)

    def resolution(self) -> int:
        return self._resolution

    def set_brush(self, image: np.ndarray) -> None:
        image = ensure_float01(image)
        self.image = crop_resize_square(image, self._resolution)[
            ..., :3].astype(np.float32)

    def generate_raw(self, canvas: np.ndarray, **settings) -> np.ndarray:
        res = int(canvas.shape[0])
        if res == self._resolution:
            return self.image.copy()
        return crop_resize_square(self.image, res).astype(np.float32)
