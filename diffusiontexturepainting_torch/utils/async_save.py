"""Thread-executor texture saves (npy/png) so painting never blocks on
disk I/O - the analog of kit_app/.../util/async_save.py:20-46.

Port of diffusiontexturepainting_tpu/utils/async_save.py; the PNG goes
through the port's own writer (training/image_io.py write_png), since the
card's machine has no Pillow.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from ..training.image_io import write_png

_EXECUTOR = concurrent.futures.ThreadPoolExecutor(max_workers=2,
                                                  thread_name_prefix="dtp-save")


def save_npy_async(path: str, array: np.ndarray):
    arr = np.array(array, copy=True)

    def _save():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, arr)
        return path

    return _EXECUTOR.submit(_save)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 as the JAX package saves it (clip, * 255,
    truncate); uint8 unchanged."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_png_async(path: str, image: np.ndarray):
    """image: float [0,1] or uint8, HWC (3 or 4 channels)."""
    img = np.array(image, copy=True)

    def _save():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_png(path, to_uint8(img))
        return path

    return _EXECUTOR.submit(_save)


def wait_all(futures):
    return [f.result() for f in futures]
