"""Brush history: most-recent-first dedup queue of brush images.

Analog of the reference's BrushHistoryQueue (kit_app/.../ui/util.py:147-158);
a copy of diffusiontexturepainting_tpu/client/history.py.
"""

from __future__ import annotations

import hashlib

import numpy as np


class BrushHistoryQueue:
    def __init__(self, maxlen: int = 10):
        self.maxlen = maxlen
        self._items: list[tuple[str, np.ndarray]] = []

    @staticmethod
    def _key(image: np.ndarray) -> str:
        return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()

    def push(self, image: np.ndarray):
        key = self._key(image)
        self._items = [(k, v) for k, v in self._items if k != key]
        self._items.insert(0, (key, np.array(image, copy=True)))
        del self._items[self.maxlen:]

    def items(self):
        return [v for _, v in self._items]

    def __len__(self):
        return len(self._items)
