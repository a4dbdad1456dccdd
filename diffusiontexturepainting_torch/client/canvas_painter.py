"""2D canvas stroke painter: UV-space painting over a stroke session.

Port of diffusiontexturepainting_tpu/client/canvas_painter.py; its bake
saves through the port's utils/async_save.py (no Pillow). The 2D sibling of client/painter.py TexturePainter (which paints 3D mesh
textures through render/backproject): here the canvas IS the texture, so
the whole stroke can run on the server's device-resident session
(pipeline/session.py) - stamps are fired as 22-byte STAMP_AT requests
(fire-and-forget against a websocket model) and the canvas is fetched
once per synchronization point instead of round-tripping every stamp.

Stroke sampling mirrors the reference AITextureBrush
(kit_app/.../ui/brush.py:139-198, headless twin client/brush.py): stamps
are emitted whenever accumulated cursor distance exceeds
radius / stamps_per_radius (x3 for Erase, extension.py:168-175). Brush
modes and undo depth match TexturePainterManager (manager.py:77-354).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..serving.model_base import ConditionalInpainterBase
from .painter import DEFAULT_MODEL_SETTINGS, BrushMode

_UNDO_DEPTH = 10  # reference manager undo stack depth


class CanvasStrokePainter:
    """Paints brush strokes onto a (H, W, 4) uint8 RGBA canvas held in a
    model stroke session (device-resident for GPU/websocket models)."""

    def __init__(self, model: ConditionalInpainterBase,
                 canvas: np.ndarray | None = None,
                 width: int = 1024, height: int | None = None,
                 undo_depth: int = _UNDO_DEPTH,
                 stamps_per_radius: int = 1):
        self.model = model
        if canvas is None:
            canvas = np.zeros((height or width, width, 4), np.uint8)
        canvas = np.asarray(canvas)
        if canvas.dtype != np.uint8:
            canvas = (np.clip(canvas, 0.0, 1.0) * 255).astype(np.uint8)
        self.model.begin_session(canvas)
        self.mode = BrushMode.INPAINT
        self.model_settings = dict(DEFAULT_MODEL_SETTINGS)
        self.stamps_per_radius = int(stamps_per_radius)
        self.undo_stack: deque[np.ndarray] = deque(maxlen=undo_depth)
        self._prev: np.ndarray | None = None
        self._in_stroke = False
        # Last synchronized canvas state. This painter is the session's
        # only writer, so as long as no stamp fired since the last sync
        # the cached copy IS the server canvas - begin_stroke's undo
        # snapshot then needs no fetch (a full canvas download + round
        # trip per stroke otherwise).
        self._synced: np.ndarray = canvas.copy()
        self._dirty = False
        # websocket models take wait=False (fire-and-forget streaming);
        # in-process models dispatch asynchronously anyway
        import inspect

        self._supports_wait = (
            "wait" in inspect.signature(model.stamp_at).parameters)

    # --- geometry: stamps are addressed by CENTER in canvas pixels -------

    @property
    def radius(self) -> float:
        return self.model.resolution() / 2.0

    def _corner(self, x: float, y: float) -> tuple[int, int]:
        res = self.model.resolution()
        return int(round(x)) - res // 2, int(round(y)) - res // 2

    def _step_dist(self) -> float:
        per_radius = self.stamps_per_radius
        if self.mode == BrushMode.ERASE and per_radius == 1:
            per_radius = 3  # reference extension.py:168-175
        return self.radius / per_radius

    # --- stroke lifecycle -------------------------------------------------

    def begin_stroke(self, x: float, y: float) -> int:
        """Push undo state (from the cached sync when clean, one fetch
        otherwise) and place the first stamp at center (x, y)."""
        self.undo_stack.append(self._snapshot())
        self._in_stroke = True
        self._stamp(x, y)
        self._prev = np.array([x, y], np.float32)
        return 1

    def _snapshot(self) -> np.ndarray:
        if self._dirty:
            self._synced = self.model.fetch_canvas()
            self._dirty = False
        return self._synced.copy()

    def move(self, x: float, y: float) -> int:
        """Cursor moved; emit interpolated stamps along the segment every
        step_dist pixels. Returns the number of stamps emitted."""
        if not self._in_stroke:
            return self.begin_stroke(x, y)
        cur = np.array([x, y], np.float32)
        start = self._prev
        seg = cur - start
        dist = float(np.linalg.norm(seg))
        step = self._step_dist()
        n_stamps = int(dist / step)
        for i in range(1, n_stamps + 1):
            point = start + seg * (i * step / dist)
            self._stamp(float(point[0]), float(point[1]))
            self._prev = point
        return n_stamps

    def end_stroke(self) -> None:
        self._in_stroke = False
        self._prev = None

    def _stamp(self, x: float, y: float) -> None:
        x0, y0 = self._corner(x, y)
        if self.mode == BrushMode.ERASE:
            self._fire(self.model.erase_at, x0, y0)
        else:
            self._fire(self.model.stamp_at, x0, y0,
                       overpaint=(self.mode == BrushMode.OVERPAINT),
                       **self.model_settings)

    def _fire(self, fn, x0, y0, **kw):
        if self._supports_wait:
            kw["wait"] = False
        fn(x0, y0, return_pixels=False, **kw)
        self._dirty = True

    # --- canvas access ----------------------------------------------------

    @property
    def texture(self) -> np.ndarray:
        """The current canvas (synchronizes all in-flight stamps)."""
        self._synced = self.model.fetch_canvas()
        self._dirty = False
        return self._synced.copy()

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        restored = self.undo_stack.pop()
        self.model.begin_session(restored)
        self._synced = restored.copy()
        self._dirty = False
        return True

    def bake(self, path: str):
        """Save the canvas as npy + png without blocking the stroke loop
        (manager.py:281-301 + util/async_save.py analog). Returns the two
        futures."""
        import os

        from ..utils.async_save import save_npy_async, save_png_async

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        texture = self.texture
        return [save_npy_async(path + ".npy", texture),
                save_png_async(path + ".png", texture)]

    def close(self) -> None:
        self.model.end_session()
