"""Brush stroke logic: stamp interpolation along mouse movement.

Port of diffusiontexturepainting_tpu/client/brush.py (numpy there and
here). Re-implements the reference AITextureBrush's stroke sampling
(kit_app/.../ui/brush.py:139-198): as the cursor moves, emit interpolated
stamps whenever accumulated world distance exceeds
radius / stamps_per_radius, each stamp oriented by the previous stroke
point. Headless version: feed it hit points + normals, it drives a
TexturePainter.
"""

from __future__ import annotations

import numpy as np

from .painter import BrushMode, TexturePainter


class BrushStroke:
    """One stroke session over a TexturePainter."""

    def __init__(self, painter: TexturePainter, radius: float | None = None,
                 stamps_per_radius: int = 1):
        # reference: stamps_per_radius=1 normally, 3 for erase
        # (extension.py:168-175); default radius = 5% of bbox
        # (ui/brush.py:92-104)
        self.painter = painter
        self.radius = radius if radius is not None else painter.fov_distance
        if painter.mode == BrushMode.ERASE and stamps_per_radius == 1:
            stamps_per_radius = 3
        self.step_dist = self.radius / stamps_per_radius
        self.prev_point: np.ndarray | None = None
        self.started = False

    def begin(self, hit, normal):
        """Start a stroke: push undo state and place the first stamp."""
        self.painter.begin_stroke()
        self.started = True
        hit = np.asarray(hit, np.float32)
        self.painter.stamp(hit, normal, prev_point=None, radius=self.radius)
        self.prev_point = hit
        return 1

    def move(self, hit, normal) -> int:
        """Cursor moved to `hit`; emit interpolated stamps along the
        segment whenever the accumulated distance passes step_dist.
        Returns the number of stamps emitted."""
        if not self.started:
            return self.begin(hit, normal)
        hit = np.asarray(hit, np.float32)
        start = self.prev_point
        seg = hit - start
        dist = float(np.linalg.norm(seg))
        n_stamps = int(dist / self.step_dist)
        emitted = 0
        for i in range(1, n_stamps + 1):
            # interpolate along the ORIGINAL segment: i*step from its
            # start (stamps must be evenly spaced; stepping from the
            # moving prev_point would space them 1,3,6,... steps apart)
            point = start + seg * (i * self.step_dist / dist)
            self.painter.stamp(point, normal, prev_point=self.prev_point,
                               radius=self.radius)
            self.prev_point = point
            emitted += 1
        return emitted

    def end(self):
        self.started = False
        self.prev_point = None
