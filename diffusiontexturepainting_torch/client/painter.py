"""Headless texture painter: the client-side painting state machine.

Port of diffusiontexturepainting_tpu/client/painter.py, the paint logic of
the reference's TexturePainterManager (kit_app/.../manager.py:77-354)
without Omniverse: per-mesh live texture, brush modes (Inpaint / Erase /
Overpaint), orthographic stamp camera oriented along the stroke, render ->
inpaint -> back-project texture updates, an undo stack, and texture baking
to npy/png.

The mesh goes to the painter's device once, at construction; the live
texture, its undo stack and each update stay tensors there, and the
rasterizations run csrc/raster.cu on a card (client/render.py). Only the
stamp canvas goes to the model, as the numpy array ConditionalInpainterBase
.generate takes, and its result comes back. `timer` (utils/profiling.py
StageTimer) keeps each stamp's render, generate, backproject and update
stages, wall ms and, on a card, device ms.
"""

from __future__ import annotations

import enum
import os
from collections import deque

import numpy as np
import torch

from ..serving.model_base import ConditionalInpainterBase
from ..training.image_io import write_png
from ..utils.async_save import to_uint8
from ..utils.profiling import StageTimer
from ..utils.textures import checkerboard
from .render import Mesh, OrthoCamera, backproject_texture, render_view


class BrushMode(enum.Enum):
    INPAINT = 0
    ERASE = 1
    OVERPAINT = 2


DEFAULT_MODEL_SETTINGS = {
    # reference manager.py:104-110 defaults
    "context_pad": 150,
    "steps": 20,
    "tg_steps": 20,
    "cfg_weight": 2.0,
    "tg_weight": 1.0,
}

OVERPAINT_MARGIN_FRAC = 37 / 256  # center-clear margin (manager.py:37-39)
STAMP_EDGE_MARGIN = 1  # px cut from the stamp mask border (manager.py:129-135)


def overpaint_canvas(canvas: np.ndarray, margin: int) -> np.ndarray:
    """Clear the center of the canvas alpha so the brush regenerates it
    (Overpaint mode, reference manager.py:243-247)."""
    out = canvas.copy()
    h, w = canvas.shape[:2]
    out[margin : h - margin, margin : w - margin, 3] = 0.0
    return out


def circle_mask(size: int, margin: int = 2) -> np.ndarray:
    """(size, size, 1) filled-circle stamp mask for Erase mode (reference
    manager.py:48-53: PIL ellipse from (margin, margin) to
    (size-margin, size-margin), white fill), pixel for pixel Pillow's
    ImageDraw.ellipse without Pillow: one quarter of the ellipse walked in
    doubled integer coordinates, each step to whichever neighbour has the
    least |a^2 y^2 + b^2 x^2 - a^2 b^2| (the first on a tie), mirrored,
    each row filled to its widest point."""
    x0 = y0 = margin
    a = b = size - 2 * margin  # the bbox's x1 - x0 and y1 - y0
    m = np.zeros((size, size), np.float32)
    if a <= 0:  # Pillow draws no point for an empty bbox
        return m[..., None]

    def err(x, y):
        return abs(a * a * y * y + b * b * x * x - a * a * b * b)

    widest = {}
    cx, cy = a, b % 2
    while True:
        for row in (cy, -cy):
            widest[row] = max(widest.get(row, -1), cx)
        if (cx, cy) == (a % 2, b) or cy > b:
            break
        steps = [(cx, cy + 2)]
        if cx > 1:
            steps += [(cx - 2, cy + 2), (cx - 2, cy)]
        cx, cy = min(steps, key=lambda p: err(*p))
    for row, cx in widest.items():
        y = y0 + (row + b) // 2
        if 0 <= y < size:
            lo, hi = x0 + (a - cx) // 2, x0 + (a + cx) // 2
            m[y, max(lo, 0):min(hi, size - 1) + 1] = 1.0
    return m[..., None]


def stamp_edge_mask(res: int, margin: int = STAMP_EDGE_MARGIN) -> np.ndarray:
    """(res, res, 1) mask that cuts a `margin`-px border off the stamp so
    bilinear edge bleed never lands in the texture (manager.py:42-45)."""
    m = np.zeros((res, res, 1), np.float32)
    m[margin : res - margin, margin : res - margin] = 1.0
    return m


class TexturePainter:
    """Holds one mesh + one live texture and paints stamps onto it."""

    def __init__(self, model: ConditionalInpainterBase, mesh: Mesh,
                 texture_width: int = 1024, texture=None,
                 flip_normals: bool = False, undo_depth: int = 10,
                 savedir: str | None = None, device="cuda"):
        self.model = model
        self.device = torch.device(device)
        self.mesh = mesh.to(self.device)
        self.texture_width = int(texture_width)
        # dynamic texture: RGBA float32; alpha tracks painted coverage
        if texture is None:
            texture = checkerboard(self.texture_width)
            texture[..., 3] = 0.0  # nothing painted yet
        self.texture = torch.as_tensor(texture, dtype=torch.float32).to(
            self.device, copy=True)
        self.flip_normals = flip_normals
        self.model_settings = dict(DEFAULT_MODEL_SETTINGS)
        self.mode = BrushMode.INPAINT
        self.undo_stack: deque[torch.Tensor] = deque(maxlen=undo_depth)
        self.savedir = savedir
        # stamp camera distance: 5% of largest bbox dim (manager.py:185-186)
        self.fov_distance = 0.05 * mesh.bbox_max_dim()
        self.timer = StageTimer(device=self.device)

    # --- camera ---

    def make_camera(self, hit: np.ndarray, normal: np.ndarray,
                    prev_point: np.ndarray | None, radius: float) -> OrthoCamera:
        """Orthographic camera at the brush tip: eye = hit + normal,
        up = previous stroke point - hit so the stamp is oriented along
        the stroke (reference manager.py:199-227)."""
        hit = np.asarray(hit, np.float32)
        normal = np.asarray(normal, np.float32)
        normal = normal / max(np.linalg.norm(normal), 1e-12)
        if prev_point is None:
            up = np.array([0.0, 1.0, 0.0], np.float32)
        else:
            up = np.asarray(prev_point, np.float32) - hit
            n = np.linalg.norm(up)
            up = up / n if n > 1e-8 else np.array([0.0, 1.0, 0.0], np.float32)
        res = self.model.resolution()
        return OrthoCamera(eye=hit + normal * self.fov_distance, at=hit,
                           up=up, half_width=float(radius),
                           height=res, width=res)

    # --- painting ---

    def begin_stroke(self):
        self.undo_stack.append(self.texture.clone())

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        self.texture = self.undo_stack.pop()
        return True

    def stamp(self, hit, normal, prev_point=None, radius: float | None = None):
        """One brush stamp: render view -> mode preprocessing -> inpaint ->
        back-project -> masked texture update (reference manager.py:232-273).
        Returns the update, a (texture_width, texture_width, 4) tensor."""
        radius = radius if radius is not None else self.fov_distance
        camera = self.make_camera(hit, normal, prev_point, radius)
        with self.timer.stage("render"):
            res = render_view(camera, self.mesh, texture=self.texture,
                              flip_normals=self.flip_normals)
            canvas = res["render"].cpu().numpy()

        with self.timer.stage("generate"):
            if self.mode == BrushMode.ERASE:
                # Erase paints all-white with a circle stamp mask; the
                # texture under the stamp is CLEARED back to unpainted
                # (reference manager.py:246-250, 267-270: texture =
                # ~update_mask * texture).
                result = np.ones_like(canvas[..., :3])
                edge = circle_mask(canvas.shape[0])
            else:
                if self.mode == BrushMode.OVERPAINT:
                    margin = max(1, int(OVERPAINT_MARGIN_FRAC
                                        * canvas.shape[0]))
                    canvas = overpaint_canvas(canvas, margin)
                result = self.model.generate(canvas, **self.model_settings)
                edge = stamp_edge_mask(canvas.shape[0])
            painted = np.concatenate([result[..., :3], edge], axis=-1)

        with self.timer.stage("backproject"):
            update = backproject_texture(self.mesh, res["proj_mesh"],
                                         res["face_idx"], painted,
                                         self.texture_width)
        with self.timer.stage("update"):
            # reference manager.py:267: replace only nonzero-alpha texels
            mask = update[..., 3:4] > 0.0
            if self.mode == BrushMode.ERASE:
                self.texture = torch.where(mask, 0.0, self.texture)
            else:
                self.texture = torch.where(mask, update.clamp(max=1.0),
                                           self.texture)
        return update

    # --- baking ---

    def bake_texture(self, path: str) -> str:
        """Save the live texture as npy + png (reference manager.py:281-301
        + util/async_save.py), the PNG through the port's own writer."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        texture = self.texture.cpu().numpy()
        np.save(path + ".npy", texture)
        write_png(path + ".png", to_uint8(texture))
        return path + ".png"
