"""Stroke sessions: the painting canvas stays on the device.

Port of diffusiontexturepainting_tpu/pipeline/session.py. A session keeps
the whole (H, W, 4) uint8 RGBA canvas on the device, and each stamp is a
small request, two coordinates and the settings:

    STAMP_AT(x0, y0)  ->  crop the res^2 window at the clamped corner (a
                          copy, as JAX's dynamic_slice)
                      ->  [overpaint: clear the crop's centre, RGB and
                           alpha, `margin` px in from each side]
                      ->  the inpaint stamp (inpaint.make_stamp_fn)
                      ->  write the composited RGB and alpha 255 into the
                          window, inside the 1-px stamp edge mask
    ERASE_AT(x0, y0)  ->  zero RGBA under a filled circle in the window

The canvas is updated in place (the JAX package donates its buffer). The
window's position is a host value, so the crop and the write-back run
eagerly on the device around the stamp; the serving model's stamp is its
engine's program (core/engine.py), which copies the crop into its canvas
buffer on the device and replays its CUDA graph. All of it is enqueued on
the canvas's stream, so consecutive stamps chain on the device in request
order and nothing returns to the host until the caller downloads; the JAX
package's lax.scan stroke programs and flush buckets answer dispatch and
round-trip costs that one replay a stamp does not have. Coordinates are
host integers, clamped on the host, so no step reads a device value back.

Constants follow the painting client (client/painter.py of the JAX
package): STAMP_EDGE_MARGIN, the overpaint margin 37/256 of the stamp, and
the erase circle, Pillow's filled ellipse from (2, 2) to (size-2, size-2),
computed here bit for bit without Pillow (circle_mask).
"""

from __future__ import annotations

import functools

import numpy as np

STAMP_EDGE_MARGIN = 1
ERASE_CIRCLE_MARGIN = 2


def overpaint_margin(res: int) -> int:
    """The overpaint centre-clear margin of a res^2 stamp."""
    return max(1, round(37 / 256 * res))


def clamped_corner(x0: int, y0: int, res: int, width: int,
                   height: int) -> tuple[int, int]:
    """The window's top-left corner moved so a res^2 window fits."""
    return (int(np.clip(int(x0), 0, width - res)),
            int(np.clip(int(y0), 0, height - res)))


def _ellipse_quarter(a: int, b: int):
    """The boundary points of one quarter of an ellipse of diameters a, b
    (pixels), in doubled coordinates about its centre, from (a, b % 2) to
    (a % 2, b): Pillow's quarter walk (libImaging/Draw.c), which steps up,
    left or up-left to the point nearest the curve by |a^2 y^2 + b^2 x^2 -
    a^2 b^2|."""
    a2, b2 = a * a, b * b

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            d = delta(cx - 2, cy)
            if nd > d:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


@functools.cache
def circle_mask(size: int, margin: int = ERASE_CIRCLE_MARGIN) -> np.ndarray:
    """(size, size) bool: the erase stamp, the filled ellipse Pillow's
    ImageDraw.ellipse((margin, margin, size - margin, size - margin))
    draws. Each row of the ellipse is one span from -x to x, x the widest
    boundary point of that row."""
    lo, d = margin, size - 2 * margin
    out = np.zeros((size, size), bool)
    if d < 0:
        return out
    widest: dict[int, int] = {}
    for x, y in _ellipse_quarter(d, d):
        widest[y] = max(widest.get(y, -1), x)
    for y, x in widest.items():
        for row in {y, -y}:
            out[lo + (row + d) // 2,
                lo + (d - x) // 2:lo + (x + d) // 2 + 1] = True
    out.flags.writeable = False
    return out


def edge_slices(res: int, margin: int = STAMP_EDGE_MARGIN):
    """The window's pixels inside the stamp edge mask, as slices."""
    inner = slice(margin, res - margin)
    return inner, inner


def session_stamp(stamp, canvas, brush, cond, uncond, enc_noise,
                  init_latents, x0: int, y0: int, cfg_weight, tg_weight,
                  tg_steps, context_pad, margin: int = 0, step_noise=None):
    """One stamp into the resident `canvas` (H, W, 4) uint8, in place;
    returns the composited crop (res, res, 3) uint8 on the device. `stamp`
    is inpaint.make_stamp_fn's function or the engine's Stamp around it
    (any scheduler; `step_noise` its per-step draws), res the brush's size;
    margin > 0 clears the crop's centre first (overpaint)."""
    height, width = canvas.shape[:2]
    res = brush.shape[1]
    x, y = clamped_corner(x0, y0, res, width, height)
    window = canvas[y:y + res, x:x + res]
    crop = window.clone()
    if margin > 0:
        crop[margin:res - margin, margin:res - margin] = 0
    _, comp = stamp(crop[None], brush, cond, uncond, enc_noise,
                    init_latents, cfg_weight, tg_weight, tg_steps,
                    context_pad, step_noise)
    rows, cols = edge_slices(res)
    window[rows, cols, :3] = comp[rows, cols]
    window[rows, cols, 3] = 255
    return comp


def session_erase(canvas, keep, x0: int, y0: int):
    """Zero RGBA under the erase circle of the window at (x0, y0), in
    place; returns the window's RGB after the erase (res, res, 3), a copy.
    keep: (res, res, 1) uint8 on the canvas's device, 0 inside the circle
    and 1 outside (a product, so no step reads the mask back)."""
    height, width = canvas.shape[:2]
    res = keep.shape[0]
    x, y = clamped_corner(x0, y0, res, width, height)
    window = canvas[y:y + res, x:x + res]
    window.mul_(keep)
    return window[..., :3].clone()


def erase_keep(res: int, device):
    """session_erase's `keep` operand of a res^2 window (a uint8 tensor on
    `device`)."""
    import torch

    return torch.from_numpy(~circle_mask(res)).to(torch.uint8)[..., None] \
        .to(device)


def host_stamp_update(canvas_u8: np.ndarray, comp_u8: np.ndarray,
                      x0: int, y0: int) -> np.ndarray:
    """Host oracle of session_stamp's canvas write: a copy of the canvas
    with the composited crop and alpha 255 inside the edge mask of the
    window at the clamped corner."""
    res = comp_u8.shape[0]
    height, width = canvas_u8.shape[:2]
    x, y = clamped_corner(x0, y0, res, width, height)
    rows, cols = edge_slices(res)
    out = canvas_u8.copy()
    window = out[y:y + res, x:x + res]
    window[rows, cols, :3] = comp_u8[rows, cols]
    window[rows, cols, 3] = 255
    return out


def host_erase_update(canvas_u8: np.ndarray, res: int, x0: int,
                      y0: int) -> np.ndarray:
    """Host oracle of session_erase: a copy of the canvas with RGBA zeroed
    under the circle of the window at the clamped corner."""
    height, width = canvas_u8.shape[:2]
    x, y = clamped_corner(x0, y0, res, width, height)
    out = canvas_u8.copy()
    out[y:y + res, x:x + res][circle_mask(res)] = 0
    return out
