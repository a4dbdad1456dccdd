"""Procedural brush-stroke inpainting mask synthesis.

Port of diffusiontexturepainting_tpu/training/mask_generator.py, with the
polygon rasterized by image_io.polygon_mask (Pillow's rule, in numpy; the
card's machine has no Pillow): 1-4 rotated square "stamps" entering from a
side of the image simulate the partially-painted canvas an interactive
stroke produces; side/empty/center-clear probabilities follow the
reference's heuristics. Every function takes the same random.Random draws
in the same order as the JAX package's, so one seed gives one mask there
and here.

Convention: white (1) = known canvas, black (0) = to generate.
"""

from __future__ import annotations

import math
import random as _random

import numpy as np

from .image_io import polygon_mask


def simulate_draw_down_inpainting_mask(image_size: int, num_stamps_range,
                                       flip_horiz: bool = False,
                                       transpose: bool = False,
                                       rng: _random.Random | None = None):
    """Mask of square stamps entering from the top (drawing downward).

    Args:
        image_size: square mask side length.
        num_stamps_range: [min, max] stamps to place.
        flip_horiz: flip vertically so the drawing goes up.
        transpose: swap axes so the drawing comes from left/right.

    Returns: float32 (image_size, image_size, 1), white = known.
    """
    rng = rng or _random
    n_stamps = rng.randint(num_stamps_range[0], num_stamps_range[1])

    unit_square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64).T

    mask = np.zeros((image_size, image_size), dtype=bool)
    master_angle = rng.random() * math.pi / 4
    for _ in range(n_stamps):
        angle = master_angle + (rng.random() - 0.5) * math.pi * 0.2
        c, s = math.cos(angle), math.sin(angle)
        rot = np.array([[c, -s], [s, c]])
        width = rng.randint(image_size - image_size // 8, image_size)
        center = np.array([
            rng.randint(-width // 2 + 5, image_size + width // 2 - 5),
            rng.random() * -width / 2,
        ]).reshape(2, 1)
        poly = rot @ (unit_square * width * 0.5) + center  # rows: x, y
        mask |= polygon_mask(image_size, poly.T)

    if flip_horiz:
        mask = np.flip(mask, axis=0).copy()
    mask = mask.astype(np.float32)[..., None]
    if transpose:
        mask = mask.transpose(1, 0, 2)
    return mask


class RandomMaskGenerator:
    """Heuristic mask sampler for interactive-painting training data.

    Probabilities mirror the reference defaults (mask_generator.py:94-128):
    top-heavy 0.6, empty 0.2, no-mask 0.0, multi-side 0.2,
    center-cleared 0.2 with margin 8-64 px.
    """

    TOP, RIGHT, BOTTOM, LEFT = 0, 1, 2, 3

    def __init__(self, image_width: int, top_heavy_probability: float = 0.6,
                 num_stamps_range=(1, 4), prob_empty: float = 0.2,
                 prob_no_mask: float = 0.0,
                 prob_center_always_empty: float = 0.2,
                 margin_range=(8, 64), prob_multiple_sides: float = 0.2,
                 seed: int | None = None):
        self.image_width = image_width
        self.top_heavy_probability = top_heavy_probability
        self.num_stamps_range = num_stamps_range
        self.prob_empty = prob_empty
        self.prob_no_mask = prob_no_mask
        self.prob_center_always_empty = prob_center_always_empty
        self.margin_range = margin_range
        self.prob_multiple_sides = prob_multiple_sides
        self.rng = _random.Random(seed)

    def _chance(self, p: float) -> bool:
        return self.rng.random() < p

    def _for_side(self, side: int):
        do_flip = side in (self.BOTTOM, self.RIGHT)
        do_transpose = side in (self.LEFT, self.RIGHT)
        return simulate_draw_down_inpainting_mask(
            self.image_width, self.num_stamps_range, flip_horiz=do_flip,
            transpose=do_transpose, rng=self.rng)

    def __call__(self, rng: _random.Random | None = None) -> np.ndarray:
        """(W, W, 1) float32 mask; white = known, black = generate.

        `rng` overrides the generator's own stream for this call —
        deterministic per-batch data order (training/dataset.py batches)
        derives one RNG per sample so a resumed run replays the exact
        sequence without consuming the shared stream."""
        if rng is not None:
            self.rng = rng
        w = self.image_width
        if self._chance(self.prob_no_mask):
            return np.ones((w, w, 1), np.float32)
        if self._chance(self.prob_empty):
            return np.zeros((w, w, 1), np.float32)

        if self._chance(self.prob_multiple_sides):
            n_sides = self.rng.randint(2, 4)
            sides = list(range(4))
            self.rng.shuffle(sides)
            mask = self._for_side(sides[0])
            for s in sides[1:n_sides]:
                mask = np.maximum(mask, self._for_side(s))
            prob_center_empty = self.prob_center_always_empty + 0.4
        else:
            if self._chance(0.5):
                do_transpose, do_flip = True, self._chance(0.5)
            else:
                do_transpose = False
                do_flip = self._chance(1.0 - self.top_heavy_probability)
            mask = simulate_draw_down_inpainting_mask(
                w, self.num_stamps_range, flip_horiz=do_flip,
                transpose=do_transpose, rng=self.rng)
            prob_center_empty = self.prob_center_always_empty

        if self._chance(prob_center_empty):
            margin = self.rng.randint(*self.margin_range)
            mask[margin:-margin, margin:-margin, :] = 0.0
        return mask
