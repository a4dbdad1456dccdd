"""Texture training dataset with procedural inpainting masks.

Port of diffusiontexturepainting_tpu/training/dataset.py, over
image_io's numpy copies of the Pillow operations it uses (the card's
machine has no Pillow): each sample takes a texture image, cuts a random
augmented patch, splits it into a ground-truth crop and a *different*
conditioning crop of the same texture (teaching "continue this texture,
don't copy it"), builds the multi-scale conditioning patch pyramid, and
draws a random brush-stroke inpainting mask. The random.Random draws come
in the JAX package's order (rotate, crop, flips, the conditioning crop,
the augmentation, the mask, drop_cond), so one seed gives the same stream
there and here.

Batches come out NHWC float32 with the mask already inverted to the UNet
convention (1 = generate), matching the reference collate_fn
(train_texture_inpaint_lora.py:519-527). Images are PNG or JPEG, read by
content (image_io.read_image_rgb), as Pillow reads them.
"""

from __future__ import annotations

import math
import random as _random
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from ..core.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from . import image_io
from .mask_generator import RandomMaskGenerator

EXTS = ("png", "jpg", "jpeg")


def find_images(images_path: str, num_images: int = -1,
                skip_images: Optional[str] = None,
                single_image: Optional[str] = None) -> list:
    root = Path(images_path).expanduser().resolve()
    if single_image is not None:
        files = [p for ext in EXTS for p in root.glob(f"**/{single_image}.{ext}")]
        assert len(files) == 1, f"single_image matched {len(files)} files"
        return files
    files = sorted(p for ext in EXTS for p in root.glob(f"**/*.{ext}"))
    if skip_images:
        with open(skip_images) as f:
            skip = set(filter(None, f.read().split("\n")))
        files = [p for p in files if str(p) not in skip]
    return files[:num_images] if num_images != -1 else files


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _random_resized_crop(img: np.ndarray, out_size: int, scale,
                         rng: _random.Random, ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics (area-scale sampling) on
    (H, W, 3) uint8."""
    h, w = img.shape[:2]
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            crop = image_io.crop(img, (x, y, x + cw, y + ch))
            return image_io.resize_bilinear(crop, out_size, out_size)
    # fallback: center crop
    m = min(w, h)
    x, y = (w - m) // 2, (h - m) // 2
    return image_io.resize_bilinear(
        image_io.crop(img, (x, y, x + m, y + m)), out_size, out_size)


def make_cond_patches(image: np.ndarray, patch_size: int) -> np.ndarray:
    """(S, S, 3) -> (n, patch, patch, 3) row-major tiles (remainder cropped,
    matching torch unfold)."""
    s = image.shape[0] // patch_size
    crop = image[: s * patch_size, : s * patch_size]
    tiles = crop.reshape(s, patch_size, s, patch_size, 3).transpose(0, 2, 1, 3, 4)
    return tiles.reshape(s * s, patch_size, patch_size, 3)


def _resize_np(img: np.ndarray, size: int) -> np.ndarray:
    return _to_float(image_io.resize_bilinear(_to_u8(img), size, size))


class AugmentedTextures:
    """Map-style dataset over a folder of texture images."""

    def __init__(self, images_path: str, size: int = 256, cond_size: int = 224,
                 normalize_cond: bool = True, num_images: int = -1,
                 patch_scale=(0.25, 0.5), single_image: Optional[str] = None,
                 cond_drop_prob: float = 0.1, prob_no_mask: float = 0.1,
                 prob_empty_mask: float = 0.2, skip_images: Optional[str] = None,
                 augment: bool = False, num_patches: Sequence[int] = (1, 4, 9),
                 seed: Optional[int] = None):
        self.size = size
        self.cond_size = cond_size
        self.normalize_cond = normalize_cond
        self.patch_scale = patch_scale
        self.cond_drop_prob = cond_drop_prob
        self.augment = augment
        self.num_patches = tuple(num_patches)
        self.cond_patch_size = [size // int(math.isqrt(i)) for i in num_patches]
        self.files = find_images(images_path, num_images, skip_images,
                                 single_image)
        # The data stream is a pure function of (seed, batch index), so a
        # resumed run replays the exact sequence. A concrete seed is drawn
        # once when the caller passed None.
        self.seed = seed if seed is not None else _random.randrange(2**31)
        self.rng = _random.Random(seed)
        self.mask_generator = RandomMaskGenerator(
            size, prob_no_mask=prob_no_mask, prob_empty=prob_empty_mask,
            seed=None if seed is None else seed + 1)

    def __len__(self):
        return len(self.files)

    def _augmented_patch(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        img = image_io.rotate_bilinear(img, rng.uniform(0, 90))
        img = _random_resized_crop(img, self.size * 2, self.patch_scale, rng)
        if rng.random() < 0.5:
            img = image_io.flip_top_bottom(img)
        if rng.random() < 0.5:
            img = image_io.flip_left_right(img)
        return img

    def __getitem__(self, i: int) -> dict:
        return self.sample(i, self.rng)

    def sample(self, i: int, rng: _random.Random) -> dict:
        """One sample drawn entirely from `rng` (mask generator included),
        so identical (i, rng-seed) pairs produce identical samples."""
        self.rng = rng
        img = image_io.read_image_rgb(self.files[i])
        patch = self._augmented_patch(img)
        arr = _to_float(patch)  # (2S, 2S, 3)

        # GT = center crop; cond = a different random crop of the same patch
        s = self.size
        c = (arr.shape[0] - s) // 2
        gt = arr[c : c + s, c : c + s] * 2.0 - 1.0

        x = self.rng.randint(0, arr.shape[1] - s)
        y = self.rng.randint(0, arr.shape[0] - s)
        cond_img = arr[y : y + s, x : x + s]
        if self.augment:
            # --augment_data: extra augmentation of the CONDITIONING crop
            # only - RandomCrop (above) + RandomRotation(10) +
            # GaussianBlur(kernel 3), matching the reference's augment
            # transform stack (reference training/dataset.py:106-113;
            # torchvision's kernel-3 blur draws sigma ~ U(0.1, 2.0))
            u8 = image_io.rotate_bilinear(_to_u8(cond_img),
                                          rng.uniform(-10, 10))
            u8 = image_io.gaussian_blur(u8, rng.uniform(0.1, 2.0))
            cond_img = _to_float(u8)

        patches = []
        for p in self.cond_patch_size:
            tiles = make_cond_patches(cond_img, p)
            patches.append(np.stack([_resize_np(t, self.cond_size)
                                     for t in tiles]))
        cond = np.concatenate(patches, axis=0)  # (total, 224, 224, 3)
        if self.normalize_cond:
            cond = (cond - np.asarray(CLIP_IMAGE_MEAN, np.float32)) / np.asarray(
                CLIP_IMAGE_STD, np.float32)
        else:
            cond = cond * 2.0 - 1.0

        mask_known = self.mask_generator(rng)  # white = known
        mask_generate = 1.0 - mask_known  # UNet convention (collate inversion)
        masked_image = gt * mask_known
        drop_cond = np.float32(self.rng.random() < self.cond_drop_prob)

        return {
            "image": gt.astype(np.float32),
            "mask": mask_generate.astype(np.float32),
            "masked_image": masked_image.astype(np.float32),
            "cond_patches": cond.astype(np.float32),
            "drop_cond": drop_cond,
            # raw [0,1] conditioning crop, logging-only (the validation
            # grid's conditioning panel); batches() drops it.
            "cond_image": cond_img.astype(np.float32),
        }

    def batches(self, batch_size: int, steps: Optional[int] = None,
                shuffle: bool = True, start: int = 0,
                shard: Optional[tuple] = None) -> Iterator[dict]:
        """Infinite (or `steps`-bounded) iterator of stacked NHWC batches.

        The stream is a pure function of (self.seed, batch index): every
        batch's shuffle order and per-sample RNG are derived from the
        global batch counter, so `start=N` resumes the exact sequence the
        original run saw from its N-th batch without paying for the skipped
        batches.

        shard=(rank, world): `batch_size` is the global batch, and rank r
        builds only its samples j in [r * B / N, (r + 1) * B / N), each
        from its own Random(f"{seed}-b{b}-s{j}"), so the ranks' batches,
        concatenated in rank order, are the unsharded batch.
        """
        n = len(self.files)
        if n < batch_size:
            raise ValueError(f"dataset ({n}) smaller than batch {batch_size}")
        rank, world = shard or (0, 1)
        if batch_size % world:
            raise ValueError(f"batch {batch_size} does not divide over "
                             f"{world} ranks")
        per_rank = batch_size // world
        per_epoch = n // batch_size
        b = start
        while steps is None or b - start < steps:
            epoch, k = divmod(b, per_epoch)
            order = list(range(n))
            if shuffle:
                _random.Random(f"{self.seed}-epoch-{epoch}").shuffle(order)
            idxs = order[k * batch_size : (k + 1) * batch_size]
            samples = [
                self.sample(i, _random.Random(f"{self.seed}-b{b}-s{j}"))
                for j, i in enumerate(idxs)
                if rank * per_rank <= j < (rank + 1) * per_rank
            ]
            yield {k_: np.stack([smp[k_] for smp in samples])
                   for k_ in samples[0] if k_ != "cond_image"}
            b += 1
