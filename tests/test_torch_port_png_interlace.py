"""Adam7-interlaced PNG in the port's decoder (diffusiontexturepainting_torch/
training/image_io.py decode_png) against Pillow's
Image.open(...).convert("RGB"), on the CPU.

Pillow writes no interlaced PNG, so the test writes its own: the image cut
into Adam7's seven reduced images, each row of each filtered on its own
(libpng's adaptive choice, or one filter type for every row), the passes'
bytes concatenated and deflated. Gray, gray + alpha, RGB, RGBA and palette
images (8-bit, and palettes at 1, 2 and 4 bits, whose reduced rows are
packed and padded one by one), at sizes from 1x1 (where six passes are
empty and carry no bytes, not even filter types) up to 33x17 and 64x40,
decode byte for byte as Pillow decodes them.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from diffusiontexturepainting_torch.training import image_io

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# name -> (colour type, bit depth, channels)
MODES = {"gray": (0, 8, 1), "gray_alpha": (4, 8, 2), "rgb": (2, 8, 3),
         "rgba": (6, 8, 4), "palette": (3, 8, 1), "palette4": (3, 4, 1),
         "palette2": (3, 2, 1), "palette1": (3, 1, 1)}
SIZES = [(1, 1), (2, 3), (5, 3), (7, 2), (8, 8), (9, 13), (33, 17),
         (64, 40)]  # (width, height)


def pack_rows(samples, depth):
    """(h, w, c) uint8 samples -> (h, stride) bytes, sub-byte samples
    packed big-endian and each row padded to a byte."""
    h, w, c = samples.shape
    if depth == 8:
        return samples.reshape(h, w * c)
    shifts = np.arange(depth - 1, -1, -1)
    bits = (samples[..., 0][..., None] >> shifts) & 1
    return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)


def adam7_png(samples, colour, depth, palette=None, kind=None):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    parts = []
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        parts.append(image_io._filter_rows(pack_rows(sub, depth), bpp,
                                           kind).tobytes())
    body = [image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                 colour, 0, 0, 1))]
    if palette is not None:
        body.append(image_io._chunk(b"PLTE", palette.tobytes()))
    body.append(image_io._chunk(b"IDAT", zlib.compress(b"".join(parts))))
    body.append(image_io._chunk(b"IEND", b""))
    return image_io._PNG_SIGNATURE + b"".join(body)


def samples_for(mode, w, h, seed):
    colour, depth, c = MODES[mode]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = (128 + 100 * np.sin(x / 3.0 + y / 5.0))[..., None]
    img = np.clip(smooth + rng.integers(-30, 30, (h, w, c)), 0, 255)
    palette = None
    if colour == 3:
        n = 1 << depth
        img = rng.integers(0, n, (h, w, 1))
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return img.astype(np.uint8), colour, depth, palette


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_adam7_matches_pillow(mode, size):
    w, h = size
    img, colour, depth, palette = samples_for(mode, w, h, w * 31 + h)
    data = adam7_png(img, colour, depth, palette)
    pil = Image.open(io.BytesIO(data))
    assert pil.info.get("interlace") == 1
    want = np.asarray(pil.convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_adam7_each_filter_type(kind):
    """Every row of every pass under one filter type (Average and Paeth
    rows take the diagonal decode)."""
    img, colour, depth, palette = samples_for("rgb", 29, 21, kind)
    data = adam7_png(img, colour, depth, palette, kind=kind)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)
    np.testing.assert_array_equal(image_io.decode_png(data), img)


def test_adam7_short_data_raises(tmp_path):
    """A stream cut inside the last pass raises ValueError naming the
    file."""
    img, colour, depth, palette = samples_for("rgb", 12, 10, 3)
    parts = []
    for x0, y0, dx, dy in ADAM7:
        sub = img[y0::dy, x0::dx]
        parts.append(image_io._filter_rows(pack_rows(sub, 8), 3).tobytes())
    raw = b"".join(parts)[:-5]
    data = (image_io._PNG_SIGNATURE
            + image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", 12, 10, 8, 2,
                                                   0, 0, 1))
            + image_io._chunk(b"IDAT", zlib.compress(raw))
            + image_io._chunk(b"IEND", b""))
    path = tmp_path / "cut.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="cut.png: PNG"):
        image_io.read_image_rgb(path)
