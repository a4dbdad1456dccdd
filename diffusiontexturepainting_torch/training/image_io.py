"""The image operations the training data takes from Pillow, in numpy.

The card's machine has no Pillow, so the port carries its own copy of what
the JAX package's dataset and mask generator use of it (training/
dataset.py, training/mask_generator.py there), on (H, W, C) uint8 arrays,
with Pillow's arithmetic:

  read_image_rgb   Image.open(...).convert("RGB"): the decoder chosen by
                   the file's first bytes, as Image.open chooses it; PNG
                   (8-bit colour types 0, 2, 4 and 6; type 3 at 1, 2, 4
                   or 8 bits; Adam7-interlaced or not; 16-bit PNG raises
                   ValueError) with alpha dropped, or JPEG (jpeg.py)
  write_png        an 8-bit PNG writer (gray, RGB or RGBA), each row's
                   filter chosen as libpng chooses it
  resize_bilinear  Image.resize(BILINEAR): the triangle filter's support
                   widened by the scale when downsampling, coefficients in
                   Pillow's 22-bit fixed point, the horizontal pass first
                   and its result rounded to u8, then the vertical pass
  rotate_bilinear  Image.rotate(angle, BILINEAR) about the centre, black
                   outside the source
  crop, flip_top_bottom, flip_left_right
  gaussian_blur    ImageFilter.GaussianBlur(radius): three passes of the
                   extended box blur each way, rounded to u8 after each
  polygon_mask     ImageDraw.polygon(fill=1) on a mode "1" image: the
                   vertices truncated to pixels, each row filled between
                   pairs of edge crossings

The stdlib's zlib inflates and deflates.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib

import numpy as np

from . import jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit resampling fixed point
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# --- PNG ---


def _chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 arrays: whichever of a (left), b (up)
    and c (up-left) is nearest a + b - c, ties to a, then b."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(kinds: np.ndarray, lines: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Every row's filter undone at once, (height, stride) uint8, for files
    with Average or Paeth rows: a pixel needs its left, upper and
    upper-left neighbours decoded first, so the pixels of one
    anti-diagonal (y + x constant) are independent and are decoded
    together, one diagonal after the other. The image is held skewed,
    q[y + x, y] (zero row and column in front), so that a diagonal and its
    two predecessors are contiguous slices."""
    height, stride = lines.shape
    width = stride // bpp
    q = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    ys = np.arange(1, height + 1)[:, None]
    xs = np.arange(1, width + 1)[None, :]
    q[ys + xs, ys] = lines.reshape(height, width, bpp)
    kind = np.zeros((height + 1, 1), np.int64)
    kind[1:, 0] = kinds
    # the predictors of the types present only; a row's own picked out
    present = [k for k in range(1, 5) if (kinds == k).any()]
    rows_of = {k: kind == k for k in present}
    uniform = len(present) == 1 and bool((kinds == present[0]).all())

    def predictor(k, a, b, c):
        if k == 1:
            return a
        if k == 2:
            return b
        return (a + b) >> 1 if k == 3 else _paeth(a, b, c)

    for d in range(2, height + width + 1):
        lo, hi = max(1, d - width), min(height, d - 1) + 1
        a, b, c = q[d - 1, lo:hi], q[d - 1, lo - 1:hi - 1], q[d - 2,
                                                            lo - 1:hi - 1]
        cur = q[d, lo:hi]
        if uniform:
            cur += predictor(present[0], a, b, c)
        else:
            pred = np.zeros_like(a)
            for k in present:
                np.copyto(pred, predictor(k, a, b, c),
                          where=rows_of[k][lo:hi])
            cur += pred
        cur &= 0xFF
    return q[ys + xs, ys].reshape(height, stride).astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines' filters undone: (height, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG: {rows.size} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    kinds, lines = rows[:, 0], rows[:, 1:]
    if kinds.size and kinds.max() > 4:
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"PNG: unknown filter type {kinds[y]} in row {y}")
    if np.isin(kinds, (3, 4)).any():
        return _unfilter_wavefront(kinds, lines, bpp)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = kinds[y], lines[y]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of a pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).reshape(-1)
        else:
            cur = line + prior
        out[y] = cur
        prior = out[y]
    return out


def _samples(raw: bytes, width: int, height: int, depth: int,
             channels: int) -> np.ndarray:
    """One (reduced) image's filtered scanlines -> (height, width,
    channels) uint8 samples, palette indices unpacked."""
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8))
    if depth < 8:  # palette indices packed big-endian into each byte
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        rows = (bits.reshape(height, width, depth) * weights).sum(-1)
    return rows.reshape(height, width, channels).astype(np.uint8, copy=False)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> (H, W, 3) uint8, Pillow's
    Image.open(...).convert("RGB") of it."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace > 1:
        raise ValueError(f"PNG: unknown interlace method {interlace}")
    if colour not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {colour}")
    if depth != 8 and not (colour == 3 and depth in (1, 2, 4)):
        raise ValueError(f"PNG: {depth}-bit samples of colour type {colour} "
                         "are not supported (8-bit only; palette 1-8 bit)")
    channels = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        pixels = _samples(raw, width, height, depth, channels)
    else:  # Adam7: seven reduced images, each filtered on its own
        pixels = np.zeros((height, width, channels), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filters
            size = ph * ((pw * channels * depth + 7) // 8 + 1)
            pixels[y0::dy, x0::dx] = _samples(raw[pos:pos + size], pw, ph,
                                              depth, channels)
            pos += size
    if colour == 3:
        if palette is None:
            raise ValueError("PNG: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[pixels[..., 0]]
    if colour in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """An image file's bytes -> (H, W, 3) uint8 RGB, the decoder chosen by
    content as Image.open chooses it: JPEG (FF D8 FF) or PNG (its
    signature); anything else raises ValueError."""
    if data.startswith(b"\xff\xd8\xff"):
        return jpeg.decode_jpeg(data)
    if data.startswith(_PNG_SIGNATURE):
        return decode_png(data)
    raise ValueError("neither a JPEG nor a PNG file")


def read_image_rgb(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (decode_image); every decoder
    error is raised as ValueError naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except Exception as e:  # noqa: BLE001 - zlib, struct, ... errors too
        raise ValueError(f"{path}: {e}") from e


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(lines: np.ndarray, bpp: int, kind=None) -> np.ndarray:
    """(height, stride) uint8 scanlines -> (height, 1 + stride) filtered,
    each row led by its filter type: `kind` for every row, or where None
    the type libpng's adaptive heuristic picks, the least sum of the
    filtered bytes taken as signed."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, c))
    kinds = range(5) if kind is None else (kind,)
    cands = np.stack([(x - preds[k]) & 0xFF for k in kinds]).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
    best = cost.argmin(0)
    chosen = np.asarray(kinds, np.uint8)[best]
    return np.concatenate([chosen[:, None],
                           cands[best, np.arange(len(x))]], axis=1)


def encode_png(image: np.ndarray, kind: int | None = None) -> bytes:
    """(H, W) or (H, W, 1|3|4) uint8 -> PNG bytes (8-bit gray, RGB or RGBA).
    Each row takes filter type `kind` (0-4), or where None the one libpng's
    adaptive heuristic picks, as Pillow and libpng write by default."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: uint8 only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, channels = img.shape
    colour = {1: 0, 3: 2, 4: 6}.get(channels)
    if colour is None:
        raise ValueError(f"encode_png: 1, 3 or 4 channels, got {channels}")
    rows = _filter_rows(img.reshape(height, width * channels), channels,
                        kind)
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                          colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


# --- geometry ---


def crop(img: np.ndarray, box) -> np.ndarray:
    """Image.crop((left, upper, right, lower)) inside the image."""
    x0, y0, x1, y1 = box
    return img[y0:y1, x0:x1]


def flip_top_bottom(img: np.ndarray) -> np.ndarray:
    return img[::-1]


def flip_left_right(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


@functools.lru_cache(maxsize=64)
def _resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's precompute_coeffs for the bilinear filter, normalized to
    its 8-bit fixed point, as a dense (out, in) float64 matrix of integer
    taps (a product of a tap and a u8 and their sums stay exact in
    float64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    x = np.arange(in_size)
    inside = (x >= xmin[:, None]) & (x < xmax[:, None])
    w = np.where(inside, np.maximum(
        0.0, 1.0 - np.abs((x - center[:, None] + 0.5) / filterscale)), 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return np.trunc(w * (1 << _PRECISION_BITS) + 0.5)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (0 rows, 1 columns) of (H, W, C) uint8."""
    m = _resample_matrix(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0)
    acc = m @ src.reshape(src.shape[0], -1).astype(np.float64)
    acc = np.floor((acc + (1 << (_PRECISION_BITS - 1)))
                   / (1 << _PRECISION_BITS))
    out = np.clip(acc, 0, 255).astype(np.uint8).reshape(
        (out_size,) + src.shape[1:])
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Image.resize((width, height), BILINEAR) of (H, W, C) uint8."""
    if img.shape[:2] == (height, width):
        return img.copy()
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, 0)
    return out


def rotate_bilinear(img: np.ndarray, angle: float) -> np.ndarray:
    """Image.rotate(angle, BILINEAR) of (H, W, C) uint8: counter-clockwise
    about the centre, the output the input's size, black where the source
    point leaves the image."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    rad = -math.radians(angle)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    cx, cy = w / 2.0, h / 2.0
    c = a * -cx + b * -cy + cx
    f = d * -cx + e * -cy + cy
    xo = np.arange(w, dtype=np.float64) + 0.5
    yo = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xin = a * xo + b * yo + c
    yin = d * xo + e * yo + f
    inside = ((xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)).ravel()
    xs, ys = xin.ravel()[inside] - 0.5, yin.ravel()[inside] - 0.5
    x0, y0 = np.floor(xs), np.floor(ys)
    dx, dy = (xs - x0)[:, None], (ys - y0)[:, None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya = np.clip(y0, 0, h - 1)
    # a source point on the last row blends that row with itself
    yb = np.where(y0 + 1 < h, np.clip(y0 + 1, 0, h - 1), ya)
    src = img.reshape(h * w, -1)
    p00, p01, p10, p11 = (src[i].astype(np.float64) for i in (
        ya * w + xa, ya * w + xb, yb * w + xa, yb * w + xb))
    top = p00 + (p01 - p00) * dx
    bottom = p10 + (p11 - p10) * dx
    v = top + (bottom - top) * dy
    out = np.zeros((h * w, img.shape[2]), np.uint8)
    out[inside] = np.clip(v, 0, 255).astype(np.uint8)
    return out.reshape(img.shape)


# --- filters ---


def _box_radius(radius: float, passes: int = 3) -> np.float32:
    """Pillow's _gaussian_blur_radius, in single precision as its C."""
    f = np.float32
    sigma2 = f(radius) * f(radius) / f(passes)
    big_l = f(math.sqrt(f(12.0) * sigma2 + f(1.0)))
    small_l = f(math.floor((big_l - f(1.0)) / f(2.0)))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return f(small_l + a)


def _box_blur_rows(img: np.ndarray, float_radius: np.float32) -> np.ndarray:
    """One Pillow horizontal box-blur pass over (H, W, C) uint8: the mean
    of the 2r+1 edge-clamped neighbours plus the fractional far pair, in
    24-bit fixed point, rounded."""
    r = int(float_radius)
    ww = int(np.float32(1 << 24) / (float_radius * np.float32(2)
                                    + np.float32(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    w = img.shape[1]
    idx = np.clip(np.arange(-r - 1, w + r + 1), 0, w - 1)
    line = img[:, idx].astype(np.int64)  # column j is source j - r - 1
    csum = np.concatenate([np.zeros_like(line[:, :1]),
                           np.cumsum(line, axis=1)], axis=1)
    acc = csum[:, 2 * r + 2:2 * r + 2 + w] - csum[:, 1:1 + w]
    far = line[:, :w] + line[:, 2 * r + 2:2 * r + 2 + w]
    bulk = acc * ww + far * fw
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """ImageFilter.GaussianBlur(radius) of (H, W, C) uint8."""
    if radius == 0:
        return img.copy()
    r = _box_radius(radius)
    out = img
    if r != 0:
        for _ in range(3):
            out = _box_blur_rows(out, r)
        out = out.transpose(1, 0, 2)
        for _ in range(3):
            out = _box_blur_rows(out, r)
        out = out.transpose(1, 0, 2)
    return np.ascontiguousarray(out)


# --- drawing ---


def polygon_mask(size: int, polygon_xy) -> np.ndarray:
    """ImageDraw.polygon(polygon_xy, fill=1) on a new (size, size) mode "1"
    image -> bool (size, size): the vertices truncated to whole pixels; each
    row y crosses the edges spanning it at x = x0 + (y - y0) * dx (an edge
    ending on y, below the polygon's last row, twice), and the pixels from
    round-up of one crossing to round-down of the next are filled, pair
    by pair."""
    pts = [(int(float(x)), int(float(y))) for x, y in polygon_xy]
    edges = []
    for i, (x0, y0) in enumerate(pts):
        x1, y1 = pts[(i + 1) % len(pts)]
        if y0 != y1:
            edges.append((x0, y0, x1, y1))
    mask = np.zeros((size, size), bool)
    if not edges:
        return mask
    lo = max(min(min(e[1], e[3]) for e in edges), 0)
    hi = min(max(max(e[1], e[3]) for e in edges), size)
    ys = np.arange(lo, hi + 1, dtype=np.float64)
    cross = []
    for x0, y0, x1, y1 in edges:
        ymin, ymax = min(y0, y1), max(y0, y1)
        dx = (x1 - x0) / (y1 - y0)
        x = (ys - y0) * dx + x0
        on = (ys >= ymin) & (ys <= ymax)
        cross.append(np.where(on, x, np.nan))
        cross.append(np.where(on & (ys == ymax) & (ys < hi), x, np.nan))
    xx = np.sort(np.stack(cross, axis=1), axis=1)  # NaN last
    count = np.sum(~np.isnan(xx), axis=1)
    cols = np.arange(size)
    for k in range(1, xx.shape[1], 2):
        start = np.where(xx[:, k - 1] >= 0, np.floor(xx[:, k - 1] + 0.5),
                         -np.floor(np.abs(xx[:, k - 1]) + 0.5))
        end = np.where(xx[:, k] >= 0, np.ceil(xx[:, k] - 0.5),
                       -np.ceil(np.abs(xx[:, k]) - 0.5))
        ok = (count > k) & (end >= start)
        rows = ys.astype(np.int64)
        fill = ok[:, None] & (cols >= start[:, None]) & (cols <= end[:, None])
        valid = rows < size
        mask[rows[valid]] |= fill[valid]
    return mask
