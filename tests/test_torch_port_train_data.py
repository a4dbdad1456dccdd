"""The port's training data (diffusiontexturepainting_torch/training/
image_io.py, mask_generator.py, dataset.py) against Pillow and the JAX
package's training/dataset.py and mask_generator.py, on the CPU.

- PNG decode is bit-equal to Pillow's Image.open(...).convert("RGB") for
  the five colour types (8-bit L, RGB, palette, LA, RGBA, and a palette at
  4 bits); the port's writer round-trips through Pillow; 16-bit files, a
  non-interlaced stream flagged Adam7 and a JPEG given to the PNG decoder
  raise ValueError (Adam7 files: tests/test_torch_port_png_interlace.py;
  JPEG: tests/test_torch_port_jpeg.py).
- Resize, rotate and blur stay within 1 u8 level of Pillow's on at least
  99% of pixels (PIL_SHARE; `python -m tests.test_torch_port_train_data`
  prints the measured shares, which the three copy Pillow's fixed-point
  and double arithmetic to reach).
- Masks from 200 seeds agree with the JAX generator's on at least 99.5% of
  pixels (MASK_SHARE; only polygon edges may differ) and both generators'
  next draw is equal after every call.
- A dataset sample (plain and --augment_data) takes the same draws as the
  JAX one: the next draw is equal, drop_cond identical, the arrays within
  the resize tolerance; batches(start=N) replays the stream.
"""

import io
import random
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFilter

from diffusiontexturepainting_torch.training import dataset as t_data
from diffusiontexturepainting_torch.training import image_io
from diffusiontexturepainting_torch.training import mask_generator as t_mask
from diffusiontexturepainting_tpu.training import dataset as j_data
from diffusiontexturepainting_tpu.training import mask_generator as j_mask

PIL_SHARE = 0.99
MASK_SHARE = 0.995


def texture(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / (6.0 + seed) + c)
                     * np.cos(y / (10.0 + seed) - c) for c in range(3)], -1)
    return np.clip(base + rng.integers(-25, 25, base.shape), 0,
                   255).astype(np.uint8)


def png_bytes(pil, **kw):
    buf = io.BytesIO()
    pil.save(buf, "PNG", **kw)
    return buf.getvalue()


def within_one_share(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return (np.abs(got.astype(int) - want.astype(int)) <= 1).mean()


IMG = texture(90, 77, 0)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA", "P4"])
def test_png_decode_matches_pillow(mode):
    pil = Image.fromarray(IMG)
    if mode == "P":
        pil = pil.quantize(200)
    elif mode == "P4":  # Pillow writes a palette of <= 16 colours at 4 bits
        pil = pil.quantize(12)
    else:
        pil = pil.convert(mode)
    data = png_bytes(pil)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips(channels, tmp_path):
    a = np.random.default_rng(channels).integers(0, 256, (21, 34, channels),
                                                 dtype=np.uint8)
    path = tmp_path / "x.png"
    image_io.write_png(path, a)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.reshape(a.shape), a)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(image_io.read_image_rgb(path), want)


def test_png_refusals(tmp_path):
    # the port's own non-interlaced stream with its IHDR's Adam7 flag set:
    # its bytes do not fill the seven passes
    plain = image_io.encode_png(IMG)
    width, height = IMG.shape[1], IMG.shape[0]
    ihdr = image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                                8, 2, 0, 0, 1))
    adam7 = plain[:8] + ihdr + plain[8 + len(ihdr):]
    with pytest.raises(ValueError, match="PNG"):
        image_io.decode_png(adam7)
    wide = Image.fromarray((IMG[..., 0].astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="16-bit"):
        image_io.decode_png(png_bytes(wide))
    jpg = tmp_path / "t.JPG"
    Image.fromarray(IMG).save(jpg, "JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(jpg.read_bytes())
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(b"GIF89a")


def test_png_decodes_every_filter():
    """A file whose rows take several of the five filters (Pillow's
    adaptive choice on a noisy image)."""
    data = png_bytes(Image.fromarray(texture(64, 64, 5)))
    raw = zlib.decompress(b"".join(
        body for kind, body in image_io._chunks(data) if kind == b"IDAT"))
    filters = {raw[y * (64 * 3 + 1)] for y in range(64)}
    assert len(filters) >= 3, filters
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


def filtered_rows(data, height):
    """The filtered scanlines of a PNG: (height, 1 + stride) uint8, each
    led by its filter type."""
    raw = zlib.decompress(b"".join(
        body for kind, body in image_io._chunks(data) if kind == b"IDAT"))
    return np.frombuffer(raw, np.uint8).reshape(height, -1)


@pytest.mark.parametrize("kind", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_filter_types(channels, kind):
    """Every row written with filter `kind` (None: the adaptive choice)
    reads back exactly through Pillow and through the port's decoder."""
    a = texture(45, 38, channels)
    a = a[..., :1] if channels == 1 else (
        np.concatenate([a, a[..., :1]], -1) if channels == 4 else a)
    data = image_io.encode_png(a, kind)
    kinds = filtered_rows(data, 45)[:, 0]
    if kind is not None:
        assert (kinds == kind).all()
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back.reshape(a.shape), a)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


def test_png_writer_picks_as_libpng():
    """The adaptive choice is libpng's: each row takes the filter whose
    bytes, read as signed, have the least absolute sum; a smooth texture
    takes Average or Paeth on most rows, as libpng's files do."""
    a = texture(64, 64, 7)
    rows = filtered_rows(image_io.encode_png(a), 64)
    cost = np.stack([np.abs(filtered_rows(image_io.encode_png(a, k), 64)[
        :, 1:].view(np.int8).astype(int)).sum(1) for k in range(5)])
    chosen = np.abs(rows[:, 1:].view(np.int8).astype(int)).sum(1)
    np.testing.assert_array_equal(chosen, cost.min(0))
    assert np.isin(rows[:, 0], (3, 4)).mean() > 0.5, np.bincount(rows[:, 0])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_mixed_filter_rows(channels):
    """Rows of all five filter types in a random order, decoded as Pillow
    decodes them (the diagonal-by-diagonal decode of Average and Paeth
    rows among the others)."""
    rng = np.random.default_rng(channels)
    a = rng.integers(0, 256, (41, 23, channels), dtype=np.uint8)
    every = np.stack([filtered_rows(image_io.encode_png(a, k), 41)
                      for k in range(5)])
    mixed = every[rng.integers(0, 5, 41), np.arange(41)]
    assert len(set(mixed[:, 0])) == 5
    colour = {1: 0, 3: 2, 4: 6}[channels]
    data = (image_io._PNG_SIGNATURE
            + image_io._chunk(b"IHDR", struct.pack(">IIBBBBB", 23, 41, 8,
                                                   colour, 0, 0, 0))
            + image_io._chunk(b"IDAT", zlib.compress(mixed.tobytes()))
            + image_io._chunk(b"IEND", b""))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("size", [(224, 224), (512, 512), (31, 45),
                                  (200, 60)])
def test_resize_matches_pillow(size):
    for src in (IMG, texture(300, 260, 1)):
        got = image_io.resize_bilinear(src, *size)
        want = np.asarray(Image.fromarray(src).resize(size, Image.BILINEAR))
        assert within_one_share(got, want) >= PIL_SHARE


@pytest.mark.parametrize("angle", [0.0, 12.3, 45.0, 89.9, 90.0, 180.0,
                                   355.2])
def test_rotate_matches_pillow(angle):
    for src in (IMG, texture(64, 64, 2)):
        got = image_io.rotate_bilinear(src, angle)
        want = np.asarray(Image.fromarray(src).rotate(
            angle, resample=Image.BILINEAR))
        assert within_one_share(got, want) >= PIL_SHARE


@pytest.mark.parametrize("radius", [0.1, 0.6, 1.0, 1.37, 2.0])
def test_gaussian_blur_matches_pillow(radius):
    got = image_io.gaussian_blur(IMG, radius)
    want = np.asarray(Image.fromarray(IMG).filter(
        ImageFilter.GaussianBlur(radius=radius)))
    assert within_one_share(got, want) >= PIL_SHARE


def test_flips_and_crop_match_pillow():
    pil = Image.fromarray(IMG)
    np.testing.assert_array_equal(
        image_io.flip_top_bottom(IMG),
        np.asarray(pil.transpose(Image.FLIP_TOP_BOTTOM)))
    np.testing.assert_array_equal(
        image_io.flip_left_right(IMG),
        np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))
    np.testing.assert_array_equal(image_io.crop(IMG, (3, 5, 40, 61)),
                                  np.asarray(pil.crop((3, 5, 40, 61))))


def test_masks_match_jax_generator():
    shares = []
    for seed in range(200):
        jg = j_mask.RandomMaskGenerator(256, seed=seed)
        tg = t_mask.RandomMaskGenerator(256, seed=seed)
        for _ in range(2):
            want, got = jg(), tg()
            assert got.shape == want.shape and got.dtype == want.dtype
            shares.append((got == want).mean())
            assert jg.rng.getstate() == tg.rng.getstate()
    assert min(shares) >= MASK_SHARE, min(shares)


def test_draw_down_mask_takes_the_same_draws():
    for seed in range(20):
        a, b = random.Random(seed), random.Random(seed)
        want = j_mask.simulate_draw_down_inpainting_mask(
            128, (1, 4), flip_horiz=seed % 2 == 1, transpose=seed % 3 == 0,
            rng=a)
        got = t_mask.simulate_draw_down_inpainting_mask(
            128, (1, 4), flip_horiz=seed % 2 == 1, transpose=seed % 3 == 0,
            rng=b)
        assert a.random() == b.random()
        assert (got == want).mean() >= MASK_SHARE


@pytest.fixture(scope="module")
def texture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("textures")
    for i in range(4):
        image_io.write_png(d / f"t{i}.png", texture(150 + 10 * i, 140, i))
    return d


@pytest.mark.parametrize("augment", [False, True])
def test_sample_matches_jax(texture_dir, augment):
    kw = dict(size=64, cond_size=32, seed=3, augment=augment)
    jd = j_data.AugmentedTextures(str(texture_dir), **kw)
    td = t_data.AugmentedTextures(str(texture_dir), **kw)
    assert [str(p) for p in td.files] == [str(p) for p in jd.files]
    for s in range(6):
        ra, rb = random.Random(s), random.Random(s)
        want, got = jd.sample(s % 4, ra), td.sample(s % 4, rb)
        assert ra.random() == rb.random()
        assert got["drop_cond"] == want["drop_cond"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
        for k in ("image", "masked_image", "cond_image"):
            # one u8 level of the resize in [-1, 1] or [0, 1] units
            unit = 2 / 255 if k != "cond_image" else 1 / 255
            diff = np.abs(got[k] - want[k])
            assert (diff <= unit + 1e-6).mean() >= PIL_SHARE, k
        assert (got["mask"] == want["mask"]).mean() >= MASK_SHARE
        np.testing.assert_allclose(got["cond_patches"],
                                   want["cond_patches"], atol=4 / 255 / 0.26)


def test_batches_replay_from_start(texture_dir):
    td = t_data.AugmentedTextures(str(texture_dir), size=64, cond_size=32,
                                  seed=1)
    run = list(td.batches(2, steps=5))
    resumed = list(td.batches(2, steps=2, start=3))
    for a, b in zip(run[3:], resumed):
        assert set(a) == set(b) == {"image", "mask", "masked_image",
                                    "cond_patches", "drop_cond"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert run[0]["cond_patches"].shape == (2, 14, 32, 32, 3)


def test_find_images_lists_jpeg_and_reading_it_raises(tmp_path):
    """Both packages list the same files; a JPEG sample reads the image
    Pillow reads (the JAX dataset's sample on it is the port's within
    the resize tolerance); a truncated JPEG raises naming the file."""
    image_io.write_png(tmp_path / "a.png", IMG)
    Image.fromarray(IMG).save(tmp_path / "b.jpg", "JPEG")
    whole = io.BytesIO()
    Image.fromarray(IMG).save(whole, "JPEG", quality=95)
    (tmp_path / "c.jpeg").write_bytes(whole.getvalue()[:2000])
    want = [str(p) for p in j_data.find_images(str(tmp_path))]
    assert [str(p) for p in t_data.find_images(str(tmp_path))] == want
    assert len(want) == 3
    td = t_data.AugmentedTextures(str(tmp_path), size=32, cond_size=32,
                                  seed=0)
    jd = j_data.AugmentedTextures(str(tmp_path), size=32, cond_size=32,
                                  seed=0)
    jpg = [i for i, p in enumerate(td.files) if p.suffix == ".jpg"][0]
    np.testing.assert_array_equal(
        image_io.read_image_rgb(td.files[jpg]),
        np.asarray(Image.open(td.files[jpg]).convert("RGB")))
    got, ref = td.sample(jpg, random.Random(0)), jd.sample(jpg,
                                                           random.Random(0))
    assert (np.abs(got["image"] - ref["image"]) <= 2 / 255 + 1e-6).mean() \
        >= PIL_SHARE
    cut = [i for i, p in enumerate(td.files) if p.suffix == ".jpeg"][0]
    with pytest.raises(ValueError, match="c.jpeg: JPEG"):
        td.sample(cut, random.Random(0))


def measured_shares() -> dict:
    """The measured shares the tests above bound: resize, rotate and blur
    within 1 level and exactly equal, masks equal over 200 seeds (the
    least of the 400 masks)."""
    out = {}
    pairs = {
        "resize": [(image_io.resize_bilinear(src, *size),
                    np.asarray(Image.fromarray(src).resize(size,
                                                           Image.BILINEAR)))
                   for size in ((224, 224), (512, 512), (31, 45), (200, 60))
                   for src in (IMG, texture(300, 260, 1))],
        "rotate": [(image_io.rotate_bilinear(IMG, a), np.asarray(
            Image.fromarray(IMG).rotate(a, resample=Image.BILINEAR)))
            for a in (12.3, 45.0, 89.9, 355.2)],
        "blur": [(image_io.gaussian_blur(IMG, r), np.asarray(
            Image.fromarray(IMG).filter(ImageFilter.GaussianBlur(radius=r))))
            for r in (0.1, 0.6, 1.0, 1.37, 2.0)],
    }
    for name, ps in pairs.items():
        out[name] = {"within_1": min(within_one_share(g, w) for g, w in ps),
                     "equal": min(float((g == w).mean()) for g, w in ps)}
    masks = []
    for seed in range(200):
        jg = j_mask.RandomMaskGenerator(256, seed=seed)
        tg = t_mask.RandomMaskGenerator(256, seed=seed)
        masks += [float((tg() == jg()).mean()) for _ in range(2)]
    out["masks"] = {"equal": min(masks), "mean": float(np.mean(masks))}
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_port_train_data: the measured shares
    for k, v in measured_shares().items():
        print(k, v)
