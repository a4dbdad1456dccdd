"""The port's JPEG decoder (diffusiontexturepainting_torch/training/jpeg.py)
and image_io's choice of decoder, against Pillow on the CPU.

- Pillow-written JPEGs at quality 50 / 75 / 95 / 100 and subsampling
  4:4:4, 4:2:2 and 4:2:0 (Pillow's `subsampling` option writes no other
  layout), and gray, optimized, progressive, restart-marker, RGB (Adobe
  transform 0), EXIF / comment / ICC and all-ones-table files, at sizes
  1x1, 7x9, 17x33 and 517x389 (width x height): each decodes byte for byte
  to Image.open(...).convert("RGB").
- The kinds the decoder does not read (arithmetic coding, lossless, 12-bit,
  hierarchical, CMYK, 4:4:0's 1x2 upsampling, a progressive file whose
  scans leave coefficient bits unknown) and a truncated file raise
  ValueError naming the file; read_image_rgb picks the decoder by content,
  not by extension.
- The JPEG fixtures the card's smoke decodes (tests/fixtures/jpeg/, written
  by Pillow, which the card's machine lacks): their manifest holds the
  sha256 of each one's Pillow decode, re-checked here so that it cannot
  drift, and the port's decode equals Pillow's.
  `python -m tests.test_torch_port_jpeg --write-fixtures` writes them anew.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from diffusiontexturepainting_torch.training import image_io, jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
MANIFEST = FIXTURES / "manifest.json"
FIXTURE_BYTES_MAX = 512 * 1024
# name -> ((height, width), gray, Pillow save options)
FIXTURE_SPECS = {
    "baseline_420_640.jpg": ((640, 640), False,
                             dict(quality=75, optimize=True)),
    "progressive_640.jpg": ((640, 640), False,
                            dict(quality=75, progressive=True)),
    "restart_444.jpg": ((240, 320), False,
                        dict(quality=90, subsampling=0,
                             restart_marker_blocks=7)),
    "odd_422.jpg": ((201, 333), False, dict(quality=85, subsampling=1)),
    "gray.jpg": ((256, 200), True, dict(quality=80)),
}

SIZES = [(1, 1), (7, 9), (17, 33), (517, 389)]  # (width, height)
QUALITIES = [50, 75, 95, 100]
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}
OPTIONS = {
    "gray": dict(mode="L", quality=75),
    "gray_progressive": dict(mode="L", quality=90, progressive=True),
    "optimize": dict(quality=75, optimize=True),
    "progressive": dict(quality=75, progressive=True),
    "progressive_444": dict(quality=95, progressive=True, subsampling=0),
    "progressive_422": dict(quality=60, progressive=True, subsampling=1),
    "restart_blocks": dict(quality=80, restart_marker_blocks=3),
    "restart_rows": dict(quality=80, subsampling=1, restart_marker_rows=1),
    "progressive_restart": dict(quality=85, progressive=True,
                                restart_marker_blocks=2),
    "rgb_adobe": dict(quality=90, keep_rgb=True),
    "exif_comment_icc": dict(quality=75, comment="a texture",
                             exif=b"Exif\x00\x00MM\x00*\x00\x00\x00\x08"
                                  b"\x00\x00\x00\x00\x00\x00",
                             icc_profile=b"\x00" * 200),
    "ones_tables": dict(qtables=[[1] * 64, [1] * 64], subsampling=0),
}


def texture(h, w, seed, noise=10.0):
    """A seeded (h, w, 3) uint8 texture: three interfering sinusoid
    fields plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.02, 0.2, (3, 2))
    ph = rng.uniform(0, 6.3, 3)
    base = np.stack([128 + 90 * np.sin(x * f[c, 0] + ph[c])
                     * np.cos(y * f[c, 1] - ph[c]) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, noise, base.shape), 0,
                   255).astype(np.uint8)


def jpeg_bytes(img, mode=None, **options):
    pil = Image.fromarray(img)
    if mode:
        pil = pil.convert(mode)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", **options)
    return buf.getvalue()


def pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pillow(data, path):
    """The file read back through image_io.read_image_rgb (the decoder
    picked by content) equals Pillow's decode, as does decode_jpeg."""
    want = pillow_rgb(data)
    path.write_bytes(data)
    for got in (image_io.read_image_rgb(path), jpeg.decode_jpeg(data)):
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_matches_pillow(size, quality, sub, tmp_path):
    w, h = size
    data = jpeg_bytes(texture(h, w, w * 7 + h), quality=quality,
                      subsampling=SUBSAMPLING[sub])
    assert_decodes_as_pillow(data, tmp_path / "t.jpg")


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_options_match_pillow(size, option, tmp_path):
    w, h = size
    data = jpeg_bytes(texture(h, w, w + 3 * h), **OPTIONS[option])
    if option.startswith("progressive"):
        assert b"\xff\xc2" in data
    if option.startswith("restart") or option.endswith("restart"):
        assert b"\xff\xdd" in data
    assert_decodes_as_pillow(data, tmp_path / "t.jpeg")


def test_jpeg_every_restart_interval(tmp_path):
    """A restart marker after every MCU on a 4:2:0 file of several MCU
    rows, and one whose last interval is short."""
    img = texture(61, 45, 11)
    for blocks in (1, 4):
        data = jpeg_bytes(img, quality=70, restart_marker_blocks=blocks)
        assert data.count(b"\xff\xd0") >= 1
        assert_decodes_as_pillow(data, tmp_path / f"r{blocks}.jpg")


def _sof(data):
    """The offset of the frame header's marker."""
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        at = data.find(marker)
        if at >= 0:
            return at
    raise AssertionError("no SOF")


def _patched(data, marker=None, precision=None, sampling=None):
    out = bytearray(data)
    at = _sof(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    if sampling is not None:
        out[at + 11] = sampling  # the first component's h << 4 | v
    return bytes(out)


def _drop_scans(data, keep):
    """A progressive file cut after its first `keep` scans, then EOI."""
    starts, at = [], data.find(b"\xff\xda")
    while at >= 0:
        starts.append(at)
        at = data.find(b"\xff\xda", at + 2)
    assert len(starts) > keep
    return data[:starts[keep]] + b"\xff\xd9"


# a cut file ends inside a scan's data or inside a marker segment
TRUNCATED = "ended early|restart|truncated|unknown"


def _refused():
    img = texture(16, 16, 5)
    base = jpeg_bytes(img, quality=75, subsampling=1)
    prog = jpeg_bytes(texture(40, 48, 6), quality=75, progressive=True)
    big = jpeg_bytes(texture(64, 96, 7), quality=90)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    return {
        "arithmetic": (_patched(base, marker=0xC9), "arithmetic"),
        "lossless": (_patched(base, marker=0xC3), "lossless"),
        "12bit": (_patched(base, marker=0xC1, precision=12), "12-bit"),
        "hierarchical": (_patched(base, marker=0xC5), "hierarchical"),
        "cmyk": (cmyk.getvalue(), "CMYK"),
        "440": (_patched(base, sampling=0x12), "4:4:0"),
        "incomplete_progressive": (_drop_scans(prog, 3), "unknown"),
        "truncated": (big[:len(big) * 3 // 4], TRUNCATED),
        "truncated_progressive": (prog[:len(prog) * 2 // 3], TRUNCATED),
        "not_an_image": (b"GIF89a" + bytes(40), "neither a JPEG nor a PNG"),
    }


REFUSED = _refused()


@pytest.mark.parametrize("kind", list(REFUSED))
def test_unsupported_kinds_raise_naming_the_file(kind, tmp_path):
    data, match = REFUSED[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as e:
        image_io.read_image_rgb(path)
    assert str(path) in str(e.value)


def test_incomplete_progressive_is_one_pillow_smooths():
    """The refused progressive file is one Pillow reads (with libjpeg's
    block smoothing, which the port does not copy)."""
    data, _ = REFUSED["incomplete_progressive"]
    assert pillow_rgb(data).shape == (40, 48, 3)


def test_read_image_sniffs_content(tmp_path):
    """read_image_rgb reads a JPEG named .png and a PNG named .jpg by
    their bytes, as Image.open does."""
    img = texture(30, 41, 8)
    jpg = jpeg_bytes(img, quality=80)
    (tmp_path / "a.png").write_bytes(jpg)
    np.testing.assert_array_equal(image_io.read_image_rgb(tmp_path / "a.png"),
                                  pillow_rgb(jpg))
    image_io.write_png(tmp_path / "b.jpg", img)
    np.testing.assert_array_equal(image_io.read_image_rgb(tmp_path / "b.jpg"),
                                  img)
    np.testing.assert_array_equal(image_io.decode_image(jpg),
                                  pillow_rgb(jpg))


def test_idct_range_limit_wraps_as_libjpeg():
    """The post-IDCT clamp is libjpeg's table read at x & 1023: x + 128 in
    [-128, 127], 255 up to 383, 0 from -384 down to -512 and beyond 511
    (where the mask wraps)."""
    lim = jpeg._IDCT_LIMIT
    for v, want in ((-128, 0), (0, 128), (127, 255), (128, 255), (383, 255),
                    (384, 255), (511, 255), (512, 0), (-129, 0), (-384, 0),
                    (-385, 0), (-512, 0), (-513, 255), (1023, 127)):
        assert lim[v & 1023] == want, v


# --- the card's fixtures ---


def rgb_sha256(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8)
                          .tobytes()).hexdigest()


def write_fixtures(directory=FIXTURES):
    """Writes FIXTURE_SPECS with Pillow and the manifest of their Pillow
    decodes."""
    directory.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for i, (name, ((h, w), gray, options)) in enumerate(
            sorted(FIXTURE_SPECS.items())):
        img = texture(h, w, 100 + i)
        data = jpeg_bytes(img, mode="L" if gray else None, **options)
        (directory / name).write_bytes(data)
        rgb = pillow_rgb(data)
        manifest[name] = {"sha256": rgb_sha256(rgb), "shape": list(rgb.shape),
                          "options": {k: v for k, v in options.items()},
                          "gray": gray}
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


@pytest.mark.parametrize("name", sorted(FIXTURE_SPECS))
def test_fixture_manifest_holds_pillow(name):
    manifest = json.loads(MANIFEST.read_text())
    assert sorted(manifest) == sorted(FIXTURE_SPECS)
    data = (FIXTURES / name).read_bytes()
    rgb = pillow_rgb(data)
    assert manifest[name]["sha256"] == rgb_sha256(rgb)
    assert manifest[name]["shape"] == list(rgb.shape)
    (h, w), gray, options = FIXTURE_SPECS[name]
    assert rgb.shape == (h, w, 3)
    if options.get("progressive"):
        assert b"\xff\xc2" in data
    if "restart_marker_blocks" in options:
        assert b"\xff\xdd" in data
    got = image_io.read_image_rgb(FIXTURES / name)
    assert rgb_sha256(got) == manifest[name]["sha256"]


def test_fixtures_are_small():
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total <= FIXTURE_BYTES_MAX, total


if __name__ == "__main__":
    import sys

    if "--write-fixtures" in sys.argv:
        write_fixtures()
        print(f"wrote {len(FIXTURE_SPECS)} fixtures and {MANIFEST}")
