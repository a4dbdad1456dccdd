"""The port's own wire codec, image helpers and configuration against the
JAX package's framework-free counterparts (server_io, native_io,
model_base, core/config): byte for byte and value for value."""

import dataclasses

import numpy as np
import pytest

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.serving import model_base as t_base
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.serving import model_base as j_base
from diffusiontexturepainting_tpu.serving import native_io, server_io

SETTINGS = [
    dict(steps=20, width=256, context_pad=150, cfg_weight=2.0, tg_weight=1.0,
         tg_steps=20),
    dict(steps=4, width=512, context_pad=9, cfg_weight=3.3, tg_weight=0.7,
         tg_steps=3),
    {},  # the encoder's defaults
]


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("kind", ["NEW_BRUSH_IMAGE", "NEW_STAMP"])
@pytest.mark.parametrize("settings", SETTINGS)
def test_request_codec_matches_server_io(kind, settings):
    image = _image((24, 40, 4) if kind == "NEW_STAMP" else (30, 20, 3), 0)
    want = (server_io.encode_request_type(server_io.RequestType[kind])
            + server_io.encode_inference_settings(**settings)
            + server_io.image_to_binary(image))
    got = wire.encode_request(wire.RequestType[kind], image, **settings)
    assert got == want
    t_kind, t_settings, t_image = wire.decode_request(want)
    j_meta, j_settings, j_image = native_io.decode_request(want)
    assert t_kind == j_meta["type"] == server_io.RequestType[kind].value
    assert t_settings == j_settings
    np.testing.assert_array_equal(t_image, j_image)
    np.testing.assert_array_equal(t_image, image)


@pytest.mark.parametrize("kind", ["RETURN_PREVIEW", "RETURN_STAMP"])
def test_response_codec_matches_server_io(kind):
    image = _image((32, 48, 3), 1)
    want = server_io.encode_generated_response(server_io.RequestType[kind],
                                               image)
    assert wire.encode_response(wire.RequestType[kind], image) == want
    assert native_io.encode_response(server_io.RequestType[kind].value,
                                     image) == want
    t_kind, t_image = wire.decode_response(want)
    j = server_io.decode_response(want)
    assert t_kind == j["type"]
    np.testing.assert_array_equal(t_image, j["image"])


@pytest.mark.parametrize("shape,width", [
    ((300, 400, 3), 256),  # wide brush, downscaled
    ((90, 60, 3), 64),  # tall brush, upscaled
    ((64, 64, 3), 64),  # square at size: cropped only
])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_helpers_match_model_base(shape, width, dtype):
    rng = np.random.default_rng(2)
    if dtype == "uint8":
        image = rng.integers(0, 256, shape, np.uint8)
    else:
        image = rng.random(shape, np.float32)
    got = t_base.crop_resize_square(image, width)
    want = j_base.crop_resize_square(image, width)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_base.ensure_float01(image),
                                  j_base.ensure_float01(image))
    f = rng.random(shape, np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(t_base.float01_to_uint8(f),
                                  j_base.float01_to_uint8(f))


@pytest.mark.parametrize("name", ["UNetConfig", "VAEConfig",
                                  "CLIPVisionConfig", "CLIPTextConfig",
                                  "PatchEncoderConfig",
                                  "PipelineConfig", "tiny_unet_config",
                                  "tiny_vae_config", "tiny_clip_config",
                                  "tiny_patch_encoder_config"])
def test_config_matches_jax_package(name):
    """Every field of the port's configuration has the JAX package's value;
    the one field the port leaves out is vae_scaling (the VAE's own
    scaling_factor serves)."""
    got, want = getattr(t_config, name)(), getattr(j_config, name)()
    fields = {f.name for f in dataclasses.fields(got)}
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if dataclasses.is_dataclass(g):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f
    left_out = {f.name for f in dataclasses.fields(want)} - fields
    assert left_out <= {"vae_scaling"}, left_out
    assert t_config.CLIP_IMAGE_MEAN == j_config.CLIP_IMAGE_MEAN
    assert t_config.CLIP_IMAGE_STD == j_config.CLIP_IMAGE_STD
