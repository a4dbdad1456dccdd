"""The whole stamp: the port's make_stamp_fn against the JAX package's, at
the tiny configs and 20 DDIM steps, u8 canvas in and u8 stamps out.

Both sides get the same weights (the JAX modules' seeded init through
state_dict_from_jax) and the same random draws: the test recomputes the
JAX program's own draws (fold_in of the request counter, then split into
the VAE-sample and initial-latent keys, pipeline/inpaint.py) and hands them
to the port. fp32 on both sides; the u8 outputs truncate, so an fp32
difference can flip a pixel by one level: within 1 level everywhere and at
least 99% of pixels exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from tests.test_torch_port_modules import jax_init, port_with

torch.set_num_threads(2)

RES, STEPS, SCALE = 64, 20, 0.18215


@pytest.fixture(scope="module")
def both_sides():
    ucfg, vcfg = j_config.tiny_unet_config(), j_config.tiny_vae_config()
    ju, je, jd = (j_unet.UNet2DCondition(ucfg), j_vae.VAEEncoder(vcfg),
                  j_vae.VAEDecoder(vcfg))
    ucfg, vcfg = t_config.tiny_unet_config(), t_config.tiny_vae_config()
    lat = RES // 8
    params = {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(je, jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(jd, jnp.zeros((1, lat, lat, 4)), seed=3),
    }
    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: je.apply({"params": p}, x),
        vae_decode_apply=lambda p, z: jd.apply({"params": p}, z),
        params=None, vae_scaling=SCALE)
    port_models = (
        port_with(UNet2DCondition(ucfg), "unet", params["unet"]),
        port_with(VAEEncoder(vcfg), "vae_encoder", params["vae_encoder"]),
        port_with(VAEDecoder(vcfg), "vae_decoder", params["vae_decoder"]))
    return (params, models, port_models,
            jax.jit(j_inpaint.make_stamp_fn(models, "DDIM", STEPS)),
            t_inpaint.make_stamp_fn(*port_models, STEPS, SCALE))


def jax_draws(key, counter):
    """The JAX stamp program's own draws (pipeline/inpaint.py:158-193)."""
    lat = RES // 8
    rng = jax.random.fold_in(key, counter)
    _, enc_rng, lat_rng, _ = jax.random.split(rng, 4)
    enc = jax.random.normal(enc_rng, (2, lat, lat, 4), jnp.float32)
    init = jax.random.normal(lat_rng, (1, lat, lat, 4), jnp.float32)
    return np.array(enc), np.array(init)


def assert_u8_close(got_pair, want_pair):
    """u8 stamps: within 1 level everywhere, at least 99% of pixels exact."""
    for got, want in zip(got_pair, want_pair):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (RES, RES, 3)
        assert got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("settings", [
    dict(cfg=2.0, tg=1.0, tg_steps=20, pad=150),  # the reference default
    dict(cfg=3.5, tg=0.5, tg_steps=7, pad=9),
])
def test_stamp_matches_jax(both_sides, settings):
    params, _, _, jax_stamp, port_stamp = both_sides
    rng = np.random.default_rng(0)
    canvas = np.zeros((1, RES, RES, 4), np.uint8)
    canvas[:, :20, :, :3] = rng.integers(0, 256, (1, 20, RES, 3))
    canvas[:, :20, :, 3] = 255
    canvas[:, 40:50, 30:60, :3] = 200
    canvas[:, 40:50, 30:60, 3] = 255
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    key, counter = jax.random.PRNGKey(42), 7
    s = settings

    raw_j, comp_j = jax_stamp(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), key, np.uint32(counter), np.float32(s["cfg"]),
        np.float32(s["tg"]), np.int32(s["tg_steps"]), np.int32(s["pad"]))
    enc, init = jax_draws(key, counter)
    raw_t, comp_t = port_stamp(
        torch.from_numpy(canvas), torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), s["cfg"], s["tg"],
        s["tg_steps"], s["pad"])

    assert_u8_close((raw_t, comp_t), (raw_j, comp_j))
    # painted pixels come through the composite unchanged (up to u8
    # truncation of x/255*255)
    painted = canvas[0, ..., 3] == 255
    assert np.abs(comp_t.numpy()[painted].astype(int)
                  - canvas[0, ..., :3][painted].astype(int)).max() <= 1


def test_preview_matches_jax(both_sides):
    """The brush preview (the stamp on the quadrant-known canvas built from
    the brush), same draws on both sides, same u8 tolerance as the stamp."""
    params, models, port_models, _, _ = both_sides
    jax_preview = jax.jit(j_inpaint.make_preview_fn(models, "DDIM", STEPS))
    port_preview = t_inpaint.make_preview_fn(*port_models, STEPS, SCALE)
    rng = np.random.default_rng(1)
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    key, counter = jax.random.PRNGKey(5), 0
    want = jax_preview(
        params, jnp.asarray(brush), jnp.asarray(cond), jnp.asarray(uncond),
        key, np.uint32(counter), np.float32(2.0), np.float32(1.0),
        np.int32(STEPS), np.int32(150))
    enc, init = jax_draws(key, counter)
    got = port_preview(
        torch.from_numpy(brush), torch.from_numpy(cond),
        torch.from_numpy(uncond), torch.from_numpy(enc),
        torch.from_numpy(init), 2.0, 1.0, STEPS, 150)
    assert_u8_close(got, want)
