"""The whole stamp in the slotted configuration (fused_unet_attn, kernel K13
on CUDA) against the JAX package's stamp program at 128^2 (the tiny UNet's
level 0 then has 256 tokens, a length the slotted kernel takes), 20 DDIM
steps, fp32, same weights and draws on both sides; the JAX slotted branch
forced as in test_torch_port_slotted.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from tests.test_torch_port_modules import port_with
from tests.test_torch_port_slotted import (  # noqa: F401 (a fixture)
    _unet_cfg,
    jax_slotted,
    seeded_tree,
)

torch.set_num_threads(2)

RES, STEPS, SCALE = 128, 20, 0.18215


def _draws(key, counter):
    """The JAX stamp program's own draws (pipeline/inpaint.py:158-193)."""
    lat = RES // 8
    rng = jax.random.fold_in(key, counter)
    _, enc_rng, lat_rng, _ = jax.random.split(rng, 4)
    enc = jax.random.normal(enc_rng, (2, lat, lat, 4), jnp.float32)
    init = jax.random.normal(lat_rng, (1, lat, lat, 4), jnp.float32)
    return np.array(enc), np.array(init)


def test_slotted_stamp_matches_jax(jax_slotted):
    """u8 in and out: within 1 level everywhere and at least 99% of pixels
    exact, as test_torch_port_stamp.py holds the module path."""
    jcfg, vcfg = _unet_cfg(j_config), j_config.tiny_vae_config()
    ju = j_unet.UNet2DCondition(jcfg)
    lat = RES // 8
    params = {
        "unet": seeded_tree(ju, jnp.zeros((1, lat, lat, 9)),
                            jnp.float32(0.0), jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": seeded_tree(j_vae.VAEEncoder(vcfg),
                                   jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": seeded_tree(j_vae.VAEDecoder(vcfg),
                                   jnp.zeros((1, lat, lat, 4)), seed=3),
    }
    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: j_vae.fused_encode(p, x, vcfg,
                                                         jnp.float32),
        vae_decode_apply=lambda p, z: j_vae.fused_decode(p, z, vcfg,
                                                         jnp.float32),
        params=None, vae_scaling=SCALE)
    jax_stamp = jax.jit(j_inpaint.make_stamp_fn(models, "DDIM", STEPS))
    tv = t_config.tiny_vae_config()
    port_stamp = t_inpaint.make_stamp_fn(
        port_with(UNet2DCondition(_unet_cfg(t_config)), "unet",
                  params["unet"]),
        port_with(VAEEncoder(tv, fused=True), "vae_encoder",
                  params["vae_encoder"]),
        port_with(VAEDecoder(tv, fused=True), "vae_decoder",
                  params["vae_decoder"]),
        STEPS, SCALE)

    rng = np.random.default_rng(0)
    canvas = np.zeros((1, RES, RES, 4), np.uint8)
    canvas[:, :40, :, :3] = rng.integers(0, 256, (1, 40, RES, 3))
    canvas[:, :40, :, 3] = 255
    canvas[:, 80:100, 60:120, :3] = 200
    canvas[:, 80:100, 60:120, 3] = 255
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    key, counter = jax.random.PRNGKey(42), 7
    s = dict(cfg=2.0, tg=1.0, tg_steps=STEPS, pad=150)
    want = jax_stamp(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), key, np.uint32(counter), np.float32(s["cfg"]),
        np.float32(s["tg"]), np.int32(s["tg_steps"]), np.int32(s["pad"]))
    assert jax_slotted  # the JAX stamp took the slotted branch
    enc, init = _draws(key, counter)
    got = port_stamp(
        torch.from_numpy(canvas), torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), s["cfg"], s["tg"],
        s["tg_steps"], s["pad"])
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (RES, RES, 3)
        assert g.dtype == w.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.99
