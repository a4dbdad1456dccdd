"""The whole stamp in the default (fused) configuration: the port's
make_stamp_fn over its fused UNet and fused VAE against the JAX package's
stamp program over its fused UNet and fused_encode / fused_decode (the
selection tpu_model.py makes from the default PipelineConfig), at the tiny
configs and 20 DDIM steps, u8 canvas in and u8 stamps out.

Same weights and the same injected random draws on both sides, fp32, as in
test_torch_port_stamp.py: within 1 level everywhere and at least 99% of
pixels exact.
"""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from tests.test_torch_port_modules import jax_init, port_with
from tests.test_torch_port_stamp import assert_u8_close, jax_draws

torch.set_num_threads(2)

RES, STEPS, SCALE = 64, 20, 0.18215


def _fused_unet_cfg(config):
    """The UNet config tpu_model.py / torch_model.py derive from the
    default PipelineConfig."""
    p = config.PipelineConfig()
    return dataclasses.replace(config.tiny_unet_config(),
                               fused_resnet=p.fused_unet_resnet,
                               fused_ff=p.fused_unet_ff,
                               fused_norm=p.fused_unet_norm)


def test_default_config_stamp_matches_jax():
    assert j_config.PipelineConfig().fused_vae_encoder
    assert t_config.PipelineConfig().fused_vae_decoder
    jcfg, vcfg = _fused_unet_cfg(j_config), j_config.tiny_vae_config()
    assert jcfg.fused_resnet and jcfg.fused_ff and jcfg.fused_norm
    ju = j_unet.UNet2DCondition(jcfg)
    lat = RES // 8
    params = {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(j_vae.VAEEncoder(vcfg),
                                jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(j_vae.VAEDecoder(vcfg),
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
        port_with(UNet2DCondition(_fused_unet_cfg(t_config)), "unet",
                  params["unet"]),
        port_with(VAEEncoder(tv, fused=True), "vae_encoder",
                  params["vae_encoder"]),
        port_with(VAEDecoder(tv, fused=True), "vae_decoder",
                  params["vae_decoder"]),
        STEPS, SCALE)

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
    s = dict(cfg=2.0, tg=1.0, tg_steps=20, pad=150)  # the reference default
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
