"""The port's tiny UNet and VAE against the JAX package's Flax modules
(helpers and tolerance in test_torch_port_modules.py)."""

import jax.numpy as jnp
import numpy as np
import torch

from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from tests.test_torch_port_modules import (
    assert_close,
    jax_init,
    port_with,
    rand,
)

torch.set_num_threads(2)


def test_tiny_unet_matches():
    sample, ctx = rand((3, 16, 16, 9), 4), rand((3, 14, 32), 5)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    jm = j_unet.UNet2DCondition(j_config.tiny_unet_config())
    tree = jax_init(jm, jnp.asarray(sample), jnp.asarray(t),
                    jnp.asarray(ctx))
    pm = port_with(UNet2DCondition(t_config.tiny_unet_config()), "unet",
                   tree)
    want = jm.apply({"params": tree}, jnp.asarray(sample), jnp.asarray(t),
                    jnp.asarray(ctx))
    got = pm(torch.from_numpy(sample), torch.from_numpy(t),
             torch.from_numpy(ctx))
    assert got.shape == (3, 16, 16, 4) and got.dtype == torch.float32
    assert_close(got, want)


def test_tiny_vae_encoder_decoder_match():
    jcfg, tcfg = j_config.tiny_vae_config(), t_config.tiny_vae_config()
    img, z = rand((2, 32, 32, 3), 6), rand((1, 4, 4, 4), 7)
    je, jd = j_vae.VAEEncoder(jcfg), j_vae.VAEDecoder(jcfg)
    te, td = jax_init(je, jnp.asarray(img)), jax_init(jd, jnp.asarray(z))
    pe = port_with(VAEEncoder(tcfg), "vae_encoder", te)
    pd = port_with(VAEDecoder(tcfg), "vae_decoder", td)
    assert_close(pe(torch.from_numpy(img)),
                 je.apply({"params": te}, jnp.asarray(img)))
    assert_close(pd(torch.from_numpy(z)),
                 jd.apply({"params": td}, jnp.asarray(z)))
