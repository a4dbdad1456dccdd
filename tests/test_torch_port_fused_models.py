"""The port's fused models against the JAX package's: the tiny UNet with
fused_resnet / fused_ff / fused_norm, and the tiny VAE's fused_encode /
fused_decode, on the CPU in fp32 with the same weights.

The JAX side runs its fused paths with the XLA references of its kernels
(the Pallas kernels run only on a TPU); the port runs its kernels' plain
versions. The tolerance covers fp32 accumulation-order differences through
a few dozen layers of random-weight networks, as for the module paths.
"""

import dataclasses

import numpy as np

import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
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

FUSED = dict(fused_resnet=True, fused_ff=True, fused_norm=True)


def test_tiny_fused_unet_matches_jax():
    jcfg = dataclasses.replace(j_config.tiny_unet_config(), **FUSED)
    ju = j_unet.UNet2DCondition(jcfg)
    sample, ctx = rand((3, 8, 8, 9), 0), rand((3, 14, 32), 1)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    tree = jax_init(j_unet.UNet2DCondition(j_config.tiny_unet_config()),
                    jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    want = ju.apply({"params": tree}, jnp.asarray(sample), jnp.asarray(t),
                    jnp.asarray(ctx))
    tcfg = dataclasses.replace(t_config.tiny_unet_config(), **FUSED)
    pm = port_with(UNet2DCondition(tcfg), "unet", tree)
    got = pm(torch.from_numpy(sample), torch.from_numpy(t),
             torch.from_numpy(ctx))
    assert_close(got, want)


def test_tiny_fused_encode_matches_jax():
    cfg = j_config.tiny_vae_config()
    img = rand((2, 32, 32, 3), 2)
    tree = jax_init(j_vae.VAEEncoder(cfg), jnp.asarray(img))
    want = j_vae.fused_encode(tree, jnp.asarray(img), cfg, jnp.float32)
    pm = port_with(VAEEncoder(t_config.tiny_vae_config(), fused=True),
                   "vae_encoder", tree)
    assert_close(pm(torch.from_numpy(img)), want)


def test_tiny_fused_decode_matches_jax():
    cfg = j_config.tiny_vae_config()
    z = rand((1, 4, 4, 4), 3)
    tree = jax_init(j_vae.VAEDecoder(cfg), jnp.asarray(z))
    want = j_vae.fused_decode(tree, jnp.asarray(z), cfg, jnp.float32)
    pm = port_with(VAEDecoder(t_config.tiny_vae_config(), fused=True),
                   "vae_decoder", tree)
    assert_close(pm(torch.from_numpy(z)), want)
