"""Full-size parity of the port against the JAX package through both
converters, fp32 on the CPU: one seeded SD-1.5-width UNet and VAE written
as diffusers-named state_dicts (chip_smoke.py's writers, weights from
weights/random_init.py's seeded draws), converted by each package's
converter and loaded into each package's modules; then one UNet forward
(batch 3, 32^2 latents) and one VAE encode (256^2) and decode (32^2
latents), port against JAX, within atol = rtol = 1e-3.

The `sd15` cases are `slow` (about 3.4 GB of float32 a UNet copy, several
copies at once): python -m pytest -m slow tests/test_torch_port_full_size.py
on a host with about 32 GB free. The same bodies run in tier 1 at a narrow
width with the SD-1.5 depths (the `narrow` cases).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.weights import convert as t_conv
from diffusiontexturepainting_torch.weights.random_init import (
    random_state_dict)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.weights import convert as j_conv

torch.set_num_threads(4)

ATOL = RTOL = 1e-3
WIDTHS = {
    "narrow": dict(unet=dict(block_out_channels=(32, 32, 64, 64),
                             cross_attention_dim=32, num_attention_heads=2,
                             norm_num_groups=8),
                   vae=dict(block_out_channels=(16, 16, 32, 32),
                            norm_num_groups=8)),
    "sd15": dict(unet={}, vae={}),
}
CASES = [pytest.param("narrow"),
         pytest.param("sd15", marks=pytest.mark.slow)]


def configs(width):
    w = WIDTHS[width]
    return ((t_config.UNetConfig(**w["unet"]),
             j_config.UNetConfig(**w["unet"])),
            (t_config.VAEConfig(**w["vae"]), j_config.VAEConfig(**w["vae"])))


def seeded(module, seed):
    """weights/random_init.py's draws, biases and norms moved off their
    constants so they are tested too."""
    sd = random_state_dict(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for k, v in sd.items():
        if v.dim() == 1:
            v.add_(torch.randn(v.shape, generator=gen) * 0.1)
    return sd


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("width", CASES)
def test_unet_forward_through_both_converters(width):
    (tcfg, jcfg), _ = configs(width)
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k in dataclasses.asdict(tcfg)}
    module = UNet2DCondition(tcfg).eval()
    files = cs.torch_layout(seeded(module, 0))
    module.load_state_dict(t_conv.convert_unet(files))
    params = j_conv.convert_unet({k: v.numpy() for k, v in files.items()})
    del files
    sample = rand((3, 32, 32, 9), 1)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    ctx = rand((3, 14, tcfg.cross_attention_dim), 2)
    want = j_unet.UNet2DCondition(jcfg).apply(
        {"params": params}, jnp.asarray(sample), jnp.asarray(t),
        jnp.asarray(ctx))
    del params
    with torch.no_grad():
        got = module(torch.from_numpy(sample), torch.from_numpy(t),
                     torch.from_numpy(ctx))
    assert got.shape == (3, 32, 32, 4)
    assert_close(got, want)


@pytest.mark.parametrize("width", CASES)
def test_vae_encode_decode_through_both_converters(width):
    _, (tcfg, jcfg) = configs(width)
    enc, dec = VAEEncoder(tcfg).eval(), VAEDecoder(tcfg).eval()
    files = cs.autoencoder_kl(seeded(enc, 3), seeded(dec, 4),
                              old_attention=True)
    enc.load_state_dict(t_conv.convert_vae_encoder(files))
    dec.load_state_dict(t_conv.convert_vae_decoder(files))
    np_files = {k: v.numpy() for k, v in files.items()}
    pe, pd = (j_conv.convert_vae_encoder(np_files),
              j_conv.convert_vae_decoder(np_files))
    img, z = rand((1, 256, 256, 3), 5, 0.5), rand((1, 32, 32, 4), 6)
    want_e = j_vae.VAEEncoder(jcfg).apply({"params": pe}, jnp.asarray(img))
    want_d = j_vae.VAEDecoder(jcfg).apply({"params": pd}, jnp.asarray(z))
    with torch.no_grad():
        got_e = enc(torch.from_numpy(img))
        got_d = dec(torch.from_numpy(z))
    assert got_e.shape == (1, 32, 32, 8) and got_d.shape == (1, 256, 256, 3)
    assert_close(got_e, want_e)
    assert_close(got_d, want_d)
