"""The port's models against the JAX package's Flax modules.

Both sides get the same weights: the JAX module's seeded init, carried into
the port through weights/from_jax.py state_dict_from_jax (strict load, so
every parameter name must map). Tiny configs, fp32, fused paths off; the
port's wrappers run their plain versions on the CPU.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models import layers as t_layers
from diffusiontexturepainting_torch.models import patch_encoder as t_pe
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.ops.conv3x3 import fold_upsample_weights
from diffusiontexturepainting_torch.weights.from_jax import state_dict_from_jax
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import layers as j_layers
from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.weights import convert

torch.set_num_threads(2)

# fp32 both sides; the tolerance covers fp32 accumulation-order differences
# through a few dozen layers of random-weight networks.
ATOL = RTOL = 2e-4


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def jax_init(module, *args, seed=0, **kwargs):
    """Seeded Flax init (one jitted program) -> tree of numpy arrays."""
    init = jax.jit(functools.partial(module.init, **kwargs))
    params = init(jax.random.PRNGKey(seed), *args)["params"]
    return jax.tree_util.tree_map(np.array, jax.device_get(params))


def jax_paths(module, *args, **kwargs):
    """Parameter paths of a Flax module, from shapes only (no compute)."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)["params"]
    return set(flat(jax.tree_util.tree_map(lambda s: np.zeros(()), shapes)))


def port_with(module, component, tree):
    """Load a JAX tree into a port module (strict names), ready to run."""
    module.load_state_dict(state_dict_from_jax(component, tree), strict=True)
    return module.eval()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cin,cout,temb", [(32, 64, True), (64, 64, False)])
def test_resnet_block_matches(cin, cout, temb):
    x = rand((2, 8, 8, cin), 0)
    t = rand((2, 128), 1) if temb else None
    jm = j_layers.ResnetBlock(cout, 8, eps=1e-5 if temb else 1e-6)
    args = (jnp.asarray(x),) + ((jnp.asarray(t),) if temb else ())
    tree = jax_init(jm, *args)
    pm = port_with(t_layers.ResnetBlock(cin, cout, 8,
                                        temb_dim=128 if temb else None,
                                        eps=1e-5 if temb else 1e-6),
                   "unet", tree)
    want = jm.apply({"params": tree}, *args)
    got = pm(torch.from_numpy(x),
             torch.from_numpy(t) if temb else None)
    assert_close(got, want)


def test_transformer2d_matches():
    x, ctx = rand((2, 8, 8, 64), 2), rand((2, 14, 32), 3)
    jm = j_layers.Transformer2D(2, 32, kv_dim=32, num_groups=8)
    tree = jax_init(jm, jnp.asarray(x), jnp.asarray(ctx))
    pm = port_with(t_layers.Transformer2D(64, 2, 32, kv_dim=32,
                                          num_groups=8), "unet", tree)
    assert_close(pm(torch.from_numpy(x), torch.from_numpy(ctx)),
                 jm.apply({"params": tree}, jnp.asarray(x),
                          jnp.asarray(ctx)))


def test_sample_latents_with_explicit_noise():
    from diffusiontexturepainting_torch.models.vae import (
        latent_mode, sample_latents)

    moments = rand((2, 4, 4, 8), 8, 3.0)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
    want = j_vae.sample_latents(jnp.asarray(moments), key)
    got = sample_latents(torch.from_numpy(moments), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        latent_mode(torch.from_numpy(moments)).numpy(),
        np.asarray(j_vae.latent_mode(jnp.asarray(moments))))


def test_tiny_patch_encoder_and_brush_encode_match():
    cfg = j_config.tiny_patch_encoder_config()
    jm = j_pe.ConditionPatchEncoder(cfg)
    patches = rand((1, cfg.total_patches, 32, 32, 3), 9)
    tree = jax_init(jm, jnp.asarray(patches), return_uncond_vector=True)
    pm = port_with(t_pe.ConditionPatchEncoder(
        t_config.tiny_patch_encoder_config()), "patch_encoder", tree)
    want_cond, want_uncond = jm.apply({"params": tree}, jnp.asarray(patches),
                                      return_uncond_vector=True)
    got_cond, got_uncond = pm(torch.from_numpy(patches))
    assert_close(got_cond, want_cond)
    np.testing.assert_array_equal(got_uncond.detach().numpy(),
                                  np.asarray(want_uncond))
    # the full brush encode: bicubic resize 48 -> 32, normalize, pyramid
    brush = np.random.default_rng(10).random((1, 48, 48, 3)).astype(
        np.float32)
    want, _ = j_pe.encode_brush_image(jm, tree, jnp.asarray(brush))
    got, _ = t_pe.encode_brush_image(pm, torch.from_numpy(brush))
    assert_close(got, want)


@pytest.mark.parametrize("component", ["unet", "vae_encoder", "vae_decoder",
                                       "patch_encoder"])
def test_weight_round_trip_through_convert(component):
    """port state_dict, in diffusers' layout -> weights/convert.py -> JAX
    tree -> from_jax: the same tensors under the same names; and the
    converted tree has the JAX module's own parameter paths. The port's
    convs are (kH, kW, Cin, Cout), diffusers' (Cout, Cin, kH, kW)."""
    t, j = t_config, j_config
    if component == "unet":
        module = UNet2DCondition(t.tiny_unet_config())
        want_paths = jax_paths(j_unet.UNet2DCondition(j.tiny_unet_config()),
                               jnp.zeros((1, 8, 8, 9)), jnp.float32(0.0),
                               jnp.zeros((1, 14, 32)))
        conv = lambda sd: convert.convert_unet(sd, 1, 4)
    elif component == "vae_encoder":
        module = VAEEncoder(t.tiny_vae_config())
        want_paths = jax_paths(j_vae.VAEEncoder(j.tiny_vae_config()),
                               jnp.zeros((1, 32, 32, 3)))
        conv = lambda sd: convert.convert_vae_encoder(sd, 1, 4)
    elif component == "vae_decoder":
        module = VAEDecoder(t.tiny_vae_config())
        want_paths = jax_paths(j_vae.VAEDecoder(j.tiny_vae_config()),
                               jnp.zeros((1, 4, 4, 4)))
        conv = lambda sd: convert.convert_vae_decoder(sd, 1, 4)
    else:
        module = t_pe.ConditionPatchEncoder(t.tiny_patch_encoder_config())
        want_paths = jax_paths(
            j_pe.ConditionPatchEncoder(j.tiny_patch_encoder_config()),
            jnp.zeros((1, 14, 32, 32, 3)), return_uncond_vector=True)
        conv = lambda sd: convert.convert_patch_encoder(sd, 1, 2)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen)
          for k, v in module.state_dict().items()}
    diffusers = {k: (v.permute(3, 2, 0, 1) if v.dim() == 4 else v).numpy()
                 for k, v in sd.items()}
    tree = conv(diffusers)
    back = state_dict_from_jax(component, tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(),
                                      err_msg=k)
    got_paths = set(flat(tree))
    if component == "patch_encoder":
        # convert.py names the GELU feed-forward's first Dense
        # ff/net_0/proj (diffusers' GELU.proj); the JAX module declares it
        # as ff/net_0. from_jax reads both spellings.
        got_paths = {p.replace("ff/net_0/proj/", "ff/net_0/")
                     for p in got_paths}
    assert got_paths == want_paths


def test_upsample_taps_follow_loaded_weights():
    """The K4 taps are refolded by every load_state_dict, so they never
    hold the weights of before the load."""
    up = t_layers.Upsample(16)
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
          for k, v in up.state_dict().items()}
    assert set(sd) == {"conv.weight", "conv.bias"}
    up.load_state_dict(sd)
    torch.testing.assert_close(up.taps, fold_upsample_weights(sd["conv.weight"]),
                               rtol=0, atol=0)
