"""The slotted configuration (fused_unet_attn, kernel K13 on CUDA) against the
JAX package: the tiny fused UNet with fused_attn at 16^2 latents (its level
0 then has 256 tokens, a length the slotted kernel takes), fp32, same
weights on both sides; and the slotted model's state_dict. The whole
stamp is in test_torch_port_slotted_stamp.py.

The JAX package takes its slotted branch only on a TPU backend; here it is
forced on the CPU for Attention alone (its Pallas kernel in interpret
mode, with exp2 evaluated as a TPU evaluates it, as the port does:
test_torch_port_attention.TPUExp2), so every other layer runs the CPU
path it runs in the JAX package's own tests.
"""

import dataclasses
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import layers as j_layers
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.ops import flash_attention as j_fa
from tests.test_torch_port_attention import TPUExp2
from tests.test_torch_port_modules import port_with, rand

torch.set_num_threads(2)

RES = 128


class _SlottedAttentionBackend:
    """Stands in for `jax` in the JAX package's models/layers.py: reports a
    TPU backend to Attention alone, and is jax for everything else."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        caller = sys._getframe(1).f_locals.get("self")
        if isinstance(caller, j_layers.Attention):
            return "tpu"
        return jax.default_backend()


@pytest.fixture
def jax_slotted(monkeypatch):
    """Forces the JAX slotted branch; yields the list of the shapes its
    kernel was called at (traced)."""
    calls = []
    real = j_fa.flash_attention_slotted

    def spy(q, *args, **kwargs):
        calls.append(q.shape)
        return real(q, *args, **kwargs)

    monkeypatch.setattr(j_layers, "jax", _SlottedAttentionBackend())
    monkeypatch.setattr(j_fa, "jnp", TPUExp2())
    monkeypatch.setattr(j_fa, "flash_attention_slotted", spy)
    with pltpu.force_tpu_interpret_mode():
        yield calls


def seeded_tree(module, *args, seed=0):
    """A parameter tree of `module` with flax's initial distributions
    (LeCun-normal kernels, zero biases, unit scales) drawn with numpy: the
    shapes come from jax.eval_shape, so nothing is compiled."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape)
                * fan_in**-0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _unet_cfg(config):
    """The UNet config tpu_model.py / torch_model.py derive from
    slotted_config(): the default fused legs plus fused_attn."""
    p = dataclasses.replace(config.PipelineConfig(), fused_unet_attn=True)
    return dataclasses.replace(config.tiny_unet_config(),
                               fused_resnet=p.fused_unet_resnet,
                               fused_ff=p.fused_unet_ff,
                               fused_norm=p.fused_unet_norm,
                               fused_attn=p.fused_unet_attn)


def test_slotted_config_is_the_default_plus_fused_attn():
    got = t_config.slotted_config()
    assert got.fused_unet_attn and not t_config.PipelineConfig().fused_unet_attn
    assert dataclasses.replace(got, fused_unet_attn=False) \
        == t_config.PipelineConfig()
    assert not t_config.safe_twin_config(got).fused_unet_attn
    assert t_config.pipeline_config("slotted") == got


def test_tiny_slotted_unet_matches_jax(jax_slotted):
    """fp32, 16^2 latents, the module paths' fp32 tolerance."""
    jcfg = _unet_cfg(j_config)
    assert jcfg.fused_attn
    ju = j_unet.UNet2DCondition(jcfg)
    sample, ctx = rand((3, 16, 16, 9), 0), rand((3, 14, 32), 1)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    tree = seeded_tree(ju, jnp.asarray(sample), jnp.asarray(t),
                       jnp.asarray(ctx))
    args = ({"params": tree}, jnp.asarray(sample), jnp.asarray(t),
            jnp.asarray(ctx))
    jax_slotted.clear()  # the shape-only init traced the branch too
    # jitted: the interpret-mode kernel's callbacks deadlock against
    # eager dispatch
    want = np.asarray(jax.jit(ju.apply)(*args))
    # the branch ran: the level-0 self-attentions (1 down, 2 up)
    assert jax_slotted == [(3, 256, 2 * 128)] * 3
    pm = port_with(UNet2DCondition(_unet_cfg(t_config)), "unet", tree)
    got = pm(torch.from_numpy(sample), torch.from_numpy(t),
             torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4,
                               rtol=2e-4)


def test_slotted_model_takes_the_default_state_dict():
    """The slotted buffers derive from the projections and are not saved:
    a slotted model built from the default model's state_dicts has the
    same state_dicts, and serves a 128^2 canvas (the level-0 self-attention
    then slotted) at the model's own resolution."""
    default = TorchConditionalInpainter(RES, device="cpu", tiny=True)
    slotted = TorchConditionalInpainter(RES, config=t_config.slotted_config(),
                                        device="cpu", tiny=True,
                                        weights=default.state_dicts())
    assert slotted.unet.cfg.fused_attn
    for name, sd in default.state_dicts().items():
        got = slotted.state_dicts()[name]
        assert got.keys() == sd.keys(), name
        for k in sd:
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    attn = slotted.unet.down_blocks[0].attentions[0] \
        .transformer_blocks[0].attn1
    assert attn.slotted and "qkv_slotted" not in slotted.unet.state_dict()
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:32, :, 3] = 255
    out = slotted.generate_u8(canvas, steps=2, tg_steps=2)
    assert out.shape == (RES, RES, 3) and out.dtype == np.uint8
