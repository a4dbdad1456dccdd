"""The port's fused module legs against the JAX package's: ResnetBlock
(fused=True), BasicTransformerBlock(ff_fused=True), Transformer2D
(gn_folded=True); and one state_dict serving both configurations.

Both sides get the same weights (the JAX module's seeded init through
state_dict_from_jax). fp32; the JAX fused legs run their XLA references on
the CPU (the Pallas kernels only on a TPU), the port's its plain versions.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core.config import (
    PipelineConfig,
    safe_twin_config,
)
from diffusiontexturepainting_torch.models import layers as t_layers
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_tpu.models import layers as j_layers
from tests.test_torch_port_modules import (
    assert_close,
    jax_init,
    port_with,
    rand,
)

torch.set_num_threads(2)

@pytest.mark.parametrize("cin,cskip,cout,temb", [
    (32, 0, 64, True),     # down path: new width, 1x1 shortcut
    (64, 0, 64, True),     # mid: identity residual
    (64, 32, 32, True),    # up path: skip split, split 1x1 shortcut
    (64, 0, 64, False),    # no time embedding (the VAE's kind)
])
def test_fused_resnet_block_matches_jax(cin, cskip, cout, temb):
    """Fused leg, with return_stats: the output and its (sum, sumsq)."""
    x = rand((2, 8, 8, cin), 0)
    skip = rand((2, 8, 8, cskip), 1) if cskip else None
    t = rand((2, 128), 2) if temb else None
    jm = j_layers.ResnetBlock(cout, 8, use_temb=temb, fused=True)
    jt = jnp.asarray(t) if temb else None
    js = jnp.asarray(skip) if cskip else None
    tree = jax_init(jm, jnp.asarray(x), jt, skip=js)
    want, want_st = jm.apply({"params": tree}, jnp.asarray(x), jt,
                             return_stats=True, skip=js)
    pm = port_with(t_layers.ResnetBlock(cin + cskip, cout, 8,
                                        temb_dim=128 if temb else None,
                                        fused=True), "unet", tree)
    got, got_st = pm(torch.from_numpy(x),
                     torch.from_numpy(t) if temb else None,
                     skip=torch.from_numpy(skip) if cskip else None,
                     return_stats=True)
    assert_close(got, want)
    np.testing.assert_allclose(got_st.detach().numpy(),
                               np.asarray(want_st)[:, :2],
                               rtol=2e-4, atol=2e-2)
    # the module leg of the same weights gives the same block
    pm.fused = False
    assert_close(pm(torch.from_numpy(x),
                    torch.from_numpy(t) if temb else None,
                    skip=torch.from_numpy(skip) if cskip else None), want)


def test_fused_transformer_block_matches_jax():
    """The feed-forward and its residual as one op (K3's plain version)."""
    x, ctx = rand((2, 16, 64), 3), rand((2, 14, 32), 4)
    jm = j_layers.BasicTransformerBlock(2, 32, kv_dim=32, ff_fused=True)
    tree = jax_init(jm, jnp.asarray(x), jnp.asarray(ctx))
    pm = port_with(t_layers.BasicTransformerBlock(64, 2, 32, kv_dim=32,
                                                  ff_fused=True),
                   "unet", tree)
    assert_close(pm(torch.from_numpy(x), torch.from_numpy(ctx)),
                 jm.apply({"params": tree}, jnp.asarray(x),
                          jnp.asarray(ctx)))


@pytest.mark.parametrize("chained", [False, True])
def test_folded_transformer2d_matches_jax(chained):
    """GroupNorm folded into proj_in: from one statistics pass over x, or
    chained from the preceding resnet's statistics (in_stats)."""
    x, ctx = rand((2, 8, 8, 64), 5, 2.0) + 0.3, rand((2, 14, 32), 6)
    jm = j_layers.Transformer2D(2, 32, kv_dim=32, num_groups=8,
                                ff_fused=True, gn_folded=True)
    tree = jax_init(jm, jnp.asarray(x), jnp.asarray(ctx))
    xt = torch.from_numpy(x)
    in_stats = None
    if chained:
        from diffusiontexturepainting_tpu.ops.gn_conv_stream import stats_of

        in_stats = stats_of(jnp.asarray(x))
    want = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(ctx),
                    in_stats=in_stats)
    pm = port_with(t_layers.Transformer2D(64, 2, 32, kv_dim=32, num_groups=8,
                                          ff_fused=True, gn_folded=True),
                   "unet", tree)
    st = (torch.from_numpy(np.array(in_stats)[:, :2]) if chained
          else None)
    assert_close(pm(xt, torch.from_numpy(ctx), in_stats=st), want)


def test_one_state_dict_serves_both_configurations():
    """The default (fused) and the safe-twin models load one state_dict
    (strict: the parameter names are the same), and their stamps agree
    (fp32 on the CPU: u8 within 1 level, at least 99% exact)."""
    fused = TorchConditionalInpainter(64, device="cpu", tiny=True)
    assert all(getattr(fused.config, f.name) for f in
               dataclasses.fields(PipelineConfig) if f.name.startswith(
                   "fused"))
    assert fused.unet.cfg.fused_resnet and fused.vae_decoder.fused
    twin = TorchConditionalInpainter(64, config=safe_twin_config(),
                                     device="cpu",
                                     tiny=True, weights=fused.state_dicts())
    assert not twin.unet.cfg.fused_resnet and not twin.vae_encoder.fused
    for name, sd in fused.state_dicts().items():
        other = twin.state_dicts()[name]
        assert sd.keys() == other.keys()
        assert all(torch.equal(sd[k], other[k]) for k in sd)
    canvas = np.zeros((64, 64, 4), np.uint8)
    canvas[:16, :, 3] = 255
    canvas[:16, :, :3] = 64
    a = fused.generate_u8(canvas, steps=4, tg_steps=4).astype(int)
    b = twin.generate_u8(canvas, steps=4, tg_steps=4).astype(int)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
