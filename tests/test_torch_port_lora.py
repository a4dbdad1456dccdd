"""The port's LoRA (diffusiontexturepainting_torch/models/lora.py) and its
names in weights/from_jax.py against the JAX package's models/lora.py, at
the tiny configs on the CPU; the count of adapted projections at SD-1.5
width (a UNet built on the meta device, no memory)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models import lora as t_lora
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.weights.from_jax import (
    lora_from_jax,
    lora_to_jax,
    state_dict_from_jax,
)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import lora as j_lora
from diffusiontexturepainting_tpu.models import unet as j_unet
from tests.test_torch_port_modules import jax_init

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def unet_params():
    return jax_init(j_unet.UNet2DCondition(j_config.tiny_unet_config()),
                    jnp.zeros((1, 8, 8, 9)), jnp.float32(0.0),
                    jnp.zeros((1, 14, 32)), seed=1)


@pytest.fixture(scope="module")
def jax_lora(unet_params):
    """JAX factors with both halves non-zero (up drawn too), numpy."""
    lora = j_lora.init_lora_params(unet_params, rank=4, seed=0)
    key = jax.random.PRNGKey(3)
    out = {}
    for name, f in lora.items():
        key, sub = jax.random.split(key)
        out[name] = {"down": np.array(f["down"]),
                     "up": np.array(jax.random.normal(sub, f["up"].shape)
                                    * 0.1)}
    return out


def test_projection_count_at_full_width():
    """attn1/attn2 x to_q, to_k, to_v, to_out.0 of each of the 16
    transformer blocks of SD-1.5: 128 projections."""
    with torch.device("meta"):
        unet = UNet2DCondition(t_config.UNetConfig())
    projs = t_lora.attention_projections(unet)
    assert len(projs) == 128
    assert all(isinstance(p, torch.nn.Linear) for p in projs.values())
    assert sum(n.endswith(".to_out.0") for n in projs) == 32


def test_projection_names_match_jax_paths(unet_params):
    """The port's projections are the JAX _iter_attention_paths, renamed
    both ways."""
    jax_names = {"/".join(p) for p in
                 j_lora._iter_attention_paths(unet_params)}
    port = t_lora.attention_projections(
        UNet2DCondition(t_config.tiny_unet_config()))
    fake = {n: {"down": np.zeros((1, 1), np.float32),
                "up": np.zeros((1, 1), np.float32)} for n in jax_names}
    assert set(lora_from_jax(fake)) == set(port)
    assert set(lora_to_jax(lora_from_jax(fake))) == jax_names


def test_lora_tree_round_trips(jax_lora):
    back = lora_to_jax(lora_from_jax(jax_lora))
    assert set(back) == set(jax_lora)
    for name, f in jax_lora.items():
        for part in ("down", "up"):
            np.testing.assert_array_equal(back[name][part], f[part])


def test_merge_matches_jax(unet_params, jax_lora):
    """W + up @ down on nn.Linear's (out, in) weights equals the JAX
    kernel + down.T @ up.T, transposed; the other weights are left out of
    the merge and the JAX merge leaves them alone too."""
    merged_jax = state_dict_from_jax(
        "unet", jax.tree_util.tree_map(
            np.array, j_lora.merge_lora(unet_params, jax_lora)))
    base = state_dict_from_jax("unet", unet_params)
    got = t_lora.merge_lora(base, lora_from_jax(jax_lora))
    assert len(got) == len(jax_lora)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), merged_jax[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k in set(base) - set(got):
        assert torch.equal(base[k], merged_jax[k]), k


def test_merge_casts_after_the_fp32_sum(unet_params, jax_lora):
    base = state_dict_from_jax("unet", unet_params)
    lora = lora_from_jax(jax_lora)
    fp32 = t_lora.merge_lora(base, lora)
    bf16 = t_lora.merge_lora(base, lora, dtype=torch.bfloat16)
    for k in fp32:
        assert bf16[k].dtype == torch.bfloat16
        assert torch.equal(bf16[k], fp32[k].to(torch.bfloat16))


def test_merge_is_differentiable_in_the_factors(unet_params, jax_lora):
    base = state_dict_from_jax("unet", unet_params)
    lora = {n: {k: v.clone().requires_grad_(True) for k, v in f.items()}
            for n, f in lora_from_jax(jax_lora).items()}
    merged = t_lora.merge_lora(base, lora, scale=0.5)
    gen = torch.Generator().manual_seed(0)
    gs = {k: torch.randn(v.shape, generator=gen) for k, v in merged.items()}
    total = sum((merged[k] * gs[k]).sum() for k in merged)
    total.backward()
    for name, f in lora.items():
        g = gs[f"{name}.weight"]
        torch.testing.assert_close(f["up"].grad,
                                   0.5 * g @ f["down"].detach().T)
        torch.testing.assert_close(f["down"].grad,
                                   0.5 * f["up"].detach().T @ g)


def test_merge_refuses_an_unknown_target():
    with pytest.raises(KeyError, match="not found"):
        t_lora.merge_lora({}, {"nowhere.to_q": {
            "down": torch.zeros(1, 2), "up": torch.zeros(2, 1)}})


def test_init_lora_params(unet_params):
    """down ~ N(0, 1) / rank, up = 0, fp32, in the projections' shapes;
    the same generator seed, the same factors; the count equals the JAX
    package's num_lora_params of its own init."""
    unet = UNet2DCondition(t_config.tiny_unet_config())
    projs = t_lora.attention_projections(unet)
    a = t_lora.init_lora_params(unet, 4, torch.Generator().manual_seed(1))
    b = t_lora.init_lora_params(unet, 4, torch.Generator().manual_seed(1))
    assert set(a) == set(projs)
    downs = []
    for name, f in a.items():
        out_dim, in_dim = projs[name].weight.shape
        assert f["down"].shape == (4, in_dim) and f["up"].shape == (out_dim, 4)
        assert f["down"].dtype == f["up"].dtype == torch.float32
        assert not f["up"].any()
        assert torch.equal(f["down"], b[name]["down"])
        downs.append(f["down"].flatten())
    std = torch.cat(downs).std().item()
    assert abs(std - 0.25) < 0.02, std
    want = j_lora.num_lora_params(
        j_lora.init_lora_params(unet_params, rank=4))
    assert t_lora.num_lora_params(a) == want
