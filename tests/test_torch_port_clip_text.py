"""The port's CLIP text tower (diffusiontexturepainting_torch/models/
clip_text.py, weights/loader.py load_text_encoder) against the JAX
package's (models/clip_text.py, weights/loader.py), fp32 on the CPU.

- CLIPTextEncoder loaded from the JAX module's seeded params
  (weights/from_jax.py's text_encoder rules) gives the JAX last hidden
  state within atol 1e-5, at a tiny config and at 77 tokens over 12 layers
  at a narrow width; the port's state_dict goes back to the JAX module's
  own parameter paths.
- The causal mask: a token changed at j moves no output before j, and
  moves the output at j.
- encode_prompt gives the JAX [uncond, cond] (negative first), tiles a
  single negative, refuses any other batch mismatch and string prompts
  (token ids only), and casts to the dtype asked for.
- load_text_encoder reads a JAX-written text_encoder.npz (the JAX
  converter's output) into the port's names, validates it against a module
  (a wrong width raises) and returns None without the file.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.clip_text import (
    CLIPTextEncoder,
    encode_prompt,
)
from diffusiontexturepainting_torch.weights import loader as t_loader
from diffusiontexturepainting_torch.weights.from_jax import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import clip_text as j_clip_text
from diffusiontexturepainting_tpu.weights import loader as j_loader

torch.set_num_threads(2)

ATOL = 1e-5
CONFIGS = {
    "tiny": dict(vocab_size=1000, max_length=16, hidden_size=64,
                 intermediate_size=128, num_layers=2, num_heads=4),
    "77x12": dict(vocab_size=500, hidden_size=48, intermediate_size=96,
                  num_layers=12, num_heads=4),
}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX module, its seeded params as numpy, the port module loaded from
    them, the port config)."""
    kw = CONFIGS[name]
    jm = j_clip_text.CLIPTextEncoder(j_config.CLIPTextConfig(**kw))
    cfg = t_config.CLIPTextConfig(**kw)
    init = jax.jit(jm.init)
    params = init(jax.random.PRNGKey(0),
                  jnp.zeros((1, cfg.max_length), jnp.int32))["params"]
    # biases and norms off their init values, so each is tested
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32)
              * 0.05 for v in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    pm = CLIPTextEncoder(cfg).eval()
    pm.load_state_dict(state_dict_from_jax("text_encoder", params),
                       strict=True)
    return jm, params, pm, cfg


def ids(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, cfg.vocab_size, (batch, cfg.max_length))
    out[:, 0] = min(cfg.bos_token_id, cfg.vocab_size - 1)
    return out.astype(np.int32)


def jax_apply(jm, params):
    return jax.jit(lambda p, x: jm.apply({"params": p}, x))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_text_encoder_matches_jax(name):
    jm, params, pm, cfg = pair(name)
    x = ids(cfg, 3, 2)
    want = np.asarray(jax_apply(jm, params)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_goes_back_to_the_jax_paths(name):
    jm, params, pm, cfg = pair(name)
    back = flat(jax_tree_from_state_dict("text_encoder", pm.state_dict()))
    want = flat(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("j", [1, 7, 15])
def test_causal_mask(j):
    _, _, pm, cfg = pair("tiny")
    x = ids(cfg, 1, 3)
    y = x.copy()
    y[0, j] = (y[0, j] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, b = pm(torch.from_numpy(x)), pm(torch.from_numpy(y))
    assert torch.equal(a[:, :j], b[:, :j])
    assert not torch.equal(a[:, j], b[:, j])


@pytest.mark.parametrize("batch,neg", [(2, 1), (2, 2), (1, 1)])
def test_encode_prompt_matches_jax(batch, neg):
    jm, params, pm, cfg = pair("tiny")
    p, n = ids(cfg, batch, 4), ids(cfg, neg, 5)
    apply = jax_apply(jm, params)
    want = np.asarray(j_clip_text.encode_prompt(apply, params, p, n,
                                                dtype=jnp.float32))
    got = encode_prompt(pm, p, n, dtype=torch.float32)
    assert got.shape == (2 * batch, cfg.max_length, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # negative first, the single negative tiled
    with torch.no_grad():
        np.testing.assert_array_equal(got[batch:].numpy(),
                                      pm(torch.from_numpy(p)).numpy())
        np.testing.assert_array_equal(
            got[:batch].numpy(),
            pm(torch.from_numpy(n)).expand(batch, -1, -1).numpy())


def test_encode_prompt_casts_to_bf16_by_default():
    _, _, pm, cfg = pair("tiny")
    p = ids(cfg, 2, 6)
    got = encode_prompt(pm, p, p[:1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        encode_prompt(pm, p, p[:1], dtype=torch.float32)
        .to(torch.bfloat16).float().numpy())


def test_encode_prompt_refuses_a_batch_mismatch():
    jm, params, pm, cfg = pair("tiny")
    p, n = ids(cfg, 3, 7), ids(cfg, 2, 8)
    with pytest.raises(ValueError, match="negative_prompt batch 2"):
        encode_prompt(pm, p, n)
    with pytest.raises(ValueError, match="negative_prompt batch 2"):
        j_clip_text.encode_prompt(jax_apply(jm, params), params, p, n)


@pytest.mark.parametrize("prompt", ["mossy stone", ["mossy", "stone"]])
def test_encode_prompt_refuses_strings(prompt):
    _, _, pm, cfg = pair("tiny")
    with pytest.raises(ValueError, match="token ids"):
        encode_prompt(pm, prompt, ids(cfg, 1, 9))
    with pytest.raises(ValueError, match="token ids"):
        encode_prompt(pm, ids(cfg, 1, 9), prompt)


def test_load_text_encoder_reads_a_jax_file(tmp_path):
    jm, params, pm, cfg = pair("tiny")
    j_loader.save_component(str(tmp_path / "text_encoder.npz"), params)
    assert j_loader.load_text_encoder(str(tmp_path)) is not None
    module = CLIPTextEncoder(cfg)
    sd = t_loader.load_text_encoder(str(tmp_path), module=module)
    want = state_dict_from_jax("text_encoder", params)
    assert set(sd) == set(module.state_dict()) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    module.load_state_dict(sd)
    x = torch.from_numpy(ids(cfg, 2, 10))
    with torch.no_grad():
        assert torch.equal(module(x), pm(x))


def test_load_text_encoder_validates_and_may_find_nothing(tmp_path):
    _, params, _, cfg = pair("tiny")
    assert t_loader.load_text_encoder(str(tmp_path)) is None
    j_loader.save_component(str(tmp_path / "text_encoder.npz"), params)
    wide = CLIPTextEncoder(t_config.CLIPTextConfig(
        **{**CONFIGS["tiny"], "hidden_size": 32, "intermediate_size": 64}))
    with pytest.raises(ValueError, match="text_encoder"):
        t_loader.load_text_encoder(str(tmp_path), module=wide)
    deep = CLIPTextEncoder(t_config.CLIPTextConfig(
        **{**CONFIGS["tiny"], "num_layers": 3}))
    with pytest.raises(ValueError, match="missing"):
        t_loader.load_text_encoder(str(tmp_path), module=deep)
