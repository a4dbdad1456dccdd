"""The port's streaming (K8) and head-slotted (K13) attention against the JAX
package: the plain versions against the Pallas kernels in interpret mode,
the routing against the JAX rule at every self-attention of the full-width
stamp, and the slotted Attention module against JAX's slotted branch.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are compared with those on the card (test_torch_port_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models import layers as t_layers
from diffusiontexturepainting_torch.ops import attention as t_attn
from diffusiontexturepainting_torch.weights.from_jax import state_dict_from_jax
from diffusiontexturepainting_tpu.models import layers as j_layers
from diffusiontexturepainting_tpu.ops import attention as j_attn
from diffusiontexturepainting_tpu.ops import flash_attention as j_fa

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _slot(x, heads, hd):
    """(B, L, heads*hd) -> (B, L, heads*128), zero pad lanes."""
    b, l, _ = x.shape
    out = np.zeros((b, l, heads, 128), x.dtype)
    out[..., :hd] = x.reshape(b, l, heads, hd)
    return out.reshape(b, l, heads * 128)


@pytest.mark.parametrize("b,l,heads,hd,bq,bk", [
    (1, 512, 8, 40, 128, 256),   # multi-block in both q and kv
    (1, 384, 2, 64, 256, 128),   # Lk not a multiple of the kv block
    (2, 256, 1, 512, 128, 128),  # fat head (VAE mid style)
])
def test_streaming_plain_matches_pallas(b, l, heads, hd, bq, bk):
    """fp32, the JAX kernel's own test's shapes and tolerance (atol 3e-5,
    rtol 1e-4: the online softmax against the port's row-max softmax, and
    another summation order). The port runs in query blocks of 100 rows,
    so its blocking is exercised too, ragged end included."""
    q, k, v = (_rand((b, l, heads * hd), s) for s in (20, 21, 22))
    with pltpu.force_tpu_interpret_mode():
        want = j_fa.flash_attention_streaming(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
            q_block=bq, kv_block=bk)
    got = t_attn.flash_attention_streaming(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)
    blocked = t_attn.plain_attention_streaming(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        block_bytes=4 * b * heads * l * 100)
    np.testing.assert_allclose(blocked.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


class TPUExp2:
    """Stands in for `jax.numpy` in the JAX package's ops/flash_attention.py
    and is jnp but for exp2 of a bf16 array, which it evaluates as a native
    exp2: what Mosaic emits on a TPU whose libtpu dates from 2025-07-26 on,
    outside forward-compatible mode (jax/_src/pallas/mosaic/lowering.py
    _exp2_lowering_rule). Older TPUs, forward-compatible lowering and XLA
    on the CPU all give exp(x * bf16(ln 2)) in bf16 instead, whose ln 2 is
    0.25% off, so a probability 2^-10 below the row max comes out ~1.7%
    off. The port's K13 runs the native exp2; the comparison with the
    unpatched kernel (the "cpu" case) is the one that assumes neither."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        if x.dtype == jnp.bfloat16:
            return jnp.exp2(x.astype(jnp.float32)).astype(jnp.bfloat16)
        return jnp.exp2(x)


@pytest.mark.parametrize("exp2", ["tpu", "cpu"])
def test_slotted_plain_matches_pallas(monkeypatch, exp2):
    """bf16 at (2, 256, 4 heads, hd 40), the JAX kernel's own test shape.
    Both round at the same points (q pre-scaled to bf16, exp2 of bf16
    logits against the row max, bf16 probabilities, fp32 sums, division
    after P V). With the kernel's exp2 native (TPUExp2), what is left
    is summation order and the output's bf16 rounding: atol 2^-7, two bf16
    ulps at the outputs' magnitude (<= ~0.7). With XLA's CPU exp2 (see
    TPUExp2) the gap measured 4e-3: atol 1e-2. The pad lanes are zero."""
    if exp2 == "tpu":
        monkeypatch.setattr(j_fa, "jnp", TPUExp2())
    b, l, heads, hd = 2, 256, 4, 40
    assert t_attn.slotted_self_attention_fits(l, l, hd)
    assert j_fa.slotted_self_attention_fits(l, l, hd)
    q, k, v = (_slot(_rand((b, l, heads * hd), s), heads, hd)
               for s in (30, 31, 32))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = j_fa.flash_attention_slotted(bf(q), bf(k), bf(v), heads,
                                            scale=hd**-0.5)
    want = np.asarray(want, np.float32)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = t_attn.flash_attention_slotted(tb(q), tb(k), tb(v), heads, hd)
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, heads * 128)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0**-7 if exp2 == "tpu"
                               else 1e-2, rtol=0)
    pad = lambda a: a.reshape(b, l, heads, 128)[..., hd:]
    assert np.all(pad(got) == 0) and np.all(pad(want) == 0)


# --- routing ---


def _self_attention_sites(res):
    """(length, channels, heads) of every self-attention of the full-width
    stamp at `res`: the UNet's transformer levels and mid block, and the
    VAE's mid block."""
    u, v = t_config.UNetConfig(), t_config.VAEConfig()
    lat = res // 8
    sites = [((lat >> i) ** 2, ch, u.num_attention_heads)
             for i, ch in enumerate(u.block_out_channels) if u.attn_down[i]]
    n = len(u.block_out_channels) - 1
    sites.append(((lat >> n) ** 2, u.block_out_channels[-1],
                  u.num_attention_heads))
    sites.append((lat * lat, v.block_out_channels[-1], 1))
    return sites


def _jax_route(monkeypatch, length, channels, heads, dtype):
    """Which kernel the JAX package's attention() picks on a TPU, from a
    call whose kernels are stubbed out (nothing is computed)."""
    called = []

    def stub(name):
        def fn(q, *args, **kwargs):
            called.append(name)
            return q
        return fn

    monkeypatch.setattr(j_fa, "flash_attention", stub("flash"))
    monkeypatch.setattr(j_fa, "flash_attention_streaming", stub("streaming"))
    monkeypatch.setattr(j_attn, "xla_attention", stub("plain"))
    monkeypatch.setattr(j_attn.jax, "default_backend", lambda: "tpu")
    q = jnp.zeros((1, length, channels), dtype)
    j_attn.attention(q, q, q, heads)
    assert len(called) == 1
    return called[0]


@pytest.mark.parametrize("res", [256, 512, 1024])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routing_matches_jax_rule(monkeypatch, res, dtype):
    seen = set()
    for length, channels, heads in _self_attention_sites(res):
        hd = channels // heads
        want = _jax_route(monkeypatch, length, channels, heads,
                          getattr(jnp, dtype))
        got = t_attn.attention_route(length, length, hd,
                                     getattr(torch, dtype))
        assert got == want, (res, dtype, length, hd)
        assert (t_attn.slotted_self_attention_fits(length, length, hd)
                == j_fa.slotted_self_attention_fits(length, length, hd))
        seen.add(got)
    if res == 1024:
        assert "streaming" in seen


def test_streaming_wrapper_runs_plain_on_cpu_only():
    x = torch.zeros(1, 4, 8)
    out = t_attn.flash_attention_streaming(x, x, x, 2)
    assert out.shape == x.shape
    meta = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_attn.flash_attention_streaming(meta, meta, meta, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_attn.flash_attention_slotted(meta, meta, meta, 2, 4)


# --- the slotted Attention module ---


def _attention_pair(heads, hd, qkv_bias, seed=0):
    d = heads * hd
    x = _rand((1, 128, d), seed)
    jm = j_layers.Attention(heads, hd, qkv_bias=qkv_bias, slotted=True,
                            dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    if qkv_bias:  # nonzero biases, so the slotted bias layout is checked
        rng = np.random.default_rng(seed + 1)
        for name in ("to_q", "to_k", "to_v"):
            tree[name]["bias"] = rng.standard_normal(d).astype(np.float32)
    sd = {k.removeprefix("attn1."): t for k, t in
          state_dict_from_jax("unet", {"attn1": tree}).items()}
    pm = t_layers.Attention(d, heads, hd, qkv_bias=qkv_bias, slotted=True)
    pm.load_state_dict(sd, strict=True)
    return x, jm, tree, pm.eval()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_slotted_attention_module_matches_jax(monkeypatch, qkv_bias):
    """The port's slotted leg against JAX's, the branch forced on the CPU as
    tests/test_flash_attention.py forces it (interpret-mode kernel, its
    exp2 native: TPUExp2), same parameters, fp32. Both run
    exp2 on bf16 logits at the same points, so they agree to fp32
    summation order, up to a rare logit that rounds to the other bf16
    neighbour (atol 1e-4). The plain leg differs from both by the bf16
    logits (2e-2, the JAX test's tolerance)."""
    heads, hd = 4, 32
    x, jm, tree, pm = _attention_pair(heads, hd, qkv_bias)
    assert pm.slotted and pm.qkv_slotted.shape == (heads * hd, 3 * heads * 128)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(j_fa, "jnp", TPUExp2())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    plain = t_layers.Attention(heads * hd, heads, hd, qkv_bias=qkv_bias)
    plain.load_state_dict(pm.state_dict(), strict=True)
    np.testing.assert_allclose(plain(torch.from_numpy(x)).detach().numpy(),
                               got, atol=2e-2, rtol=2e-2)


def test_slotted_weights_follow_loads_and_leave_state_dict_alone():
    heads, hd = 2, 24
    _, _, _, pm = _attention_pair(heads, hd, False)
    plain = t_layers.Attention(heads * hd, heads, hd)
    assert pm.state_dict().keys() == plain.state_dict().keys()
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(3))
          for k, v in plain.state_dict().items()}
    pm.load_state_dict(sd)
    w = pm.qkv_slotted.reshape(heads * hd, 3, heads, 128)
    for i, name in enumerate(("to_q", "to_k", "to_v")):
        want = sd[f"{name}.weight"].t().reshape(heads * hd, heads, hd)
        torch.testing.assert_close(w[:, i, :, :hd], want, rtol=0, atol=0)
        assert not w[:, i, :, hd:].any()
    rows = pm.out_slotted.reshape(heads, 128, heads * hd)
    torch.testing.assert_close(
        rows[:, :hd], sd["to_out.0.weight"].t().reshape(heads, hd, -1),
        rtol=0, atol=0)
    assert not rows[:, hd:].any()


def test_slotted_leg_applies_only_where_the_kernel_fits(monkeypatch):
    """Cross-attention, 4-D input and lengths off the 128-row blocks take
    the plain leg; a fitting self-attention takes K13's function."""
    heads, hd = 2, 24
    _, _, _, pm = _attention_pair(heads, hd, False)
    calls = []
    real = t_layers.flash_attention_slotted
    monkeypatch.setattr(t_layers, "flash_attention_slotted",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    d = heads * hd
    pm(torch.zeros(1, 100, d))
    pm(torch.zeros(1, 128, d), torch.zeros(1, 14, d))
    assert not calls
    pm(torch.zeros(2, 256, d))
    assert calls == [(2, 256, heads * 128)]


@pytest.mark.parametrize("name,res,steps,want", [
    ("default", 256, 20, {"flash_attention": 102}),
    ("safe_twin", 256, 4, {"flash_attention": 22}),
    ("default", 1024, 4, {"flash_attention": 40,
                          "flash_attention_streaming": 22}),
    ("slotted", 512, 4, {"flash_attention": 2,
                         "flash_attention_slotted": 40}),
])
def test_attention_launches_per_stamp(name, res, steps, want):
    """chip_smoke.py's launch counts from the configuration: at 1024^2 the
    UNet's five level-0 self-attentions a step and the VAE's two mid-block
    attentions stream (K8), levels 1 and 2 stay resident (K2); the slotted
    configuration at 512^2 takes levels 0 and 1 through K13."""
    import dataclasses
    import types

    import chip_smoke

    cfg = t_config.pipeline_config(name)
    unet = dataclasses.replace(t_config.UNetConfig(),
                               fused_attn=cfg.fused_unet_attn)
    model = types.SimpleNamespace(
        config=cfg, unet=types.SimpleNamespace(cfg=unet),
        vae_encoder=types.SimpleNamespace(cfg=t_config.VAEConfig()),
        dtype=torch.bfloat16)
    assert dict(chip_smoke.attention_launches(model, res, steps)) == want
