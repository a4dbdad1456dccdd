"""The port's three kernel ops (K7 conv3x3, K4 upsample2x_conv3x3, K2 flash
attention) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them, at
shapes their plans accept. The CUDA kernels themselves are compared with
the plain versions on the card (test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.ops import attention as t_attn
from diffusiontexturepainting_torch.ops import conv3x3 as t_conv
from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv
from diffusiontexturepainting_tpu.ops.flash_attention import flash_attention

torch.set_num_threads(2)

# fp32 on both sides; the sums run in another order (XLA / Pallas
# interpreter vs torch CPU), so agreement is to fp32 accumulation error.
ATOL = RTOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("B,H,W,cin,cout", [
    (1, 8, 8, 16, 128),
    (3, 4, 6, 32, 256),
])
def test_conv3x3_matches_pallas(B, H, W, cin, cout):
    x, w, b = (_rand((B, H, W, cin), 0), _rand((3, 3, cin, cout), 1, 0.1),
               _rand((cout,), 2))
    want = j_conv.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          "pallas")
    got = t_conv.conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,H,W,cin,cout", [
    (1, 4, 4, 32, 128),
    (2, 8, 6, 16, 128),
])
def test_upsample_conv_matches_pallas(B, H, W, cin, cout):
    x, w, b = (_rand((B, H, W, cin), 3), _rand((3, 3, cin, cout), 4, 0.1),
               _rand((cout,), 5))
    want = j_conv.upsample2x_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), "pallas")
    w_t = torch.from_numpy(w)
    got = t_conv.upsample2x_conv3x3(torch.from_numpy(x), w_t,
                                    torch.from_numpy(b),
                                    t_conv.fold_upsample_weights(w_t))
    assert got.shape == (B, 2 * H, 2 * W, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_fold_upsample_weights_matches_jax():
    """Exact: the same fp32 sums in the same order."""
    w = _rand((3, 3, 8, 16), 6)
    want = np.asarray(j_conv._fold_upsample_weights(jnp.asarray(w)))
    got = t_conv.fold_upsample_weights(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_folded_parity_planes_equal_upsample_conv():
    """The K4 kernel's index math, written out in torch on the CPU: output
    (2y+ry, 2x+rx) = sum over taps (ai, bi) of x[y+ry+ai-1, x+rx+bi-1]
    @ w16[((ry*2+rx)*2+ai)*2+bi], zero outside the image."""
    B, H, W, cin, cout = 2, 5, 3, 4, 6
    x = torch.from_numpy(_rand((B, H, W, cin), 7))
    w = torch.from_numpy(_rand((3, 3, cin, cout), 8))
    w16 = t_conv.fold_upsample_weights(w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(B, 2 * H, 2 * W, cout)
    for ry in (0, 1):
        for rx in (0, 1):
            for ai in (0, 1):
                for bi in (0, 1):
                    tap = ((ry * 2 + rx) * 2 + ai) * 2 + bi
                    src = xp[:, ry + ai:ry + ai + H, rx + bi:rx + bi + W]
                    out[:, ry::2, rx::2] += src @ w16[tap]
    want = t_conv.upsample2x_conv3x3_plain(x, w, torch.zeros(cout))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("heads,hd", [(8, 40), (1, 512)])
def test_flash_attention_matches_pallas(heads, hd):
    """L = 256 self-attention. The Pallas kernel's static-shift softmax
    equals the row-max softmax to fp32 rounding at these logits."""
    b, length, d = 1, 256, heads * hd
    q, k, v = (_rand((b, length, d), s) for s in (10, 11, 12))
    with pltpu.force_tpu_interpret_mode():
        want = flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), heads)
    got = t_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("heads,hd", [(8, 40), (1, 512)])
def test_flash_attention_rounds_q_as_pallas_in_bf16(heads, hd):
    """bf16, L = 256, inputs 3 N(0, 1) so the base-2 logits are large: K2
    pre-scales q by scale*log2(e) and rounds it to bf16 before Q K^T
    (_attn_kernel's qs). The port in that order lands within two bf16 ulps
    of the Pallas kernel's largest output (max) and a sixteenth of one
    (mean); scaling the fp32 logits instead misses both by 1.3-2x."""
    b, length, d = 1, 256, heads * hd
    q, k, v = (_rand((b, length, d), s, 3.0) for s in (30, 31, 32))
    with pltpu.force_tpu_interpret_mode():
        want = flash_attention(*(jnp.asarray(x, dtype=jnp.bfloat16)
                                 for x in (q, k, v)), heads)
    want = np.asarray(want.astype(jnp.float32))
    got = t_attn.flash_attention(*(torch.from_numpy(x).bfloat16()
                                   for x in (q, k, v)), heads)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2 * ulp, (diff.max(), ulp)
    assert diff.mean() <= ulp / 16, (diff.mean(), ulp)


def test_attention_dispatch_rule():
    """The JAX package's rule: fused kernel only for Lq == Lk >= 1024 and
    head dim <= 512."""
    assert t_attn.uses_flash(1024, 1024, 40)
    assert t_attn.uses_flash(1024, 1024, 512)
    assert not t_attn.uses_flash(1024, 14, 40)
    assert not t_attn.uses_flash(256, 256, 80)
    assert not t_attn.uses_flash(4096, 4096, 640)
