"""bf16 K10's fold of the GroupNorm in its CTA (csrc/gn_conv_sm90.cu, the
affine mode), written out in torch, against the JAX package on the CPU.

The kernel takes K14's fp32 (S1, S2) per (image, channel), folds each
group's mean and inverse deviation once per CTA and then a, c per channel
of each 64-channel chunk; the UNet's group sizes (10 to 80 channels) cross
its 8-channel loads and 64-channel chunks. ops/groupnorm.py
gn_fold_per_channel is that arithmetic in torch. Here it is held against
the JAX package's gn_affine_params, and the conv built on it (the prologue
in fp32 from each chunk's table of a, c, the conv, bias, temb and residual
in fp32) against the JAX K10 (_gn_conv_kernel in interpret mode), at group
sizes 10, 20, 30, 40, 60 and 80, with and without temb and residual. All
in fp32: the tolerances are the JAX package's own for K10 against its
reference (tests/test_conv3x3.py test_fused_gn_silu_conv), and 1e-5
relative for a and c (fp32 sums in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch.ops import groupnorm as t_norm
from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv

torch.set_num_threads(2)

GN_ATOL, GN_RTOL = 2e-4, 1e-3
FOLD_RTOL, FOLD_ATOL = 1e-5, 1e-5
# (channels a group, groups): Cin 40 to 160, groups across 8-channel loads
# (10, 20, 30, 60) and 64-channel chunks (30, 40, 60, 80)
GROUPS = [(10, 4), (20, 4), (30, 4), (40, 4), (60, 2), (80, 2)]
CHUNK = 64


def _inputs(cpg, groups, seed, B=2, H=8, W=8, cout=128):
    rng = np.random.default_rng(seed)
    cin = cpg * groups
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale
                                          + shift).astype(np.float32)
    # each group its own mean and spread, so a group folded with its
    # neighbour's statistics is far off
    x = f(B, H, W, cin) * np.repeat(f(groups, scale=0.5, shift=1.0), cpg) \
        + np.repeat(f(groups), cpg)
    return dict(x=x, scale=f(cin, scale=0.3, shift=1.0),
                shift=f(cin, scale=0.3), w=f(3, 3, cin, cout, scale=0.05),
                b=f(cout, scale=0.1), temb=f(B, cout), res=f(B, H, W, cout))


def _kernel_emulation(x, scale, shift, w, b, temb, res, groups, eps):
    """The affine mode in torch: K14's sums, the fold per channel, each
    64-channel chunk's prologue from its (a, c) table, 0 outside the image
    (the MASK bit), then the conv and the epilogue in fp32 (fp32 has no
    roundings to place)."""
    B, H, W, cin = x.shape
    a, c = t_norm.gn_fold_per_channel(t_norm.spatial_moments_plain(x), scale,
                                      shift, groups, H * W, eps)
    v = torch.zeros_like(x)
    for c0 in range(0, cin, CHUNK):
        sl = slice(c0, min(cin, c0 + CHUNK))
        v[..., sl] = F.silu(x[..., sl] * a[:, None, None, sl]
                            + c[:, None, None, sl])
    y = F.conv2d(v.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1) + b
    if temb is not None:
        y = y + temb[:, None, None, :]
    if res is not None:
        y = y + res
    return y


@pytest.mark.parametrize("cpg,groups", GROUPS)
def test_fold_matches_gn_affine_params(cpg, groups):
    """The per-channel a, c from K14's (B, 2, Cin) sums equal the JAX
    package's gn_affine_params of x (and the port's gn_affine_from_stats),
    channel for channel."""
    d = _inputs(cpg, groups, seed=cpg)
    x = torch.from_numpy(d["x"])
    st = t_norm.spatial_moments_plain(x)
    a, c = t_norm.gn_fold_per_channel(st, torch.from_numpy(d["scale"]),
                                      torch.from_numpy(d["shift"]), groups,
                                      64, 1e-5)
    ja, jc = j_conv.gn_affine_params(jnp.asarray(d["x"]),
                                     jnp.asarray(d["scale"]),
                                     jnp.asarray(d["shift"]), groups, 1e-5)
    for got, want in ((a, ja), (c, jc)):
        assert got.shape == (2, cpg * groups) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FOLD_RTOL, atol=FOLD_ATOL)
    pa, pc = t_norm.gn_affine_from_stats(st, torch.from_numpy(d["scale"]),
                                         torch.from_numpy(d["shift"]),
                                         groups, 64, 1e-5)
    np.testing.assert_allclose(a.numpy(), pa.numpy(), rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)
    np.testing.assert_allclose(c.numpy(), pc.numpy(), rtol=FOLD_RTOL,
                               atol=FOLD_ATOL)


def test_fold_takes_each_channels_own_group():
    """A group of 30 channels crosses the 8-channel loads and the
    64-channel chunk: every channel's a is its own group's inverse
    deviation times its scale (each group's x has its own spread)."""
    d = _inputs(30, 4, seed=1)
    x = torch.from_numpy(d["x"])
    ones = torch.ones(120)
    a, c = t_norm.gn_fold_per_channel(t_norm.spatial_moments_plain(x), ones,
                                      torch.zeros(120), 4, 64, 1e-5)
    for g in range(4):
        xs = x[..., 30 * g:30 * (g + 1)]
        inv = torch.rsqrt(xs.var(dim=(1, 2, 3), unbiased=False) + 1e-5)
        np.testing.assert_allclose(
            a[:, 30 * g:30 * (g + 1)].numpy(),
            inv[:, None].expand(2, 30).numpy(), rtol=1e-4)
        np.testing.assert_allclose(
            c[:, 30 * g:30 * (g + 1)].numpy(),
            (-xs.mean(dim=(1, 2, 3)) * inv)[:, None].expand(2, 30).numpy(),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "temb+res"])
@pytest.mark.parametrize("cpg,groups", GROUPS)
def test_affine_mode_matches_pallas_k10(cpg, groups, extras):
    """The affine mode's arithmetic (the fold per channel, the prologue
    from each chunk's table, 0 outside the image, the conv with bias
    [+ temb] [+ residual]) against the JAX K10, _gn_conv_kernel in
    interpret mode, and the port's gn_silu_conv3x3 (its plain version on
    the CPU) beside."""
    d = _inputs(cpg, groups, seed=100 + cpg)
    temb, res = (d["temb"], d["res"]) if extras else (None, None)
    want = np.asarray(j_conv.gn_silu_conv3x3(
        *(None if v is None else jnp.asarray(v)
          for v in (d["x"], d["scale"], d["shift"], d["w"], d["b"], temb,
                    res)), groups, 1e-5, "pallas"))
    t = lambda v: None if v is None else torch.from_numpy(v)
    got = _kernel_emulation(*(t(v) for v in (d["x"], d["scale"],
                                             d["shift"], d["w"], d["b"],
                                             temb, res)), groups, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=GN_ATOL, rtol=GN_RTOL)
    from diffusiontexturepainting_torch.ops import conv3x3 as t_conv

    port = t_conv.gn_silu_conv3x3(*(t(v) for v in (
        d["x"], d["scale"], d["shift"], d["w"], d["b"], temb, res)),
        num_groups=groups, eps=1e-5)
    np.testing.assert_allclose(port.numpy(), want, atol=GN_ATOL,
                               rtol=GN_RTOL)
