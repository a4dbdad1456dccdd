"""The conv family's staged-tile mode (csrc/conv_staged.cu) on the CPU: the
plain versions of K12a/b (conv3x3 and upsample2x_conv3x3 under the port's
_IN_PAD switch), K11 (conv3x3_stream) and K10 (gn_silu_conv3x3) against the
JAX package's Pallas kernels in interpret mode and its references; the
resnet body as two K10 calls against the JAX ResnetBlock; the tiny twin
stamp with _IN_PAD on and off.

On the CPU the port's wrappers run their plain versions. The last tests
write out in torch the staged kernel's tiling (patches, halo windows with
zero borders, channel chunks, the taps of each mode, the per-group fold of
the statistics), which the card compares with the plain versions
(chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch.core.config import safe_twin_config
from diffusiontexturepainting_torch.models import layers as t_layers
from diffusiontexturepainting_torch.ops import conv3x3 as t_conv
from diffusiontexturepainting_torch.ops import groupnorm as t_norm
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter,
)
from diffusiontexturepainting_tpu.models import layers as j_layers
from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv
from tests.test_torch_port_modules import jax_init, port_with

torch.set_num_threads(2)

# fp32 on both sides: accumulation order only (K = 9*Cin up to 288 here).
ATOL = RTOL = 1e-4
# K10 in fp32: the JAX package's own tolerance for its kernel against its
# reference (tests/test_conv3x3.py test_fused_gn_silu_conv): the GroupNorm
# statistics and the SiLU add their fp32 rounding to the conv's.
GN_ATOL, GN_RTOL = 2e-4, 1e-3


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


# --- K12a/b: the in-kernel-padding route ---


@pytest.mark.parametrize("op", ["conv3x3", "upsample2x_conv3x3"])
def test_inpad_matches_pallas_inpad_kernels(op):
    """K12a (_conv_kernel_inpad) and K12b (_upconv_kernel) in interpret mode,
    with the JAX package's _IN_PAD set, against the port's route with its
    own _IN_PAD set: the wrapper and the _inpad entry (plain on the CPU)."""
    x = _rand((2, 16, 16, 32), 0)
    w = _rand((3, 3, 32, 128), 1, 0.1)
    b = _rand((128,), 2, 0.1)
    old_j, old_t = j_conv._IN_PAD, t_conv._IN_PAD
    j_conv._IN_PAD = t_conv._IN_PAD = True
    try:
        want = getattr(j_conv, op)(*_j(x, w, b), "pallas")
        xt, wt, bt = _t(x, w, b)
        if op == "conv3x3":
            got = (t_conv.conv3x3(xt, wt, bt),
                   t_conv.conv3x3_inpad(xt, wt, bt))
        else:
            taps = t_conv.fold_upsample_weights(wt)
            got = (t_conv.upsample2x_conv3x3(xt, wt, bt, taps),
                   t_conv.upsample2x_conv3x3_inpad(xt, wt, bt, taps))
    finally:
        j_conv._IN_PAD, t_conv._IN_PAD = old_j, old_t
    for g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


# --- K11: the streamed-window conv ---


@pytest.mark.parametrize("x_shape", [(1, 16, 8, 16), (1, 16, 16, 32)])
def test_conv3x3_stream_matches_pallas(x_shape):
    """_conv_stream_kernel in interpret mode with the (8, 128) plan against
    the port's conv3x3_stream (plain on the CPU)."""
    cin = x_shape[-1]
    x = _rand(x_shape, cin)
    w = _rand((3, 3, cin, 128), cin + 1, 0.1)
    b = _rand((128,), cin + 2)
    want = j_conv._conv3x3_stream(*_j(x, w, b), (8, 128), interpret=True)
    got = t_conv.conv3x3_stream(*_t(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# --- K10: GroupNorm -> SiLU -> conv with in-kernel statistics ---


def _gn_inputs(extras, B=2, H=8, W=8, cin=32, cout=128, seed=0):
    x = _rand((B, H, W, cin), seed, 1.0, 0.2)
    scale = _rand((cin,), seed + 1, 0.3, 1.0)
    bias = _rand((cin,), seed + 2, 0.3)
    w = _rand((3, 3, cin, cout), seed + 3, 0.1)
    b = _rand((cout,), seed + 4, 0.1)
    temb = (_rand((B, cout), seed + 5) if extras in ("temb", "both")
            else None)
    res = (_rand((B, H, W, cout), seed + 6) if extras in ("residual", "both")
           else None)
    return x, scale, bias, w, b, temb, res


@pytest.mark.parametrize("extras", ["none", "temb", "residual", "both"])
def test_gn_silu_conv3x3_matches_pallas(extras):
    """_gn_conv_kernel in interpret mode (and _gn_conv_reference) at
    (2, 8, 8, 32) -> 128 with 4 groups against the port's gn_silu_conv3x3
    (plain on the CPU)."""
    args = _gn_inputs(extras)
    got = t_conv.gn_silu_conv3x3(*_t(*args), num_groups=4, eps=1e-5)
    assert got.shape == (2, 8, 8, 128) and got.dtype == torch.float32
    for force in ("pallas", "xla"):
        want = j_conv.gn_silu_conv3x3(*_j(*args), 4, 1e-5, force)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GN_ATOL, rtol=GN_RTOL)


def test_gn_silu_conv3x3_bf16_rounds_once():
    """bf16: v = silu(x*a + c) rounded once, then the conv, bias, temb and
    residual in fp32 with one rounding, as _gn_conv_kernel does. The port
    equals that order built from the JAX package's own pieces
    (gn_affine_params, an fp32 conv of the rounded v) to one bf16 ulp, and
    is nearer to it than _gn_conv_reference, which rounds the conv + bias
    before adding temb and residual."""
    x, scale, bias, w, b, temb, res = _gn_inputs("both", seed=20)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jx, js, jsh, jw, jb, jt, jr = map(bf, (x, scale, bias, w, b, temb, res))
    a, c = j_conv.gn_affine_params(jx, js, jsh, 4, 1e-5)
    v = jx.astype(jnp.float32) * a[:, None, None, :] + c[:, None, None, :]
    v = (v * jax.nn.sigmoid(v)).astype(jnp.bfloat16).astype(jnp.float32)
    y = jax.lax.conv_general_dilated(
        v, jw.astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = (y + jb.astype(jnp.float32) + jt.astype(jnp.float32)[:, None, None]
         + jr.astype(jnp.float32))
    once = np.asarray(y.astype(jnp.bfloat16).astype(jnp.float32))
    twice = np.asarray(j_conv._gn_conv_reference(
        jx, js, jsh, jw, jb, jt, jr, 4, 1e-5).astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).bfloat16()
    got = t_conv.gn_silu_conv3x3(tb(x), tb(scale), tb(bias), tb(w), tb(b),
                                 tb(temb), tb(res), 4, 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.abs(once) * 2.0**-7 + 1e-30
    assert (np.abs(got - once) <= ulp).all()
    assert (got == once).mean() >= 0.99
    assert np.abs(got - once).sum() < np.abs(got - twice).sum()


# --- the slice as a whole: a resnet body as two K10 calls ---


@pytest.mark.parametrize("cin,cout,temb,skip", [
    (32, 64, True, False),   # shortcut and time embedding
    (64, 64, False, False),  # neither
    (32, 64, True, True),    # an up-path body: the concatenated input
])
def test_resnet_body_as_two_gn_silu_convs_matches_jax(cin, cout, temb, skip):
    """resnet_gn_silu_conv (conv1 with the projected time embedding, conv2
    with the shortcut as its residual) against the JAX ResnetBlock module,
    same weights through weights/from_jax.py."""
    ca = cin // 2 if skip else cin
    x = _rand((2, 8, 8, ca), 30)
    s = _rand((2, 8, 8, cin - ca), 31) if skip else None
    t = _rand((2, 128), 32) if temb else None
    xin = np.concatenate([x, s], axis=-1) if skip else x
    jm = j_layers.ResnetBlock(cout, 8, eps=1e-5)
    args = (jnp.asarray(xin),) + ((jnp.asarray(t),) if temb else ())
    tree = jax_init(jm, *args)
    want = jm.apply({"params": tree}, *args)
    pm = port_with(t_layers.ResnetBlock(cin, cout, 8,
                                        temb_dim=128 if temb else None,
                                        eps=1e-5), "unet", tree)
    xt, st, tt = _t(x, s, t)
    with torch.no_grad():
        got = t_layers.resnet_gn_silu_conv(pm, xt, tt, st)
        module = pm(torch.cat([xt, st], -1) if skip else xt, tt)
    for g in (got, module):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=GN_ATOL, rtol=GN_RTOL)


def test_twin_stamp_is_bit_equal_with_in_pad_on_the_cpu():
    """The switch changes the CUDA route only: the tiny twin's stamp at one
    request counter is the same bytes with _IN_PAD on and off."""
    model = TorchConditionalInpainter(64, config=safe_twin_config(),
                                      device="cpu", tiny=True)
    rng = np.random.default_rng(3)
    canvas = np.zeros((64, 64, 4), np.uint8)
    canvas[:16, :, :3] = rng.integers(0, 256, (16, 64, 3))
    canvas[:16, :, 3] = 255
    settings = dict(steps=4, width=64, cfg_weight=2.0, tg_weight=1.0,
                    tg_steps=4, context_pad=150)
    stamps = []
    for on in (False, True):
        old = t_conv._IN_PAD
        t_conv._IN_PAD = on
        try:
            model.request_counter = 5
            stamps.append(model.generate_u8(canvas, **settings))
        finally:
            t_conv._IN_PAD = old
    assert stamps[0].shape == (64, 64, 3)
    np.testing.assert_array_equal(stamps[0], stamps[1])


# --- the staged kernel's tiling, written out in torch ---


def _staged(x, w, b, up=False, th=8, tw=16, bk=32, gn=None):
    """csrc/conv_staged.cu in torch: per (image, th x tw patch, channel
    chunk of bk), the (th+2) x (tw+2) window staged with zeros outside the
    image (and the GroupNorm prologue applied inside it only), then the
    taps read the window shifted by (dy, dx): SAME taps (di-1, dj-1) with
    w (3,3,Cin,Cout); UP plane (ry, rx) taps (ry+ai-1, rx+bi-1) with the 16
    folded taps w. gn: (scale, shift, stats, groups, eps), folded per group
    in the kernel's order."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    planes = ((0, 0), (0, 1), (1, 0), (1, 1)) if up else ((0, 0),)
    out = torch.zeros(B, 2 * H if up else H, 2 * W if up else W, cout)
    if gn is not None:
        scale, shift, stats, groups, eps = gn
        cpg = cin // groups
        n = float(H * W * cpg)
        a = torch.zeros(B, cin)
        c = torch.zeros(B, cin)
        for bb in range(B):
            for g in range(groups):
                s1 = s2 = torch.tensor(0.0)
                for ch in range(g * cpg, (g + 1) * cpg):
                    s1, s2 = s1 + stats[bb, 0, ch], s2 + stats[bb, 1, ch]
                mean = s1 / n
                inv = torch.rsqrt(s2 / n - mean * mean + eps)
                sl = slice(g * cpg, (g + 1) * cpg)
                a[bb, sl] = inv * scale[sl]
                c[bb, sl] = shift[sl] - mean * a[bb, sl]
    for bb in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                for pi, (ry, rx) in enumerate(planes):
                    acc = torch.zeros(th, tw, cout)
                    for ci0 in range(0, cin, bk):
                        win = torch.zeros(th + 2, tw + 2, bk)
                        for wy in range(th + 2):
                            for wx in range(tw + 2):
                                yy, xx = y0 + wy - 1, x0 + wx - 1
                                if 0 <= yy < H and 0 <= xx < W:
                                    v = x[bb, yy, xx, ci0:ci0 + bk]
                                    if gn is not None:
                                        v = F.silu(v * a[bb, ci0:ci0 + bk]
                                                   + c[bb, ci0:ci0 + bk])
                                    win[wy, wx, :v.shape[0]] = v
                        kc = min(bk, cin - ci0)
                        taps = ([(pi * 4 + ai * 2 + bi, ry + ai - 1,
                                  rx + bi - 1)
                                 for ai in (0, 1) for bi in (0, 1)] if up
                                else [(di * 3 + dj, di - 1, dj - 1)
                                      for di in range(3) for dj in range(3)])
                        for k, dy, dx in taps:
                            wk = (w[k] if up else w[k // 3, k % 3])
                            a_op = win[1 + dy:1 + dy + th,
                                       1 + dx:1 + dx + tw, :kc]
                            acc += a_op @ wk[ci0:ci0 + kc]
                    for py in range(th):
                        for px in range(tw):
                            y, xq = y0 + py, x0 + px
                            if y < H and xq < W:
                                yo, xo = ((2 * y + ry, 2 * xq + rx) if up
                                          else (y, xq))
                                out[bb, yo, xo] = acc[py, px] + b
    return out


@pytest.mark.parametrize("x_shape,cout,th,bk", [
    ((1, 5, 7, 3), 40, 8, 32),     # Cin 3: one ragged chunk, one patch
    ((2, 9, 17, 48), 24, 8, 32),   # ragged patches and chunks
    ((1, 1, 1, 9), 8, 4, 16),      # a 1x1 image; the fp32 patch
    ((1, 10, 18, 20), 16, 4, 16),  # the fp32 tile's patches and chunks
])
def test_staged_same_tiling_is_the_conv(x_shape, cout, th, bk):
    x = torch.from_numpy(_rand(x_shape, sum(x_shape)))
    w = torch.from_numpy(_rand((3, 3, x_shape[-1], cout), 1, 0.2))
    b = torch.from_numpy(_rand((cout,), 2))
    np.testing.assert_allclose(_staged(x, w, b, th=th, bk=bk).numpy(),
                               t_conv.conv3x3_plain(x, w, b).numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("x_shape,cout", [((1, 6, 5, 48), 40),
                                          ((2, 3, 17, 9), 8)])
def test_staged_up_tiling_is_the_upsample_conv(x_shape, cout):
    """Every parity plane's four folded taps read the one source window."""
    x = torch.from_numpy(_rand(x_shape, sum(x_shape)))
    w = torch.from_numpy(_rand((3, 3, x_shape[-1], cout), 3, 0.2))
    b = torch.from_numpy(_rand((cout,), 4))
    got = _staged(x, t_conv.fold_upsample_weights(w), b, up=True)
    np.testing.assert_allclose(
        got.numpy(), t_conv.upsample2x_conv3x3_plain(x, w, b).numpy(),
        atol=1e-5, rtol=1e-5)


def test_staged_gn_prologue_is_gn_silu_conv3x3():
    """The GroupNorm mode: the group fold from the (B, 2, Cin) sums, the
    prologue inside the image only (the border stays zero, though
    silu(0*a + c) != 0) and the conv, against gn_silu_conv3x3_plain."""
    x, scale, bias, w, b, _, _ = _gn_inputs("none", B=2, H=5, W=9, cin=48,
                                            cout=24, seed=40)
    x, scale, bias, w, b = _t(x, scale, bias, w, b)
    stats = t_norm.spatial_moments_plain(x)
    got = _staged(x, w, b, gn=(scale, bias, stats, 8, 1e-5))
    want = t_conv.gn_silu_conv3x3_plain(x, scale, bias, w, b, num_groups=8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
