"""The kernels of the session slice: K9 (the VAE encoder's stride-2
downsample with statistics, gn_conv.downconv_stream) and K14 (the spatial
moments behind gn_conv.stats_of, groupnorm.spatial_moments), against the
JAX package's Pallas kernels in interpret mode and its references; the
fused encoder that runs K9; and the host-side pieces of the stroke session
(the erase circle without Pillow, the canvas update oracle).

On the CPU the port's wrappers run their plain versions. The last tests of
each kernel write out in torch the order of the CUDA kernel's arithmetic
(K9's border predicate, K14's bands, row lanes and reduction tree), which
the card compares with the plain versions (chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.vae import VAEEncoder
from diffusiontexturepainting_torch.ops import gn_conv as t_gn
from diffusiontexturepainting_torch.ops import groupnorm as t_norm
from diffusiontexturepainting_torch.pipeline import session as t_session
from diffusiontexturepainting_tpu.client.painter import circle_mask
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.ops import gn_conv_stream as j_gn
from diffusiontexturepainting_tpu.ops import groupnorm as j_norm
from diffusiontexturepainting_tpu.pipeline import session as j_session
from tests.test_torch_port_modules import assert_close, jax_init, port_with

torch.set_num_threads(2)

# fp32 on both sides: outputs to fp32 accumulation error (relative 1e-4);
# statistics, sums over up to 512 outputs, to that error times their size.
RTOL, ATOL = 1e-4, 1e-4
STATS_RTOL, STATS_ATOL = 1e-4, 1e-2
# bf16: the plain version rounds the conv before its bias add, the JAX
# reference after: 2^-5 of the output's largest magnitude, as on the card.
BF16_REL = 2.0**-5


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _downconv_inputs(x_shape, cout, bias, seed):
    cin = x_shape[-1]
    return (_rand(x_shape, seed), _rand((3, 3, cin, cout), seed + 1, 0.05),
            _rand((cout,), seed + 2) if bias else None)


# --- K9: downconv_stream ---


@pytest.mark.parametrize("x_shape,cout,bias,stats", [
    ((1, 16, 16, 16), 128, True, True),
    ((2, 32, 18, 32), 128, True, True),
    ((1, 16, 16, 16), 128, False, True),
    ((2, 16, 20, 16), 128, True, False),
])
def test_downconv_stream_matches_pallas(x_shape, cout, bias, stats):
    """K9's plain version against _downconv_kernel (interpret mode) and
    _downconv_reference: the output and both statistics rows."""
    x, w, b = _downconv_inputs(x_shape, cout, bias, seed=sum(x_shape))
    assert j_gn.downconv_stream_plan(x.shape, w.shape, 4) is not None
    jb = None if b is None else jnp.asarray(b)
    want = j_gn.downconv_stream(jnp.asarray(x), jnp.asarray(w), jb, stats,
                                force="pallas")
    ref = j_gn._downconv_reference(jnp.asarray(x), jnp.asarray(w), jb,
                                   stats)
    got, got_st = t_gn.downconv_stream(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), stats)
    B, H, W, _ = x_shape
    assert got.shape == (B, H // 2, W // 2, cout)
    for w_out, w_st in (want, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_out),
                                   rtol=RTOL, atol=ATOL)
        if not stats:
            assert got_st is None and w_st is None
            continue
        assert got_st.shape == (B, 2, cout)
        np.testing.assert_allclose(got_st.numpy(), np.asarray(w_st)[:, :2],
                                   rtol=STATS_RTOL, atol=STATS_ATOL)


def test_downconv_stream_bf16_matches_reference():
    """bf16 in and out: the plain version against _downconv_reference in
    bf16, the output within 2^-5 of its largest magnitude and the
    pre-rounding statistics within that fraction of their scale."""
    x, w, b = _downconv_inputs((2, 16, 18, 32), 128, True, seed=7)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want, want_st = j_gn._downconv_reference(bf(x), bf(w), bf(b), True)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    got, got_st = t_gn.downconv_stream(tb(x), tb(w), tb(b), True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    peak = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= BF16_REL * peak
    want_st = np.asarray(want_st)[:, :2]
    scale = np.abs(want_st).max(axis=(0, 2))
    err = np.abs(got_st.numpy() - want_st).max(axis=(0, 2))
    assert (err <= BF16_REL * scale).all(), (err, scale)


@pytest.mark.parametrize("H,W", [(18, 34), (7, 9), (2, 2), (34, 18)])
def test_downconv_border_is_the_zero_row_and_column_at_h_and_w(H, W):
    """The kernel's load predicate (csrc/conv3x3.cu kDown): output (i, j)
    reads tap (di, dj) at input (2i+di, 2j+dj) when it is < (H, W) and zero
    there, with no -1 offset; an odd H or W drops the last row or column
    as the padded VALID conv does. A SAME-style predicate (offset -1)
    gives another function."""
    x, w, b = _downconv_inputs((2, H, W, 8), 16, True, seed=H * W)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    Ho, Wo = H // 2, W // 2

    def taps(offset):
        y = torch.zeros(2, Ho, Wo, 16)
        for di in range(3):
            for dj in range(3):
                for i in range(Ho):
                    for j in range(Wo):
                        r, c = 2 * i + di + offset, 2 * j + dj + offset
                        if 0 <= r < H and 0 <= c < W:
                            y[:, i, j] += xt[:, r, c] @ wt[di, dj]
        return y + bt

    got, st = t_gn.downconv_stream_plain(xt, wt, bt, True)
    want = taps(0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(),
                               t_norm.spatial_moments_plain(want).numpy(),
                               rtol=1e-5, atol=1e-4)
    assert (taps(-1) - got).abs().max() > 1e-2


def test_downconv_statistics_are_of_the_unrounded_output():
    """K9, like K6 and _downconv_reference, takes its statistics from the
    fp32 output before the rounding to bf16 (K1/K5 take them after)."""
    x, w, b = _downconv_inputs((1, 8, 8, 16), 32, True, seed=3)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    out, st = t_gn.downconv_stream_plain(tb(x), tb(w), tb(b), True)
    xp = F.pad(tb(x), (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2)
    y = F.conv2d(xp, tb(w).permute(3, 2, 0, 1), stride=2)
    y = y.permute(0, 2, 3, 1).float() + tb(b).float()
    np.testing.assert_array_equal(st.numpy(),
                                  t_norm.spatial_moments_plain(y).numpy())
    np.testing.assert_array_equal(out.float().numpy(),
                                  y.bfloat16().float().numpy())


# --- K14: spatial_moments ---


@pytest.mark.parametrize("shape", [(2, 16, 8, 128), (1, 8, 16, 256),
                                   (3, 8, 4, 1280)])
def test_spatial_moments_matches_pallas(shape):
    """K14's plain version against _stats_kernel (interpret mode) and
    _stats_reference, (B, 2, C) against the JAX (sum, sumsq) pair."""
    x = _rand(shape, sum(shape), 1.5, 0.3)
    assert j_norm.stats_plan(shape, min_bytes=0, itemsize=4) is not None
    got = t_norm.spatial_moments(torch.from_numpy(x))
    assert got.shape == (shape[0], 2, shape[-1]) and got.dtype == torch.float32
    for want in (j_norm.spatial_moments(jnp.asarray(x), force="pallas"),
                 j_norm._stats_reference(jnp.asarray(x))):
        want = np.stack([np.asarray(want[0]), np.asarray(want[1])], axis=1)
        np.testing.assert_allclose(got.numpy(), want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_moments_matches_reference_at_any_width(dtype):
    """Widths off the TPU's 128 lanes (the kernel's scalar path) and bf16
    input, summed in fp32 on both sides; stats_of is spatial_moments."""
    x = _rand((3, 5, 7, 40), 11, 2.0, -0.5)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = j_norm._stats_reference(jx)
    want = np.stack([np.asarray(want[0]), np.asarray(want[1])], axis=1)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for got in (t_norm.spatial_moments(tx), t_gn.stats_of(tx)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


def _plan_bands(B, N, C, itemsize):
    """csrc/moments.cu plan_bands."""
    V = 16 // itemsize
    G = -(-C // V)
    slices = -(-G // 256)
    lanes = 256 // min(G, 256)
    bands = -(-8 * 132 // (B * slices))
    return max(1, min(bands, N // (4 * lanes)))


@pytest.mark.parametrize("B,H,W,C,itemsize", [
    (3, 4, 4, 1280, 2),   # the UNet's 4x4 level: one band of 16 rows
    (2, 64, 64, 128, 2),  # a VAE level: many bands
    (2, 9, 7, 40, 4),     # ragged rows, fp32 groups
    (1, 32, 32, 2560, 2),  # two channel slices
])
def test_moments_bands_lanes_and_tree_sum_to_the_moments(B, H, W, C,
                                                         itemsize):
    """K14's arithmetic order: bands of ceil(N / bands) rows (empty bands
    give zeros); in a band, row lane l of 256 / tpr takes rows l, l + lanes,
    ...; the lanes add in lane order; then 8 reduction lanes take every 8th
    band in order and a tree adds them. The bands cover every row once."""
    x = torch.from_numpy(_rand((B, H * W, C), B * C, 1.0, 0.5))
    N, V = H * W, 16 // itemsize
    bands = _plan_bands(B, N, C, itemsize)
    assert 1 <= bands <= 8 * 132
    per_band = -(-N // bands)
    G = -(-C // V)
    tpr = min(G, 256)
    lanes = 256 // tpr
    partial = torch.zeros(B, bands, 2, C)
    seen = torch.zeros(N, dtype=torch.int64)
    for band in range(bands):
        rows = torch.arange(band * per_band, min((band + 1) * per_band, N))
        seen[rows] += 1
        lane_sums = torch.zeros(lanes, B, 2, C)
        for lane in range(lanes):
            mine = x[:, rows[lane::lanes]]
            lane_sums[lane, :, 0] = mine.sum(1)
            lane_sums[lane, :, 1] = mine.square().sum(1)
        for lane in range(lanes):
            partial[:, band] += lane_sums[lane]
    assert (seen == 1).all()
    red = torch.stack([partial[:, k::8].sum(1) for k in range(8)])
    for half in (4, 2, 1):
        red[:half] += red[half:2 * half]
    want = t_norm.spatial_moments_plain(x.reshape(B, H, W, C))
    np.testing.assert_allclose(red[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)


# --- the fused encoder through K9 ---


@pytest.mark.parametrize("shape", [(1, 48, 40, 3), (2, 16, 24, 3)])
def test_tiny_fused_encode_with_downconv_matches_jax(shape):
    """The port's fused_encode (downsamples through downconv_stream, whose
    statistics feed the next level) against the JAX fused_encode, on
    images that are not square."""
    cfg = j_config.tiny_vae_config()
    img = _rand(shape, 5)
    tree = jax_init(j_vae.VAEEncoder(cfg), jnp.asarray(img))
    want = j_vae.fused_encode(tree, jnp.asarray(img), cfg, jnp.float32)
    pm = port_with(VAEEncoder(t_config.tiny_vae_config(), fused=True),
                   "vae_encoder", tree)
    assert_close(pm(torch.from_numpy(img)), want)


# --- the host-side session pieces ---


@pytest.mark.parametrize("size", [64, 256, 512, 1024, 5, 17, 63, 255, 1023])
def test_erase_circle_matches_pillow(size):
    """The erase circle without Pillow: bit for bit the mask the JAX
    package draws with PIL (client/painter.py circle_mask)."""
    want = circle_mask(size)[..., 0] > 0
    np.testing.assert_array_equal(t_session.circle_mask(size), want)


@pytest.mark.parametrize("x0,y0", [(0, 0), (30, 17), (-20, 90), (500, -3)])
def test_host_stamp_update_matches_jax(x0, y0):
    rng = np.random.default_rng(abs(x0 * 7 + y0))
    canvas = rng.integers(0, 256, (80, 100, 4), dtype=np.uint8)
    comp = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    got = t_session.host_stamp_update(canvas, comp, x0, y0)
    np.testing.assert_array_equal(
        got, j_session.host_stamp_update(canvas, comp, x0, y0))
    assert not np.shares_memory(got, canvas)


def test_session_erase_matches_host_oracle():
    """session_erase on a canvas tensor against host_erase_update."""
    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (70, 90, 4), dtype=np.uint8)
    want = t_session.host_erase_update(canvas, 64, 50, -5)
    t = torch.from_numpy(canvas.copy())
    crop = t_session.session_erase(t, t_session.erase_keep(64, "cpu"), 50,
                                   -5)
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(crop.numpy(), want[0:64, 26:90, :3])
