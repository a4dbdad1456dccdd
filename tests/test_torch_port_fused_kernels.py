"""The port's fused kernel ops (K1 gn_conv_resident, K5 gn_conv_stream, K6
upconv_stream, K3 ff_geglu) and the GroupNorm statistics algebra against the
JAX package's Pallas kernels and functions.

On the CPU the port's wrappers run their plain PyTorch versions; the Pallas
kernels run in interpret mode (the JAX package's `force="pallas"` off a TPU),
at shapes their plans accept. The last tests write out in torch the
arithmetic order of the CUDA kernels' epilogues (statistics chunks, the
border predicate, the split-weight conv, the feed-forward's inner chunks),
which the card compares with the plain versions (chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch.ops import conv3x3 as t_conv
from diffusiontexturepainting_torch.ops import ff_geglu as t_ff
from diffusiontexturepainting_torch.ops import gn_conv as t_gn
from diffusiontexturepainting_torch.ops import groupnorm as t_norm
from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv
from diffusiontexturepainting_tpu.ops import ff_geglu as j_ff
from diffusiontexturepainting_tpu.ops import gn_conv_stream as j_gn

torch.set_num_threads(2)

# fp32 on both sides; sums run in another order (Pallas interpreter / XLA vs
# torch CPU): outputs agree to fp32 accumulation error, statistics (sums
# over up to 256 pixels of outputs near 10) to that error times their size.
ATOL = RTOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-4, 1e-2


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _gn_inputs(B, H, W, cin, cout, res, bias=True, seed=0):
    return (_rand((B, H, W, cin), seed), _rand((B, cin), seed + 1, 0.2, 1.0),
            _rand((B, cin), seed + 2, 0.2),
            _rand((3, 3, cin, cout), seed + 3, 0.05),
            _rand((cout,), seed + 4) if bias else None,
            _rand((B, H, W, cout), seed + 5) if res else None)


def _assert_pair(got, want):
    out, st = got
    w_out, w_st = want
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), atol=ATOL,
                               rtol=RTOL)
    if w_st is None:
        assert st is None
    else:
        assert st.shape == (out.shape[0], 2, out.shape[-1])
        np.testing.assert_allclose(st.numpy(), np.asarray(w_st)[:, :2],
                                   atol=STATS_ATOL, rtol=STATS_RTOL)


@pytest.mark.parametrize("res,stats,bias", [
    (False, True, True), (True, True, True), (True, False, True),
    (False, False, True), (True, True, False)])
def test_gn_conv_resident_matches_pallas(res, stats, bias):
    """K1's plain version against _gn_res_kernel (interpret mode); b=None
    is the second half of the split concat conv."""
    args = _gn_inputs(2, 4, 4, 32, 128, res, bias)
    x, a, c, w, b, r = args
    assert j_conv.gn_conv_resident_plan(x.shape, w.shape, res, 4) is not None
    want = j_conv.gn_conv_resident(*_j(*args), stats, True, force="pallas")
    got = t_gn.gn_conv_resident(*_t(*args), stats, True)
    _assert_pair(got, want)


@pytest.mark.parametrize("apply_gn,res", [(True, True), (True, False),
                                          (False, True)])
def test_gn_conv_stream_matches_pallas(apply_gn, res):
    """K5's plain version against gn_conv_stream._kernel (interpret)."""
    args = _gn_inputs(1, 8, 8, 16, 128, res, seed=10)
    x, a, c, w, b, r = args
    assert j_gn.stream_fused_plan(x.shape, w.shape, 4) is not None
    want = j_gn.gn_conv_stream(*_j(*args), True, apply_gn, "pallas")
    got = t_gn.gn_conv_stream(*_t(*args), True, apply_gn)
    _assert_pair(got, want)


def test_upconv_stream_matches_pallas():
    """K6's plain version against _upconv_stream_kernel (interpret),
    statistics included."""
    x, w, b = (_rand((1, 8, 8, 16), 20), _rand((3, 3, 16, 128), 21, 0.05),
               _rand((128,), 22))
    assert j_gn.upconv_stream_plan(x.shape, w.shape, 4) is not None
    want = j_gn.upconv_stream(*_j(x, w, b), True, force="pallas")
    xt, wt, bt = _t(x, w, b)
    got = t_gn.upconv_stream(xt, wt, bt, t_conv.fold_upsample_weights(wt),
                             True)
    assert got[0].shape == (1, 16, 16, 128)
    _assert_pair(got, want)


def test_ff_geglu_matches_pallas(monkeypatch):
    """K3's plain version against _ff_kernel (interpret) with the erf GELU
    (the Pallas kernel's default tanh form is a TPU speed trade). The port
    takes the nn.Linear (out, in) weights, the JAX op (in, out)."""
    monkeypatch.setattr(j_ff, "_FF_GELU_FLAVOR", "erf")
    N, C, inner = 64, 128, 512
    x, w0, b0 = (_rand((N, C), 30, 0.5), _rand((C, 2 * inner), 31, 0.05),
                 _rand((2 * inner,), 32, 0.1))
    w2, b2, res = (_rand((inner, C), 33, 0.05), _rand((C,), 34, 0.1),
                   _rand((N, C), 35))
    assert j_ff.ff_geglu_plan(N, C, inner) is not None
    want = j_ff.ff_geglu(*_j(x, w0, b0, w2, b2, res), force="pallas")
    got = t_ff.ff_geglu(*_t(x, np.ascontiguousarray(w0.T), b0,
                            np.ascontiguousarray(w2.T), b2, res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_ff_geglu_plain_bf16_matches_reference():
    """bf16: the plain version and the JAX _reference round h and the
    output at the same two points (within 1 bf16 ulp of the output)."""
    N, C, inner = 16, 32, 128
    x, w0, b0 = (_rand((N, C), 36, 0.5), _rand((C, 2 * inner), 37, 0.1),
                 _rand((2 * inner,), 38, 0.1))
    w2, b2, res = (_rand((inner, C), 39, 0.1), _rand((C,), 40, 0.1),
                   _rand((N, C), 41))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = j_ff._reference(bf(x), bf(w0), bf(b0), bf(w2), bf(b2), bf(res))
    tb = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    got = t_ff.ff_geglu(tb(x), tb(w0.T), tb(b0), tb(w2.T), tb(b2), tb(res))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0**-7 * np.abs(want).max())


def test_statistics_algebra_matches_jax():
    """stats_of, gn_affine_from_stats and shift_stats_for_temb against the
    JAX functions (rows 0-1 of the TPU's 8-row statistics)."""
    x, t = _rand((2, 4, 4, 64), 50, 2.0, 0.5), _rand((2, 64), 51)
    scale, bias = _rand((64,), 52, 0.1, 1.0), _rand((64,), 53, 0.1)
    want_st = j_gn.stats_of(jnp.asarray(x))
    st = t_gn.stats_of(torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st)[:, :2],
                               rtol=1e-5, atol=1e-4)
    want_a, want_c = j_gn.gn_affine_from_stats(
        want_st, jnp.asarray(scale), jnp.asarray(bias), 8, 16, 1e-6)
    a, c = t_norm.gn_affine_from_stats(st, *_t(scale, bias), 8, 16, 1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-5)
    want_sh = j_gn.shift_stats_for_temb(want_st, jnp.asarray(t), 16)
    sh = t_gn.shift_stats_for_temb(st, torch.from_numpy(t), 16)
    np.testing.assert_allclose(sh.numpy(), np.asarray(want_sh)[:, :2],
                               rtol=1e-5, atol=1e-3)
    # the folded affine is the GroupNorm: x*a + c == GroupNorm32(x)
    from diffusiontexturepainting_torch.models.layers import GroupNorm32

    gn = GroupNorm32(8, 64, eps=1e-6)
    gn.weight.data, gn.bias.data = _t(scale, bias)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose((xt * a[:, None, None] + c[:, None, None])
                               .numpy(), gn(xt).detach().numpy(), atol=1e-5)


# --- the CUDA kernels' arithmetic order, written out in torch ---


def _plan_chunk(rows, cout):
    """csrc/conv3x3.cu plan_chunk."""
    col_blocks = -(-cout // 128)
    chunk = 128
    while chunk > 8 and -(-rows // chunk) * col_blocks < 2 * 132:
        chunk //= 2
    return chunk


@pytest.mark.parametrize("B,hw,cout", [(3, 16, 1280), (2, 3, 8),
                                       (1, 1024, 512), (5, 130, 64)])
def test_statistics_chunks_cover_every_image_once(B, hw, cout):
    """finish_stats_kernel + stats_reduce_kernel: rows in chunks, per-image
    partials per chunk in `slots` slots, then each image's chunks in chunk
    order. Images straddling chunks (the UNet's 4x4 level: 16 rows an
    image, 8-row chunks) and chunks holding several images both occur."""
    y = torch.from_numpy(_rand((B * hw, cout), 60))
    chunk = _plan_chunk(B * hw, cout)
    slots = min(B, (chunk - 1) // hw + 2)
    n_chunks = -(-(B * hw) // chunk)
    ws = torch.full((n_chunks, slots, 2, cout), float("nan"))
    for ci in range(n_chunks):
        r0, r1 = ci * chunk, min((ci + 1) * chunk, B * hw)
        b0 = r0 // hw
        for r in range(r0, r1, 1):
            slot = r // hw - b0
            assert slot < slots
            if r == r0 or r % hw == 0:
                ws[ci, slot] = 0.0
            ws[ci, slot, 0] += y[r]
            ws[ci, slot, 1] += y[r] ** 2
    stats = torch.zeros(B, 2, cout)
    for b in range(B):
        first, last = b * hw, b * hw + hw - 1
        for ci in range(first // chunk, last // chunk + 1):
            part = ws[ci, b - ci * chunk // hw]
            assert torch.isfinite(part).all()
            stats[b] += part
    want = t_gn.stats_of(y.reshape(B, hw, 1, cout))
    np.testing.assert_allclose(stats.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-3)


def test_gn_prologue_border_is_zero_after_the_prologue():
    """The kernel's A operand: silu(x*a + c) inside the image, zero for an
    out-of-image tap (the load predicate skips the prologue). Padding x
    before the prologue would give silu(c) on the border instead."""
    x, a, c, w, b, _ = _gn_inputs(2, 5, 3, 8, 16, False, seed=70)
    xt, at, ct, wt, bt = _t(x, a, c, w, b)
    v = xt * at[:, None, None] + ct[:, None, None]
    v = v * torch.sigmoid(v)
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    H, W = 5, 3
    acc = sum(vp[:, di:di + H, dj:dj + W] @ wt[di, dj]
              for di in range(3) for dj in range(3))
    want = acc + bt
    got, _ = t_gn.gn_conv3x3_plain(xt, at, ct, wt, bt, None, False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    xp = F.pad(xt, (0, 0, 1, 1, 1, 1))
    wrong = xp * at[:, None, None] + ct[:, None, None]
    wrong = wrong * torch.sigmoid(wrong)
    acc = sum(wrong[:, di:di + H, dj:dj + W] @ wt[di, dj]
              for di in range(3) for dj in range(3))
    assert (acc + bt - got).abs().max() > 1e-2


def test_gn_conv_epilogue_order_bf16():
    """K1/K5's epilogue in bf16: fp32 acc + bias, ONE rounding, + residual
    in bf16 (one more rounding), statistics of that result in fp32. The
    plain version rounds the conv before its bias add, so they agree to
    about one bf16 ulp of the output, and the statistics to the same."""
    x, a, c, w, b, r = _gn_inputs(2, 4, 4, 32, 64, True, seed=80)
    xt, at, ct, wt, bt, rt = (t.bfloat16() for t in _t(x, a, c, w, b, r))
    v = xt * at.bfloat16()[:, None, None] + ct.bfloat16()[:, None, None]
    v = v * torch.sigmoid(v)
    acc = F.conv2d(v.float().permute(0, 3, 1, 2),
                   wt.float().permute(3, 2, 0, 1), padding=1)
    y = (acc.permute(0, 2, 3, 1) + bt.float()).bfloat16()
    y = (y.float() + rt.float()).bfloat16()
    st = t_gn.stats_of(y)
    got, got_st = t_gn.gn_conv3x3_plain(xt, at.float(), ct.float(), wt, bt,
                                        rt, True)
    peak = y.float().abs().max().item()
    assert (got.float() - y.float()).abs().max().item() <= 2.0**-6 * peak
    np.testing.assert_allclose(got_st.numpy(), st.numpy(), rtol=2.0**-7,
                               atol=2.0**-7 * 16 * peak)


def test_upconv_statistics_are_of_the_unrounded_output():
    """K6: parity planes over the folded taps in fp32 + bias; statistics
    of that fp32 tensor; the stored output is its rounding."""
    x, w, b = _rand((2, 3, 4, 8), 90), _rand((3, 3, 8, 16), 91, 0.2), \
        _rand((16,), 92)
    xt, wt, bt = _t(x, w, b)
    w16 = t_conv.fold_upsample_weights(wt)
    xp = F.pad(xt, (0, 0, 1, 1, 1, 1))
    y = torch.zeros(2, 6, 8, 16)
    for ry in (0, 1):
        for rx in (0, 1):
            for ai in (0, 1):
                for bi in (0, 1):
                    tap = ((ry * 2 + rx) * 2 + ai) * 2 + bi
                    y[:, ry::2, rx::2] += (
                        xp[:, ry + ai:ry + ai + 3, rx + bi:rx + bi + 4]
                        @ w16[tap])
    y = y + bt
    got, st = t_gn.upconv_stream_plain(xt, wt, bt, True)
    np.testing.assert_allclose(got.numpy(), y.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), t_gn.stats_of(y).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_split_concat_conv_reads_weight_halves_in_place():
    """The fused up-path resnet's conv1: conv(concat(x, s)) = conv(x,
    w[:, :, :ca]) + conv(s, w[:, :, ca:]), the second taking the first as
    its residual; the halves are views whose taps lie stride(1) apart,
    which the kernel reads without a copy."""
    B, H, W, ca, cs, cout = 2, 4, 4, 16, 24, 32
    x, s = _rand((B, H, W, ca), 100), _rand((B, H, W, cs), 101)
    a, c = _rand((B, ca + cs), 102, 0.2, 1.0), _rand((B, ca + cs), 103, 0.2)
    w, b = _rand((3, 3, ca + cs, cout), 104, 0.05), _rand((cout,), 105)
    xt, st_, at, ct, wt, bt = _t(x, s, a, c, w, b)
    lo, hi = wt[:, :, :ca], wt[:, :, ca:]
    for half in (lo, hi):
        assert half.stride() == (3 * half.stride(1), half.stride(1), cout, 1)
    h1, _ = t_gn.gn_conv3x3_plain(xt, at[:, :ca], ct[:, :ca], lo, bt, None,
                                  False)
    got, got_st = t_gn.gn_conv3x3_plain(st_, at[:, ca:], ct[:, ca:], hi,
                                        None, h1, True)
    want, want_st = t_gn.gn_conv3x3_plain(torch.cat([xt, st_], -1), at, ct,
                                          wt, bt, None, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_st.numpy(), want_st.numpy(), atol=1e-2,
                               rtol=1e-4)


def test_ff_inner_chunks_sum_to_the_feed_forward():
    """K3: each block's chunk of inner columns gives an fp32 partial of the
    output, h_chunk @ w2[:, chunk]^T with h rounded per element; the finish
    kernel adds the chunks in order, then b2 and the residual."""
    N, C, inner, ic = 24, 32, 128, 32
    x, w0, b0 = _rand((N, C), 110, 0.5), _rand((2 * inner, C), 111, 0.1), \
        _rand((2 * inner,), 112, 0.1)
    w2, b2, res = _rand((C, inner), 113, 0.1), _rand((C,), 114, 0.1), \
        _rand((N, C), 115)
    xt, w0t, b0t, w2t, b2t, rt = _t(x, w0, b0, w2, b2, res)
    out = torch.zeros(N, C)
    for i0 in range(0, inner, ic):
        v = xt @ w0t[i0:i0 + ic].t() + b0t[i0:i0 + ic]
        g = xt @ w0t[inner + i0:inner + i0 + ic].t() + b0t[inner + i0:
                                                           inner + i0 + ic]
        h = v * (0.5 * g * (1 + torch.erf(g * 0.7071067811865476)))
        out += h @ w2t[:, i0:i0 + ic].t()
    out = out + b2t + rt
    got = t_ff.ff_geglu_plain(xt, w0t, b0t, w2t, b2t, rt)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=1e-5,
                               rtol=1e-5)
