"""bf16 T2 (nomax_attention) and T5 (nomax_unpadded) on the one-pass
static-shift softmax of the wgmma/TMA attention kernel
(csrc/flash_attention_sm90.cu dtp_nomax_attention_sm90,
dtp_nomax_unpadded_sm90), T9's head-major grid and K2's bucket for hd: s
clamped at shift + 88 and l + 1e-30 when `safe` (T5 always), neither
without it (the clamp +inf and the epsilon 0, run-time fields of one
instantiation); p = exp2(s - shift) in fp32, or bf16(exp2(bf16(s - shift)))
with `bf16_p`; l the fp32 sum of those p; bf16(p) into P V. T5 is T2's
safe launch on the wrapper's (B*h, L, hd) copies of the heads, launched as
B*h images of one head.

On the CPU: a torch emulation of the kernel's tile arithmetic (per head,
key tiles of the bucket's BKV, the clamp and the epsilon, the bf16 p, O
times 1 / l rounded once) against the TPU tool's nomax_attention in
interpret mode for every (safe, bf16_p) pair and against nomax_unpadded,
with the tool's exp2 of bf16 native and not; T5's emulation equal to
T2-safe's bit for bit; the unclamped emulation non-finite in exactly the
(image, row, head) the tool and the plain version are (chip_smoke's
overflow inputs); chip_smoke's P precision probe telling T2's bf16 p from
its fp32 p on the emulations; the kernel's integer rounding of the
difference to bf16 against round-to-nearest-even. The dispatch, refusal
and replay tests of both wrappers are test_torch_port_arms_sm90.py's
(WRAPPERS).

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_nomax_sm90.py): each T2 form
against its plain version at hd 40, 80 and 160, L 1100, 2 images of 4
heads; T5 equal to T2-safe and T2-safe to T7 on the head-major grid bit for
bit; the overflow rows; the P precision probe; each form's replays
bit-identical, eagerly and from a CUDA graph.
"""

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.ops import attention
from diffusiontexturepainting_torch.ops import attention_variants as arms

torch.set_num_threads(2)

# The JAX reference (the TPU tools) is imported by the CPU tests that use
# it: the card's machine, which runs the `cuda` tests, has no JAX.

LOG2E = 1.4426950408889634
SHIFT = 32.0
# two bf16 ulps at the outputs' magnitude (|o| < 2)
BF16_ATOL = 2.0**-7
# the tool's exp2 of bf16 unpatched (XLA's CPU exp2 of bf16 is exp(x *
# bf16(ln 2)), about 5% off near x = -32): the Watch list's atol for T2's
# bf16 p
XLA_EXP2_ATOL = 4e-2
# (safe, bf16_p): every form of T2
FORMS = [(True, False), (False, False), (False, True), (True, True)]
# (B, L, D, heads): hd 40 with ragged query and key tiles, hd 80 over two
# key tiles, hd 160 over the 64-key tiles of its bucket
EMULATED = [(2, 200, 160, 4), (1, 130, 160, 2), (1, 100, 320, 2)]


def emulate_nomax(q, k, v, heads, bkv, shift=SHIFT, safe=True,
                  bf16_p=False):
    """T2's kernel on the CPU (T5's on its split heads with heads 1): per
    (image, head), q scaled by scale*log2(e) and rounded; per key tile of
    bkv keys S in fp32, clamped at shift + 88 when `safe` (at +inf, no
    clamp, otherwise); d = s - shift in fp32; p = exp2(d) in fp32, or
    bf16(exp2(bf16(d))) with `bf16_p`; l the fp32 sum of p; O += bf16(p) v
    in fp32; O * 1 / (l + eps) rounded once, eps 1e-30 when `safe`, else
    0."""
    bf16 = torch.bfloat16
    qs, kh, vh = arms._heads(q, k, v, heads)
    qs, kh, vh = qs.float(), kh.float(), vh.float()
    cap = shift + 88.0 if safe else float("inf")
    o = torch.zeros(qs.shape)
    l = torch.zeros(qs.shape[:-1] + (1,))
    for j in range(0, kh.shape[2], bkv):
        s = qs @ kh[:, :, j:j + bkv].transpose(-1, -2)
        d = torch.clamp_max(s, cap) - shift
        p = torch.exp2(d.to(bf16)).to(bf16).float() if bf16_p \
            else torch.exp2(d)
        l += p.sum(-1, keepdim=True)
        o += p.to(bf16).float() @ vh[:, :, j:j + bkv]
    out = (o * (1.0 / (l + (1e-30 if safe else 0.0)))).to(q.dtype)
    return attention._merge_heads(out)


def emulate_unpadded(q, k, v, heads, bkv, shift=SHIFT):
    """T5's kernel on the CPU: T2-safe's emulation on the (B*h, L, hd)
    copies of the heads with one head, merged back."""
    qh, kh, vh = (arms.split_heads(t, heads) for t in (q, k, v))
    out = emulate_nomax(qh, kh, vh, 1, bkv, shift)
    return arms.merge_heads(out, q.shape[0])


def _bkv(q, heads):
    B, L, D = q.shape
    return attention.sm90_plan(D // heads, L, B * heads)["bkv"]


def _inputs(shape, seed):
    b, l, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, d)).astype(np.float32)
            for _ in range(3)]


def _tool(monkeypatch, native_exp2):
    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    if native_exp2:
        monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    return bench_attn_variants


def _interpret(fn, tensors, *args, **kwargs):
    """fn of the TPU tool on bf16 copies of `tensors` in interpret mode, as
    float32 numpy."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                   for t in tensors), *args, **kwargs)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("native_exp2", [False, True])
@pytest.mark.parametrize("safe,bf16_p", FORMS)
def test_emulated_nomax_matches_tool(monkeypatch, case, native_exp2, safe,
                                     bf16_p):
    """T2's emulation (the bucket's key tiles) against the tool's
    nomax_attention (bk = bq = L) in interpret mode and against
    plain_nomax_attention, bf16: atol 2^-7, but 4e-2 against the tool's
    unpatched exp2 of bf16 (T2's bf16 p; with fp32 p both exp2 agree)."""
    bench = _tool(monkeypatch, native_exp2)
    B, L, D, heads = case
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _inputs((B, L, D), 41))
    got = emulate_nomax(tq, tk, tv, heads, _bkv(tq, heads), safe=safe,
                        bf16_p=bf16_p).float().numpy()
    want = _interpret(bench.nomax_attention, (tq, tk, tv), heads, bk=L,
                      q_block=L, safe=safe, bf16_p=bf16_p)
    plain = arms.plain_nomax_attention(tq, tk, tv, heads, safe=safe,
                                       bf16_p=bf16_p).float().numpy()
    atol = XLA_EXP2_ATOL if bf16_p and not native_exp2 else BF16_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("native_exp2", [False, True])
def test_emulated_unpadded_matches_tool(monkeypatch, case, native_exp2):
    """T5's emulation (T2-safe's on the split heads, one head) equals
    T2-safe's bit for bit, and holds against the tool's nomax_unpadded (bq
    = L) in interpret mode with and without the native exp2 of bf16 (T5
    takes exp2 of fp32 logits, so both agree) and against
    plain_nomax_unpadded, bf16: atol 2^-7."""
    bench = _tool(monkeypatch, native_exp2)
    B, L, D, heads = case
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _inputs((B, L, D), 42))
    bkv = _bkv(tq, heads)
    got = emulate_unpadded(tq, tk, tv, heads, bkv)
    assert torch.equal(got, emulate_nomax(tq, tk, tv, heads, bkv))
    want = _interpret(bench.nomax_unpadded, (tq, tk, tv), heads, q_block=L)
    plain = arms.plain_nomax_unpadded(tq, tk, tv, heads).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.float().numpy(), plain, atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("shape,heads", [((1, 100, 160), 4),
                                         ((2, 130, 160), 2)], ids=str)
@pytest.mark.parametrize("bf16_p", [False, True])
def test_emulated_unclamped_nonfinite_rows_are_the_tools(monkeypatch, shape,
                                                         heads, bf16_p):
    """On chip_smoke's overflow inputs (base-2 logits above shift + 128 in
    every 7th query row), T2's unclamped emulation is non-finite in exactly
    the (image, row, head) the tool (interpret mode, its exp2 of bf16
    native) and the plain version are, some of them and only in the hot
    rows; elsewhere it holds against the plain version at atol 2^-7. The
    safe emulation is finite everywhere."""
    import chip_smoke

    bench = _tool(monkeypatch, True)
    gen = torch.Generator().manual_seed(5)
    tq, tk, tv, hot = chip_smoke.overflow_inputs(*shape, gen, device="cpu")
    bkv = _bkv(tq, heads)
    got = emulate_nomax(tq, tk, tv, heads, bkv, safe=False, bf16_p=bf16_p)
    plain = arms.plain_nomax_attention(tq, tk, tv, heads, bf16_p=bf16_p)
    want = torch.from_numpy(_interpret(
        bench.nomax_attention, (tq, tk, tv), heads, bk=shape[1],
        q_block=shape[1], bf16_p=bf16_p))
    mask = chip_smoke.nonfinite_heads(got, heads)
    assert torch.equal(mask, chip_smoke.nonfinite_heads(want, heads))
    assert torch.equal(mask, chip_smoke.nonfinite_heads(plain, heads))
    assert mask.any() and not mask[:, ~hot].any()
    cold = ~hot
    np.testing.assert_allclose(got[:, cold].float().numpy(),
                               plain[:, cold].float().numpy(),
                               atol=BF16_ATOL, rtol=0)
    assert torch.isfinite(emulate_nomax(tq, tk, tv, heads, bkv,
                                        bf16_p=bf16_p)).all()


@pytest.mark.parametrize("shape,heads", [((1, 256, 320), 8),
                                         ((2, 130, 640), 4)], ids=str)
def test_p_precision_probe_parts_t2_bf16p_from_fp32p(shape, heads):
    """chip_smoke's P precision probe on the emulations: T2 with fp32 p is
    P_PRECISION_MARGIN times nearer the bf16-rounded float64 evaluation
    with bf16(p) in P V than the one with p = bf16(exp2(bf16(s - shift))),
    T2 with bf16 p the other way round; T5 is T2-safe's."""
    import chip_smoke

    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _inputs(shape, 13))
    bkv = _bkv(tq, heads)
    for got, own, other in (
            (emulate_nomax(tq, tk, tv, heads, bkv), 1, 2),
            (emulate_nomax(tq, tk, tv, heads, bkv, safe=False), 1, 2),
            (emulate_nomax(tq, tk, tv, heads, bkv, safe=False,
                           bf16_p=True), 2, 1),
            (emulate_unpadded(tq, tk, tv, heads, bkv), 1, 2)):
        dist = chip_smoke.p_precision(got, tq, tk, tv, heads)
        assert chip_smoke.P_PRECISION_MARGIN * dist[own] <= dist[other], (
            own, dist)


def test_emulated_underflow_gives_zeros_when_safe():
    """Every logit far below shift - 126: p is 0 everywhere; safe, O / (0
    + 1e-30) is 0 with either p; unclamped, 0 / 0 is NaN, as the tool's."""
    q = torch.full((1, 70, 160), 60.0).bfloat16()
    v = torch.randn((1, 70, 160)).bfloat16()
    for bf16_p in (False, True):
        got = emulate_nomax(q, -q, v, 4, 128, bf16_p=bf16_p)
        assert torch.equal(got, torch.zeros_like(got))
        assert torch.isnan(emulate_nomax(q, -q, v, 4, 128, safe=False,
                                         bf16_p=bf16_p)).all()
    got = emulate_unpadded(q, -q, v, 4, 128)
    assert torch.equal(got, torch.zeros_like(got))


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(shape, gen):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("safe,bf16_p", FORMS)
def test_sm90_nomax_forms_match_plain(hd, safe, bf16_p):
    """Each T2 form against its plain version at L 1100 (a ragged last
    tile), 2 images of 4 heads, and with fewer keys than queries
    (chip_smoke's tolerance: 2^-5 of the largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    for lk in (1100, 1000):
        key = ((2, 1100, 4 * hd), (2, lk, 4 * hd), 4, safe, bf16_p)
        r = chip_smoke.compare("nomax_attention", key, torch.bfloat16, gen)
        assert r["err_over_tol"] <= 1.0, (key, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((2, 1100, 160), 4),
                                         ((2, 1100, 320), 4),
                                         ((2, 1100, 640), 4),
                                         ((3, 1024, 1280), 8)], ids=str)
def test_sm90_unpadded_equals_nomax_safe(shape, heads):
    """T5 (the copies of the heads, one head a launch) gives T2-safe's
    bits, and T2-safe those of T7 on T9's head-major grid (one launch, the
    same bucket); both within tolerance of T5's plain version."""
    gen = _setup()
    q, k, v = _rnd(shape, gen)
    t2 = arms.nomax_attention(q, k, v, heads, safe=True)
    assert torch.equal(arms.nomax_unpadded(q, k, v, heads), t2)
    assert torch.equal(arms._nomax_allheads(q, k, v, heads,
                                            head_major=True), t2)
    want = arms.plain_nomax_unpadded(q, k, v, heads).float()
    assert ((t2.float() - want).abs().max().item()
            <= 2.0**-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_sm90_unclamped_overflows_where_plain_does(hd, bf16_p):
    """chip_smoke's overflow probe: T2 unclamped is non-finite in exactly
    the (image, row, head) its plain version is, some and all in the hot
    rows; T2-safe and T5 are finite there."""
    gen = _setup()
    import chip_smoke

    q, k, v, hot = chip_smoke.overflow_inputs(2, 1100, 4 * hd, gen)
    mask = chip_smoke.nonfinite_heads(
        arms.nomax_attention(q, k, v, 4, bf16_p=bf16_p), 4)
    want = chip_smoke.nonfinite_heads(
        arms.plain_nomax_attention(q, k, v, 4, bf16_p=bf16_p), 4)
    assert torch.equal(mask, want)
    assert want.any() and not want[:, ~hot].any()
    for got in (arms.nomax_attention(q, k, v, 4, safe=True, bf16_p=bf16_p),
                arms.nomax_unpadded(q, k, v, 4)):
        assert torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
def test_sm90_nomax_p_precision(hd):
    """On the card, T2 with fp32 p (either clamp) and T5 are
    P_PRECISION_MARGIN times nearer the float64 evaluation with bf16(p) in
    P V than the one with bf16(exp2(bf16(s - shift))), T2 with bf16 p the
    other way round (a kernel that mistook its p passes every tolerance
    check)."""
    gen = _setup()
    import chip_smoke

    q, k, v = _rnd((2, 1100, 4 * hd), gen)
    for got, own, other in (
            (arms.nomax_attention(q, k, v, 4, safe=True), 1, 2),
            (arms.nomax_attention(q, k, v, 4), 1, 2),
            (arms.nomax_attention(q, k, v, 4, bf16_p=True), 2, 1),
            (arms.nomax_attention(q, k, v, 4, safe=True, bf16_p=True), 2,
             1),
            (arms.nomax_unpadded(q, k, v, 4), 1, 2)):
        dist = chip_smoke.p_precision(got, q, k, v, 4)
        assert chip_smoke.P_PRECISION_MARGIN * dist[own] <= dist[other], (
            own, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("safe,bf16_p", FORMS)
def test_sm90_nomax_forms_replay_bit_identical(safe, bf16_p):
    """Each T2 form: two eager calls and one replayed from a CUDA graph give
    the same bits at the attn_arms path's L2 shape and a ragged hd-40
    one."""
    gen = _setup()
    for shape, heads in (((3, 1024, 1280), 8), ((2, 1100, 320), 8)):
        q, k, v = _rnd(shape, gen)

        def call():
            return arms.nomax_attention(q, k, v, heads, safe=safe,
                                        bf16_p=bf16_p)
        first, again = call(), call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, captured)


def round_bf16_int(x):
    """csrc/flash_attention_sm90.cu round_bf16_int on float32 numpy x: the
    bits plus 0x7fff plus the lowest kept bit, the low half cleared."""
    u = x.view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def test_integer_rounding_is_round_to_nearest_even():
    """T2's bf16 p rounds its difference in integer operations: over
    normal, subnormal, huge and infinite floats and exact ties, the bits
    are torch's round-to-nearest-even bf16 conversion's (cvt.rn's), and
    the source holds the expression mirrored here."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    x = x[~np.isnan(x)]
    ties = (rng.integers(0, 2**16, 4096).astype(np.uint32) << 16) | 0x8000
    x = np.concatenate([x, ties.view(np.float32),
                        rng.standard_normal(10_000).astype(np.float32) * 40,
                        np.array([np.inf, -np.inf, 3.4e38, -3.4e38, 1e-40,
                                  -1e-45, 0.0, -0.0], np.float32)])
    x = x[~np.isnan(x)]
    want = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(round_bf16_int(x).view(np.uint32),
                                  want.view(np.uint32))
    src = (arms._cuda.CSRC / "flash_attention_sm90.cu").read_text()
    assert ("(u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u" in src)
