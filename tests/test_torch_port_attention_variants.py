"""The softmax arms of the attention kernels (T2 no-max, T3 chunked, T5
unpadded no-max, T9 transposed P V) against the JAX repository's A/B tools,
tools/bench_attn_variants.py and tools/bench_attn_round4.py, whose Pallas
kernels run here in interpret mode on the same seeded numpy inputs. On the
CPU the port's wrappers run their plain versions; the CUDA kernel is held
against those on the card (test_torch_port_cuda.py, chip_smoke.py)."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.ops import attention as t_attn
from diffusiontexturepainting_torch.ops import attention_variants as arms
from diffusiontexturepainting_torch.tools import attn_variants as tool
from tools import bench_attn_round4, bench_attn_variants

torch.set_num_threads(2)

# (B, L, D, heads): head dims 40 and 80
SHAPES = {"hd40": (1, 256, 80, 2), "hd80": (2, 128, 160, 2)}
FP32_TOL = dict(atol=3e-5, rtol=1e-4)


class TPUExp2:
    """Stands in for `jax.numpy` in a tool module and is jnp but for exp2
    of a bf16 array, which it evaluates as a native exp2 (what Mosaic emits
    on a TPU with a libtpu from 2025-07-26 on). XLA on the CPU evaluates
    exp2 of bf16 as exp(x * bf16(ln 2)), 0.25% off; the port runs a native
    exp2, so the unpatched comparison gets a wider tolerance."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        if x.dtype == jnp.bfloat16:
            return jnp.exp2(x.astype(jnp.float32)).astype(jnp.bfloat16)
        return jnp.exp2(x)


def _inputs(shape, seed=0, scale=(1.0, 1.0, 1.0)):
    b, l, d, _ = shape
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, l, d)) * s).astype(np.float32)
            for s in scale]


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of one dtype from the same numpy data."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax(fn, *args, **kwargs):
    with pltpu.force_tpu_interpret_mode():
        return _np(fn(*args, **kwargs))


def _tol(dtype):
    return FP32_TOL if dtype == "float32" else dict(atol=2.0**-7, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_nomax_matches_tool(monkeypatch, shape, dtype, safe, bf16_p):
    """T2 with each option. fp32: atol 3e-5, rtol 1e-4 (summation order).
    bf16: atol 2^-7, two bf16 ulps at the outputs' magnitude, with the
    tool's exp2 of bf16 native (TPUExp2); the tool chunks keys by bk = Lk
    (its default 4096 would give no chunk at all)."""
    if bf16_p:
        monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    heads = SHAPES[shape][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES[shape]), dtype)
    want = _jax(bench_attn_variants.nomax_attention, jq, jk, jv, heads,
                bk=jk.shape[1], bf16_p=bf16_p, safe=safe)
    got = arms.nomax_attention(tq, tk, tv, heads, safe=safe, bf16_p=bf16_p)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


@pytest.mark.parametrize("arm,atol", [("nomax", 4e-2), ("chunked", 1e-2)])
def test_bf16_p_against_xla_exp2(arm, atol):
    """bf16_p against the tool unpatched: XLA's CPU exp2 of a bf16 x is
    exp(x * bf16(ln 2)), off by a factor exp(0.0017 x). Against the row
    max (T3) x lies in [-10, 0]: atol 1e-2. Against the static shift (T2)
    x lies near -32, where that factor is ~5% and varies with x: atol
    4e-2 (measured 2.7e-2)."""
    heads = SHAPES["hd40"][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES["hd40"], 1),
                                       "bfloat16")
    if arm == "nomax":
        want = _jax(bench_attn_variants.nomax_attention, jq, jk, jv, heads,
                    bk=jk.shape[1], bf16_p=True)
        got = arms.nomax_attention(tq, tk, tv, heads, bf16_p=True)
    else:
        want = _jax(bench_attn_variants.chunked_attention, jq, jk, jv, heads,
                    bk=64, bf16_p=True)
        got = arms.chunked_attention(tq, tk, tv, heads, bk=64, bf16_p=True)
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_chunked_matches_tool(monkeypatch, shape, dtype, bk, bf16_p):
    """T3 at the same chunk width on both sides (the width moves the
    rounding of bf16 p); tolerances as T2's."""
    if bf16_p:
        monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    heads = SHAPES[shape][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES[shape], 2), dtype)
    want = _jax(bench_attn_variants.chunked_attention, jq, jk, jv, heads,
                bk=bk, bf16_p=bf16_p)
    got = arms.chunked_attention(tq, tk, tv, heads, bk=bk, bf16_p=bf16_p)
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


def test_chunked_width_is_rounding_only_in_fp32():
    """fp32: the port at bk 64 against the tool at bk 128, the same
    function up to summation order."""
    heads = SHAPES["hd40"][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES["hd40"], 3),
                                       "float32")
    want = _jax(bench_attn_variants.chunked_attention, jq, jk, jv, heads,
                bk=128)
    got = arms.chunked_attention(tq, tk, tv, heads, bk=64)
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", ["unpadded", "pvt"])
def test_unpadded_and_pvt_match_tools(shape, dtype, arm):
    """T5 and T9 (fp32 exp2 throughout: no patch needed)."""
    heads = SHAPES[shape][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES[shape], 4), dtype)
    if arm == "unpadded":
        want = _jax(bench_attn_variants.nomax_unpadded, jq, jk, jv, heads)
        got = arms.nomax_unpadded(tq, tk, tv, heads)
    else:
        want = _jax(bench_attn_round4.pvt_attention, jq, jk, jv, heads)
        got = arms.pvt_attention(tq, tk, tv, heads)
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


def test_pvt_keeps_p_in_fp32():
    """bf16 inputs (1, 256, 80), 2 heads: over the whole output T9's plain
    version is closer in mean |diff| to a float64 evaluation with unrounded
    p than to one with bf16 p, and T5's the other way round; the tool
    kernels agree with their ports within 2^-7."""
    heads = 2
    q, k, v = _inputs(SHAPES["hd40"], 5)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    # float64 from the bf16 values, q pre-scaled and rounded as the arms do
    qs = arms._heads(tq, tk, tv, heads)[0].double()
    kh, vh = (t_attn._split_heads(t, heads).double() for t in (tk, tv))
    s = torch.clamp_max(qs @ kh.transpose(-1, -2), 32.0 + 88.0) - 32.0
    p = torch.exp2(s)
    l = p.sum(-1, keepdim=True) + 1e-30
    exact = t_attn._merge_heads((p @ vh) / l)
    rounded = t_attn._merge_heads(
        (p.to(torch.bfloat16).double() @ vh) / l)
    dist = lambda a, b: (a.double() - b).abs().mean().item()
    t9 = arms.pvt_attention(tq, tk, tv, heads)
    t5 = arms.nomax_unpadded(tq, tk, tv, heads)
    assert dist(t9, exact) < dist(t9, rounded)
    assert dist(t5, rounded) < dist(t5, exact)
    for got, fn in ((t9, bench_attn_round4.pvt_attention),
                    (t5, bench_attn_variants.nomax_unpadded)):
        np.testing.assert_allclose(_np(got), _jax(fn, jq, jk, jv, heads),
                                   atol=2.0**-7, rtol=0)


def _clamp_inputs(shape):
    """q, k with raw logits q.k/sqrt(hd) far above 83 (std ~60)."""
    q, k, v = _inputs(shape, 6)
    return q * 8.0, k * 8.0, v


@pytest.mark.parametrize("arm", ["safe", "unpadded", "pvt", "chunked"])
def test_clamp_corner(arm):
    """Raw logits above 83 (base-2 logits above shift + 88): the clamped
    arms equal their tools (fp32) and differ from the exact softmax, the
    chunked arm equals the exact softmax (its running max)."""
    shape = SHAPES["hd40"]
    heads = shape[3]
    (jq, jk, jv), (tq, tk, tv) = _both(_clamp_inputs(shape), "float32")
    exact = _np(t_attn.plain_attention_streaming(tq, tk, tv, heads))
    if arm == "chunked":
        got = _np(arms.chunked_attention(tq, tk, tv, heads, bk=64))
        np.testing.assert_allclose(got, exact, atol=1e-4, rtol=0)
        return
    if arm == "safe":
        got = arms.nomax_attention(tq, tk, tv, heads, safe=True)
        want = _jax(bench_attn_variants.nomax_attention, jq, jk, jv, heads,
                    bk=jk.shape[1], safe=True)
    elif arm == "unpadded":
        got = arms.nomax_unpadded(tq, tk, tv, heads)
        want = _jax(bench_attn_variants.nomax_unpadded, jq, jk, jv, heads)
    else:
        got = arms.pvt_attention(tq, tk, tv, heads)
        want = _jax(bench_attn_round4.pvt_attention, jq, jk, jv, heads)
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)
    assert np.abs(_np(got) - exact).max() > 0.1


def _underflow_inputs(shape):
    """Every base-2 logit near -hd * 60^2 / sqrt(hd) * log2(e): far below
    shift - 126, so every exp2 underflows to 0."""
    b, l, d, _ = shape
    q = np.full((b, l, d), 60.0, np.float32)
    k = np.full((b, l, d), -60.0, np.float32)
    v = np.random.default_rng(7).standard_normal((b, l, d)).astype(
        np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_underflow_corner(dtype):
    """Every logit underflows: the safe arms give zeros, not NaN, as their
    tools do; T2 without `safe` divides 0 by 0, as its tool does."""
    shape = SHAPES["hd40"]
    heads = shape[3]
    (jq, jk, jv), (tq, tk, tv) = _both(_underflow_inputs(shape), dtype)
    for got, fn, kw in (
            (arms.nomax_attention(tq, tk, tv, heads, safe=True),
             bench_attn_variants.nomax_attention,
             dict(bk=jk.shape[1], safe=True)),
            (arms.nomax_unpadded(tq, tk, tv, heads),
             bench_attn_variants.nomax_unpadded, {}),
            (arms.pvt_attention(tq, tk, tv, heads),
             bench_attn_round4.pvt_attention, {})):
        assert torch.equal(got, torch.zeros_like(got))
        np.testing.assert_array_equal(_jax(fn, jq, jk, jv, heads, **kw), 0)
    unsafe = arms.nomax_attention(tq, tk, tv, heads)
    assert torch.isnan(unsafe).all()
    assert np.isnan(_jax(bench_attn_variants.nomax_attention, jq, jk, jv,
                         heads, bk=jk.shape[1])).all()


@pytest.mark.parametrize("call", [
    lambda x: arms.nomax_attention(x, x, x, 2, bk=100),
    lambda x: arms.nomax_attention(x, x, x, 2, bk=0),
    lambda x: arms.chunked_attention(x, x, x, 2, bk=96),
    lambda x: arms.plain_chunked_attention(x, x, x, 2, bk=200),
])
def test_bk_not_dividing_lk_raises(call):
    """The tools' Lk // bk drops the tail keys; the port raises."""
    with pytest.raises(ValueError, match="must divide"):
        call(torch.zeros(1, 256, 16))


def test_plain_versions_block_queries():
    """A small score budget splits the queries into ragged blocks and gives
    the same output."""
    heads = 2
    _, (tq, tk, tv) = _both(_inputs(SHAPES["hd40"], 8), "float32")
    budget = 4 * heads * 256 * 100  # 100 query rows of scores
    for _, plain in arms.ARMS.values():
        kw = dict(bk=64) if plain is arms.plain_chunked_attention else {}
        whole = plain(tq, tk, tv, heads, **kw)
        chunk_budget = 4 * heads * 64 * 100 if kw else budget
        blocked = plain(tq, tk, tv, heads, block_bytes=chunk_budget, **kw)
        torch.testing.assert_close(blocked, whole, rtol=0, atol=1e-6)


def test_wrappers_reject_other_devices():
    meta = torch.zeros(1, 4, 8, device="meta")
    for wrapper, _ in arms.ARMS.values():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            wrapper(meta, meta, meta, 2, **(
                dict(bk=4) if wrapper is arms.chunked_attention else {}))


def test_entry_point_rows_on_cpu(capsys):
    """The port of the tools' main(): every row at the tiny shapes, with
    the plain versions standing in for the kernels, then one JSON line."""
    assert tool.main(["--device", "cpu", "--shapes", "tiny"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    record = json.loads(out[-1])
    assert record["device"] == "cpu"
    rows = {(r["shape"], r["row"]) for r in record["rows"]}
    for label, _, L, *_ in tool.SHAPE_SETS["tiny"]:
        for row in tool.ROWS:
            # T3's tool chunks (512 and up) under the tool's rule: none
            # divides a tiny L and differs from it
            assert ((label, row) in rows) == tool.applies(row, L)
            assert any(line.startswith(f"{label} {row} ")
                       for line in out[:-1]) == tool.applies(row, L), (
                label, row)
    for r in record["rows"]:
        assert r["ms"] is None  # no device, no time
        if r["row"] not in ("base", "sdpa") and r["finite"]:
            assert r["max_abs_diff_plain"] == 0.0
        if r["input_set"] == "clamp" and r["row"] == "nomax":
            assert not r["finite"]  # overflow without `safe`, as on a TPU
        if r["input_set"] == "default":
            assert r["max_abs_diff_base"] < 0.05
