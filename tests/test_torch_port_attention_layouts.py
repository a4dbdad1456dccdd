"""The layout arms of the attention kernels (T6 nomax_4d, T7 nomax_allheads,
T8 nomax_laneslice) and the slotted-input arm (T4 slotted_kernel_call)
against the JAX repository's tools/bench_attn_variants.py, whose Pallas
kernels run here in interpret mode on the same seeded numpy inputs; and T5's
repaired wrapper (heads split by one copy pass, then merged). On the CPU the
port's wrappers run their plain versions; the CUDA kernels are held against
those on the card (test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.ops import attention as t_attn
from diffusiontexturepainting_torch.ops import attention_variants as arms
from diffusiontexturepainting_torch.tools import attn_variants as tool
from diffusiontexturepainting_tpu.ops import flash_attention as j_fa
from tests.test_torch_port_attention_variants import TPUExp2
from tools import bench_attn_variants

torch.set_num_threads(2)

# (B, L, D, heads): head dims 40 and 80
SHAPES = {"hd40": (1, 256, 80, 2), "hd80": (2, 256, 160, 2)}
SLOT = 128  # the tool's hd_pad for hd <= 128
FP32_TOL = dict(atol=3e-5, rtol=1e-4)
# two bf16 ulps at the outputs' magnitude (|o| < 2)
BF16_TOL = dict(atol=2.0**-7, rtol=0)
LAYOUT_ARMS = {"4d": (arms.nomax_4d, bench_attn_variants.nomax_4d),
               "allheads": (arms.nomax_allheads,
                            bench_attn_variants.nomax_allheads),
               "laneslice": (arms.nomax_laneslice,
                             bench_attn_variants.nomax_laneslice)}


def _inputs(shape, seed=0):
    b, l, d, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, d)).astype(np.float32)
            for _ in range(3)]


def _slotted(arrays, heads):
    """(B, L, h*hd) -> (B*h, L, 128) with zero pad lanes: the tool's split
    and pad (bench_attn_variants.py:502-511), in numpy."""
    out = []
    for a in arrays:
        b, l, d = a.shape
        hd = d // heads
        x = a.reshape(b, l, heads, hd).transpose(0, 2, 1, 3)
        pad = np.zeros((b * heads, l, SLOT), np.float32)
        pad[..., :hd] = x.reshape(b * heads, l, hd)
        out.append(pad)
    return out


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
    return FP32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", list(LAYOUT_ARMS))
def test_layout_arms_match_tools(shape, dtype, arm):
    """T6, T7, T8 against their tools at their default q blocks (one block
    of 256 queries here). fp32: atol 3e-5, rtol 1e-4 (summation order).
    bf16: atol 2^-7 (fp32 exp2 throughout: no patch needed)."""
    port, tool_fn = LAYOUT_ARMS[arm]
    heads = SHAPES[shape][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(SHAPES[shape]), dtype)
    got = port(tq, tk, tv, heads)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _jax(tool_fn, jq, jk, jv, heads),
                               **_tol(dtype))


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exp2_bf16", [True, False])
def test_slotted_matches_tool(monkeypatch, shape, dtype, exp2_bf16):
    """T4 over the tool's (B*h, L, 128) head slots, with bq = L: the tool's
    default bq=512 is not clamped to L, so at L 256 its grid is empty
    (test_slotted_tool_default_grid_is_empty). The tool's exp2 of bf16 is
    made native (TPUExp2 on the JAX package's flash_attention module, whose
    _attn_kernel it runs). Tolerance: atol 3e-5 and rtol 1e-4 in fp32
    with fp32 logits; else atol 2^-7, for a bf16 p the summation order of s
    may move by one bf16 ulp."""
    monkeypatch.setattr(j_fa, "jnp", TPUExp2())
    b, l, d, heads = SHAPES[shape]
    scale = (d // heads) ** -0.5
    (jq, jk, jv), (tq, tk, tv) = _both(
        _slotted(_inputs(SHAPES[shape], 1), heads), dtype)
    want = _jax(bench_attn_variants.slotted_kernel_call, jq, jk, jv, scale,
                bq=l, exp2_bf16=exp2_bf16)
    got = arms.slotted_kernel_call(tq, tk, tv, scale, exp2_bf16=exp2_bf16)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    tol = FP32_TOL if dtype == "float32" and not exp2_bf16 else BF16_TOL
    np.testing.assert_allclose(_np(got), want, **tol)
    assert not _np(got)[..., d // heads:].any()  # zero pad lanes out


def test_slotted_against_xla_exp2():
    """exp2_bf16 against the tool unpatched: XLA's CPU exp2 of a bf16 x is
    exp(x * bf16(ln 2)), off by a factor exp(0.0017 x); against the row max
    x lies in [-10, 0]: atol 1e-2, as K13's unpatched comparison."""
    b, l, d, heads = SHAPES["hd40"]
    scale = (d // heads) ** -0.5
    (jq, jk, jv), (tq, tk, tv) = _both(
        _slotted(_inputs(SHAPES["hd40"], 2), heads), "bfloat16")
    want = _jax(bench_attn_variants.slotted_kernel_call, jq, jk, jv, scale,
                bq=l)
    got = arms.slotted_kernel_call(tq, tk, tv, scale)
    np.testing.assert_allclose(_np(got), want, atol=1e-2, rtol=0)


def test_slotted_tool_default_grid_is_empty():
    """The tool's grid is (BH, Lq // 512): below 512 queries it has no step
    and leaves its output unwritten; the port computes every row."""
    b, l, d, heads = SHAPES["hd40"]
    scale = (d // heads) ** -0.5
    (jq, jk, jv), (tq, tk, tv) = _both(
        _slotted(_inputs(SHAPES["hd40"], 3), heads), "float32")
    full = _jax(bench_attn_variants.slotted_kernel_call, jq, jk, jv, scale,
                bq=l, exp2_bf16=False)
    default = _jax(bench_attn_variants.slotted_kernel_call, jq, jk, jv,
                   scale, exp2_bf16=False)
    assert not np.allclose(default, full)
    got = arms.slotted_kernel_call(tq, tk, tv, scale, exp2_bf16=False)
    np.testing.assert_allclose(_np(got), full, **FP32_TOL)


@pytest.mark.parametrize("arm", ["slotted"] + list(LAYOUT_ARMS))
def test_tail_rows_are_computed(arm):
    """L 320 with q blocks of 256: the tools' Lq // bq grid computes the
    first 256 rows only. The port computes every row: its first 256 equal
    the tool's at that block, the rest equal the tool's at one block of
    all 320 rows (fp32)."""
    shape = (1, 320, 80, 2)
    heads = shape[3]
    arrays = _inputs(shape, 4)
    if arm == "slotted":
        arrays = _slotted(arrays, heads)
        scale = 40**-0.5

        def port(q, k, v):
            return arms.slotted_kernel_call(q, k, v, scale, exp2_bf16=False)

        def tool_at(bq, q, k, v):
            return bench_attn_variants.slotted_kernel_call(
                q, k, v, scale, bq=bq, exp2_bf16=False)
    else:
        wrapper, tool_fn = LAYOUT_ARMS[arm]

        def port(q, k, v):
            return wrapper(q, k, v, heads)

        def tool_at(bq, q, k, v):
            return tool_fn(q, k, v, heads, q_block=bq)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    got = _np(port(tq, tk, tv))
    head = _jax(tool_at, 256, jq, jk, jv)
    whole = _jax(tool_at, 320, jq, jk, jv)
    np.testing.assert_allclose(got[:, :256], head[:, :256], **FP32_TOL)
    np.testing.assert_allclose(got, whole, **FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpadded_split_pass_round_trip(dtype):
    """T5's repaired CUDA wrapper, its data flow on the CPU: split_heads
    makes the tool's contiguous (B*h, L, hd) copies, the function run on
    them with one head and merge_heads give T5's output (the same bits in
    fp32 and bf16)."""
    b, l, d, heads = SHAPES["hd80"]
    _, (tq, tk, tv) = _both(_inputs(SHAPES["hd80"], 6), dtype)
    qh = arms.split_heads(tq, heads)
    assert qh.shape == (b * heads, l, d // heads) and qh.is_contiguous()
    want = tq.reshape(b, l, heads, d // heads).permute(0, 2, 1, 3)
    assert torch.equal(qh, want.reshape(b * heads, l, d // heads))
    assert torch.equal(arms.merge_heads(qh, b), tq)
    kh, vh = arms.split_heads(tk, heads), arms.split_heads(tv, heads)
    got = arms.merge_heads(arms.plain_nomax_unpadded(qh, kh, vh, 1), b)
    assert got.is_contiguous()
    assert torch.equal(got, arms.plain_nomax_unpadded(tq, tk, tv, heads))


@pytest.mark.parametrize("exp2_bf16", [True, False])
def test_slotted_is_k13s_function(exp2_bf16):
    """T4's plain version over the split slots and K13's over the
    (B, L, h*128) layout of the same bf16 data agree once both are cut back
    to (B, L, h*hd): the same function (zero lanes add nothing; atol 1e-6
    for the matmuls' blocking). With exp2_bf16 False T4 is not K13's
    function: it differs by the bf16 rounding of p."""
    b, l, d, heads = SHAPES["hd40"]
    hd = d // heads
    _, (tq, tk, tv) = _both(_inputs(SHAPES["hd40"], 7), "bfloat16")
    slots = [tool.to_slots(t, heads) for t in (tq, tk, tv)]
    k13 = tool.from_layout(
        t_attn.plain_attention_slotted(*slots, heads, hd), "slots", b,
        heads, hd)
    t4 = tool.from_layout(
        arms.plain_slotted_kernel_call(
            *(arms.split_heads(s, heads) for s in slots), hd**-0.5,
            exp2_bf16=exp2_bf16), "heads", b, heads, hd)
    err = (t4.float() - k13.float()).abs().max().item()
    if exp2_bf16:
        assert err <= 1e-6
    else:
        assert 0 < err <= 2.0**-6


def test_entry_point_skips_slotted_rows_beyond_the_slot():
    """At hd 160 neither K13 nor T4 (P = 256 > 160) applies: run_shape
    gives every other row and no slotted one; at hd 80 the T4 rows diff
    against K13 (base-slotted). At 128 keys T3's tool chunks (512 and up)
    do not apply either (the tool's rule)."""
    gen = torch.Generator().manual_seed(0)
    rows = tool.run_shape("hd160", 1, 128, 320, 2, "variants", "cpu", gen)
    got = [r["row"] for r in rows]
    assert got == [r for r in tool.ROWS
                   if tool.layout(r) == "proj" and tool.applies(r, 128)]
    rows = tool.run_shape("hd80", 1, 128, 160, 2, "variants", "cpu", gen)
    by_row = {r["row"]: r for r in rows}
    assert list(by_row) == [r for r in tool.ROWS if tool.applies(r, 128)]
    for row in tool.SLOTTED_ROWS:
        assert by_row[row]["base_row"] == "base-slotted"
        assert by_row[row]["max_abs_diff_base"] < 0.02
    assert by_row["base-slotted"]["base_row"] == "base"
