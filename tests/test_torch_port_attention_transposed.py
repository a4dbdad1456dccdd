"""The transposed-product arms of the attention kernels (T1
sublane_attention, T10 pv_product) against the JAX repository's
tools/bench_attn_sublane.py and tools/bench_pv_transpose.py, whose Pallas
kernels run here in interpret mode on the same seeded numpy inputs. On the
CPU the port's wrappers run their plain versions; the CUDA kernels are held
against those on the card (test_torch_port_cuda.py, chip_smoke.py)."""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.ops import attention_variants as arms
from diffusiontexturepainting_torch.tools import attn_sublane, pv_transpose
from tests.test_torch_port_attention_variants import TPUExp2
from tools import bench_attn_sublane, bench_pv_transpose

torch.set_num_threads(2)

# (B, Lq, Lk, heads, hd): the three head dims, keys off 128
T1_SHAPES = {"hd40": (1, 256, 256, 2, 40), "hd80": (2, 128, 200, 2, 80),
             "hd160": (1, 128, 72, 2, 160)}
# (bh, bq, Lk, hd)
T10_SHAPES = {"hd40": (1, 64, 136, 40), "hd80": (2, 32, 128, 80),
              "hd160": (1, 24, 40, 160)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, dtype, bf16_rel=2.0**-7):
    """fp32: 1e-5 of the output's peak (summation order); bf16: 2^-7 of it
    (two bf16 ulps at that magnitude)."""
    peak = np.abs(want).max()
    rel = 1e-5 if dtype == "float32" else bf16_rel
    np.testing.assert_allclose(got, want, atol=rel * peak, rtol=0)


def _qkv(shape, seed=0):
    b, lq, lk, heads, hd = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, heads * hd)).astype(np.float32)
            for l in (lq, lk, lk)]


def _jax_sublane(jq, jk, jv, heads):
    with pltpu.force_tpu_interpret_mode():
        return _np(bench_attn_sublane.sublane_attention(jq, jk, jv,
                                                        num_heads=heads))


@pytest.mark.parametrize("shape", list(T1_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("native_exp2", [True, False])
def test_sublane_matches_tool(monkeypatch, shape, dtype, native_exp2):
    """T1 against its tool at hd 40, 80, 160, with the tool's exp2 native
    (TPUExp2 patched in) at 1e-5 (fp32) and 2^-7 (bf16) of the peak, and
    unpatched at 1e-2 as the other arms (T1 takes exp2 of fp32 logits, so
    the patch changes nothing here: both hold the tight tolerance's
    function)."""
    if native_exp2:
        monkeypatch.setattr(bench_attn_sublane, "jnp", TPUExp2())
    heads = T1_SHAPES[shape][3]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(T1_SHAPES[shape]), dtype)
    got = arms.sublane_attention(tq, tk, tv, heads)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    want = _jax_sublane(jq, jk, jv, heads)
    if native_exp2:
        _close(_np(got), want, dtype)
    else:
        np.testing.assert_allclose(_np(got), want, atol=1e-2, rtol=0)


def test_sublane_tool_raises_off_its_block_and_the_port_computes():
    """Lq 320: the tool pads the queries to two blocks of 256 and reshapes
    the 512 padded rows as 320 (no slice of lq_pad): it raises. The port
    computes every query length: its rows equal the tool's on the same
    keys at Lq 256 and at the remaining 64 rows padded to 128."""
    heads = 2
    q, k, v = _qkv((1, 320, 320, heads, 40), 3)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "float32")
    with pytest.raises((TypeError, ValueError)):
        _jax_sublane(jq, jk, jv, heads)
    got = _np(arms.sublane_attention(tq, tk, tv, heads))
    assert got.shape == (1, 320, 80)
    head = _jax_sublane(jq[:, :256], jk, jv, heads)
    tail_q = jnp.pad(jq[:, 256:], ((0, 0), (0, 64), (0, 0)))
    tail = _jax_sublane(tail_q, jk, jv, heads)[:, :64]
    _close(got[:, :256], head, "float32")
    _close(got[:, 256:], tail, "float32")


def test_sublane_rounds_q_and_e_where_the_tool_does():
    """bf16: q is rounded after the scale and e before the second product.
    Dropping either rounding moves the output: the plain version follows
    the tool, an unrounded softmax of the same inputs differs from it."""
    heads = 2
    _, (tq, tk, tv) = _both(_qkv((1, 128, 128, heads, 40), 4), "bfloat16")
    got = arms.plain_sublane_attention(tq, tk, tv, heads).float()
    qh, kh, vh = (t.float().view(1, 128, heads, 40).transpose(1, 2)
                  for t in (tq, tk, tv))
    exact = torch.softmax(qh @ kh.transpose(-1, -2) * 40**-0.5, -1) @ vh
    exact = exact.transpose(1, 2).reshape(1, 128, 80)
    err = (got - exact).abs().max().item()
    assert 0 < err <= 2.0**-6


def _jax_pv(je, jv, transposed, iters):
    """The tool's Pallas call (bench_shape builds it around its own
    inputs), on the given arrays."""
    bh, bq, lk = je.shape
    hd = jv.shape[2]
    kern = functools.partial(bench_pv_transpose._pv_kernel,
                             transposed=transposed, iters=iters)

    build = functools.partial(
        pl.pallas_call, kern,
        out_shape=jax.ShapeDtypeStruct((bh, bq, hd), je.dtype), grid=(bh,),
        in_specs=[pl.BlockSpec((1, bq, lk), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, lk, hd), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, bq, hd), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        return _np(jax.jit(build())(je, jv))


@pytest.mark.parametrize("shape", list(T10_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("iters", [1, 3])
def test_pv_product_matches_tool(shape, dtype, transposed, iters):
    """T10 against the tool's kernel in both orientations, the tool's
    uniform inputs: 1e-5 (fp32) and 2^-7 (bf16) of the peak."""
    bh, bq, lk, hd = T10_SHAPES[shape]
    rng = np.random.default_rng(5)
    e = rng.random((bh, bq, lk)).astype(np.float32)
    v = rng.random((bh, lk, hd)).astype(np.float32)
    (je, jv), (te, tv) = _both([e, v], dtype)
    got = arms.pv_product(te, tv, transposed=transposed, iters=iters)
    assert got.dtype == getattr(torch, dtype) and got.shape == (bh, bq, hd)
    _close(_np(got), _jax_pv(je, jv, transposed, iters), dtype)


def test_pv_tool_perturbation_is_exactly_one_in_bf16():
    """The tool multiplies v by (1 + i*1e-9) rounded to v's type each pass:
    in bf16 that factor is 1 for every pass of its largest loop, so the
    passes add the same product and the port leaves the factor out; the
    orientations agree bit for bit in the plain version."""
    i = jnp.arange(bench_pv_transpose._iters(256, 256, 160), dtype=jnp.int32)
    factor = (1.0 + i.astype(jnp.float32) * 1e-9).astype(jnp.bfloat16)
    assert bool(jnp.all(factor == 1))
    rng = np.random.default_rng(6)
    e = torch.from_numpy(rng.random((1, 16, 24)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.random((1, 24, 40)).astype(np.float32)).bfloat16()
    a = arms.plain_pv_product(e, v, iters=5)
    assert torch.equal(a, arms.plain_pv_product(e, v, transposed=True,
                                                iters=5))
    one = arms.plain_pv_product(e, v, iters=1).float()
    assert torch.allclose(a.float(), 5 * one, rtol=2.0**-7, atol=0)


def test_pv_product_rejects_bad_operands():
    e, v = torch.zeros(1, 8, 16), torch.zeros(1, 12, 40)
    with pytest.raises(ValueError):
        arms.pv_product(e, v)
    with pytest.raises(ValueError):
        arms.pv_product(e, torch.zeros(1, 16, 40), iters=0)


@pytest.mark.parametrize("tool", [attn_sublane, pv_transpose],
                         ids=["attn_sublane", "pv_transpose"])
def test_entry_point_runs_on_the_cpu(tool, capsys):
    """main(--device cpu --shapes tiny) runs the plain versions, times
    nothing and ends with the JSON record."""
    assert tool.main(["--device", "cpu", "--shapes", "tiny"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["device"] == "cpu" and record["card"] is None
    assert len(record["rows"]) >= len(tool.SHAPE_SETS["tiny"])
    for row in record["rows"]:
        assert row["max_abs_diff_plain"] == 0.0


@pytest.mark.parametrize("tool", [attn_sublane, pv_transpose],
                         ids=["attn_sublane", "pv_transpose"])
def test_entry_point_refuses_without_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_tool_iters_is_the_tools():
    for bq, lk, hd in [(512, 4096, 40), (512, 1024, 80), (256, 256, 160),
                       (4096, 4096, 160)]:
        assert pv_transpose.tool_iters(bq, lk, hd) == \
            bench_pv_transpose._iters(bq, lk, hd)
