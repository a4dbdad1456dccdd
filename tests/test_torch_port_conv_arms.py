"""The conv family's A/B arms (T11 conv_window_taps, T12 pipelined) against
the JAX repository's tools/bench_conv_shift_cost.py and
tools/bench_stream_pipeline.py, whose Pallas kernels (T12's DMAs and
semaphores included) run here in interpret mode on the same seeded numpy
inputs. On the CPU the port's wrappers run their plain versions; the CUDA
kernels are held against those on the card (test_torch_port_cuda.py,
chip_smoke.py)."""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from diffusiontexturepainting_torch.ops import conv_variants as cv
from diffusiontexturepainting_torch.tools import (
    conv_shift_cost,
    stream_pipeline,
)
from tools import bench_conv_shift_cost, bench_stream_pipeline

torch.set_num_threads(2)

# (H_T, W, Cin, N): W + 2 on and off a multiple of 8
T11_SHAPES = {"w14": (4, 14, 16, 8), "w10": (3, 10, 8, 24)}
# (B, H, W, Cin, Cout, H_T)
T12_SHAPES = {"b1-ht4": (1, 8, 8, 16, 8, 4), "b2-ht4": (2, 12, 8, 8, 16, 4),
              "b1-ht8": (1, 16, 8, 8, 8, 8), "b2-ht8": (2, 8, 8, 8, 8, 8)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    """fp32: 1e-5 of the output's peak (summation order); bf16: 2^-7 of it
    (two bf16 ulps at that magnitude)."""
    peak = np.abs(want).max()
    rel = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got, want, atol=rel * peak, rtol=0)


def _wp(W):
    return W + 2 + (-(W + 2)) % 8


def _taps_inputs(shape, variant, seed=0):
    H_T, W, cin, n = shape
    rng = np.random.default_rng(seed)
    xwin = rng.random((H_T + 2, _wp(W), cin)).astype(np.float32)
    w = rng.random((3, 3 * cin, n) if variant == "jointw"
                   else (9, cin, n)).astype(np.float32)
    return xwin, w


def _jax_taps(jx, jw, variant, W, reps):
    """The tool's Pallas call (bench builds it around its own inputs), on
    the given window."""
    rows, wp, cin = jx.shape
    n = jw.shape[-1]
    kern = functools.partial(bench_conv_shift_cost._kernel, H_T=rows - 2,
                             W=W, Wp=wp, Cin=cin, N_T=n, variant=variant,
                             reps=reps)

    build = functools.partial(
        pl.pallas_call, kern,
        out_shape=jax.ShapeDtypeStruct((rows - 2, W, n), jx.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
    with pltpu.force_tpu_interpret_mode():
        return _np(jax.jit(build())(jx, jw))


@pytest.mark.parametrize("shape", list(T11_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", cv.VARIANTS)
@pytest.mark.parametrize("reps", [1, 3])
def test_window_taps_match_tool(shape, dtype, variant, reps):
    """Each of T11's four tap reads against the tool's kernel, without the
    loop carry (reps 1) and with it (reps 3)."""
    H_T, W, _, n = T11_SHAPES[shape]
    xwin, w = _taps_inputs(T11_SHAPES[shape], variant)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (xwin, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype))
              for a in (xwin, w))
    got = cv.conv_window_taps(tx[None], tw, variant, W=W, reps=reps)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (1, H_T, W, n)
    _close(_np(got[0]), _jax_taps(jx, jw, variant, W, reps), dtype)


def test_window_taps_over_a_leading_axis_of_windows():
    """nwin windows give nwin independent results, each with its own loop
    carry."""
    rng = np.random.default_rng(1)
    xw = torch.from_numpy(rng.random((3, 6, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 8, 8)).astype(np.float32))
    for variant in cv.VARIANTS:
        wv = w.view(3, 24, 8) if variant == "jointw" else w
        got = cv.conv_window_taps(xw, wv, variant, W=14, reps=3)
        for i in range(3):
            one = cv.conv_window_taps(xw[i:i + 1], wv, variant, W=14, reps=3)
            assert torch.equal(got[i:i + 1], one)


def _valid_conv(xw, w9, W):
    x = xw[:, :, :W + 2].permute(0, 3, 1, 2)
    wc = w9.view(3, 3, *w9.shape[1:]).permute(3, 2, 0, 1)
    return F.conv2d(x, wc).permute(0, 2, 3, 1)


def test_shifted_is_the_valid_conv_and_rowflat_is_not():
    """`shifted` is the VALID 3x3 conv of the window. `rowflat` reads at
    pitch W, so where Wp != W (always: Wp >= W + 2) it is the conv in its
    first output row only."""
    rng = np.random.default_rng(2)
    W = 14
    xw = torch.from_numpy(rng.random((1, 6, _wp(W), 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 8, 8)).astype(np.float32))
    conv = _valid_conv(xw, w, W)
    shifted = cv.conv_window_taps(xw, w, "shifted", W=W)
    rowflat = cv.conv_window_taps(xw, w, "rowflat", W=W)
    assert torch.allclose(shifted, conv, rtol=1e-5, atol=1e-4)
    assert torch.allclose(rowflat[:, 0], conv[:, 0], rtol=1e-5, atol=1e-4)
    assert (rowflat[:, 1:] - conv[:, 1:]).abs().max() > 1.0


def test_unshifted_reads_tap_zero_nine_times():
    rng = np.random.default_rng(3)
    xw = torch.from_numpy(rng.random((1, 5, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 8, 4)).astype(np.float32))
    got = cv.conv_window_taps(xw, w, "unshifted", W=10)
    want = torch.matmul(xw[:, :3, :10], w.sum(0))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)


def test_jointw_clamps_its_last_slice():
    """`jointw` with the dj taps stacked is the conv's di = 0 and di = 1
    terms, but its di = 2 slice, which would overrun the window by two
    rows, starts at 2*Wp - 2 as dynamic_slice clamps it: that term reads
    two pixels early. Against the tool's kernel and against the conv."""
    rng = np.random.default_rng(4)
    H_T, W, cin, n = 3, 14, 8, 8
    wp = _wp(W)
    xw = rng.random((H_T + 2, wp, cin)).astype(np.float32)
    w = rng.random((9, cin, n)).astype(np.float32)
    txw, tw = torch.from_numpy(xw)[None], torch.from_numpy(w)
    got = cv.conv_window_taps(txw, tw.view(3, 3 * cin, n), "jointw", W=W)[0]
    # di < 2 as the conv; di = 2 read two pixels (flat rows) early
    flat = txw[0].reshape(-1, cin)
    want = torch.zeros(H_T, W, n)
    for di in range(3):
        start = di * wp - (2 if di == 2 else 0)
        for dj in range(3):
            idx = (start + dj + torch.arange(H_T)[:, None] * wp
                   + torch.arange(W)[None])
            want += flat[idx] @ tw[di * 3 + dj]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got - _valid_conv(txw, tw, W)[0]).abs().max() > 1.0
    tool = _jax_taps(jnp.asarray(xw), jnp.asarray(w.reshape(3, 3 * cin, n)),
                     "jointw", W, 1)
    _close(_np(got), tool, "float32")


def test_carry_adds_the_first_element_to_every_output():
    rng = np.random.default_rng(5)
    xw = torch.from_numpy(rng.random((2, 5, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random((9, 8, 4)).astype(np.float32))
    one = cv.conv_window_taps(xw, w, "shifted", W=10)
    four = cv.conv_window_taps(xw, w, "shifted", W=10, reps=4)
    want = one + 3 * one[:, :1, :1, :1]
    assert torch.allclose(four, want, rtol=1e-5, atol=1e-4)


def test_window_taps_reject_bad_operands():
    xw, w = torch.zeros(1, 5, 16, 8), torch.zeros(9, 8, 4)
    with pytest.raises(ValueError):
        cv.conv_window_taps(xw, w, "diagonal", W=10)
    with pytest.raises(ValueError):
        cv.conv_window_taps(xw, w, "shifted", W=15)  # Wp < W + 2
    with pytest.raises(ValueError):
        cv.conv_window_taps(xw, w, "jointw", W=10)   # wants (3, 3*Cin, N)
    with pytest.raises(ValueError):
        cv.conv_window_taps(xw, w, "shifted", W=10, reps=0)


def _pipe_inputs(shape, seed=0):
    B, H, W, cin, cout, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, cin)).astype(np.float32),
            (rng.standard_normal((B, cin)) * 0.1 + 1).astype(np.float32),
            (rng.standard_normal((B, cin)) * 0.3).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
            rng.standard_normal((cout,)).astype(np.float32))


@pytest.mark.parametrize("shape", list(T12_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipelined_matches_tool(shape, dtype):
    """T12 against the tool's triple-buffered kernel at B 1 and 2 and row
    tiles of 4 and 8 (one Cout tile, H a multiple of the row tile: the
    prototype's limits), borders included."""
    x, a, c, w, b = _pipe_inputs(T12_SHAPES[shape])
    H_T, cout = T12_SHAPES[shape][5], T12_SHAPES[shape][4]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jax.jit(functools.partial(
            bench_stream_pipeline.pipelined, plan=(H_T, cout)))(
            jnp.asarray(x, jd), jnp.asarray(a), jnp.asarray(c),
            jnp.asarray(w, jd), jnp.asarray(b, jd)))
    tx, tw, tb = (torch.from_numpy(t).to(td) for t in (x, w, b))
    got = cv.pipelined(tx, torch.from_numpy(a), torch.from_numpy(c), tw, tb)
    assert got.dtype == td and got.shape == want.shape
    _close(_np(got), want, dtype)


def test_pipelined_border_is_silu_of_c():
    """x = 0 and a = 0: every input of the conv, the pad ring included, is
    silu(c), so every output, corners included, is the full 9-tap sum. A
    conv whose border input were 0 (K5, K10) would give less there."""
    cin, cout = 4, 3
    x = torch.zeros(1, 5, 6, cin)
    a = torch.zeros(1, cin)
    c = torch.tensor([[0.5, -1.0, 2.0, 0.25]])
    w = torch.ones(3, 3, cin, cout)
    got = cv.pipelined(x, a, c, w, None)
    full = 9 * F.silu(c).sum().item()
    assert torch.allclose(got, torch.full_like(got, full), rtol=1e-6)


def test_pipelined_takes_any_shape():
    """Cout off one tile and H off any row tile: the prototype's asserts
    are not the function's; against the definition in numpy terms."""
    x, a, c, w, b = (torch.from_numpy(t) for t in
                     _pipe_inputs((2, 7, 5, 3, 5, None), 1))
    got = cv.pipelined(x, a, c, w, b)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = F.silu(xp * a[:, None, None] + c[:, None, None])
    want = torch.zeros(2, 7, 5, 5)
    for di in range(3):
        for dj in range(3):
            want += y[:, di:di + 7, dj:dj + 5] @ w[di, dj]
    assert torch.allclose(got, want + b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tool", [conv_shift_cost, stream_pipeline],
                         ids=["conv_shift_cost", "stream_pipeline"])
def test_entry_point_runs_on_the_cpu(tool, capsys):
    """main(--device cpu --shapes tiny) runs the plain versions, times
    nothing and ends with the JSON record."""
    assert tool.main(["--device", "cpu", "--shapes", "tiny"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["device"] == "cpu" and record["card"] is None
    assert len(record["rows"]) >= len(tool.SHAPE_SETS["tiny"])
    for row in record["rows"]:
        assert row["max_abs_diff_plain"] == 0.0


@pytest.mark.parametrize("tool", [conv_shift_cost, stream_pipeline],
                         ids=["conv_shift_cost", "stream_pipeline"])
def test_entry_point_refuses_without_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
