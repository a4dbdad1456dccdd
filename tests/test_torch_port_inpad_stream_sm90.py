"""bf16 K12a (conv3x3_inpad, conv3x3 under the port's _IN_PAD switch) and
K11 (conv3x3_stream) on the PLAIN mode of csrc/gn_conv_sm90.cu: K7's
function, K7's plan and K7's launch, each counted on its own counter.
TMA's out-of-bounds zeros are K12a's on-chip padding, and TMA's windows of
(rows + 2) x (tw + 2) pixels are K11's streamed rows with their halo.

On the CPU, the host logic that needs no card: the dispatch through a
patched `_cuda.function` (bf16 reaches dtp_conv3x3_sm90 with
same_sm90_plan's arguments, fp32 the staged-tile FMA twin
dtp_conv3x3_staged; each call moves its own counter only; bf16 refuses
Cin 3 and 9 and Cout 130 before any launch), the plan at K12a's and K11's
shape sets (kernel_ab.TWIN_K7, TWIN_K11), and the emulation of the
kernel's window reads (tests/test_torch_port_conv_same_sm90.py) against
the JAX package's _conv3x3_pallas(in_pad=True) and _conv3x3_stream in
interpret mode, beside the port's wrappers (plain on the CPU). JAX is
imported inside those tests only: the card's machine has none.

Marked `cuda` (skipped without a card; on the card:
python -m pytest -m cuda --noconftest
tests/test_torch_port_inpad_stream_sm90.py): both against their plain
versions at the twin's shapes and at ragged ones TMA can describe, equal
bit for bit to K7 (ops/conv3x3.py _conv3x3) at the same shapes, replays
bit-identical.
"""

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import conv3x3, gn_conv
from diffusiontexturepainting_torch.tools import kernel_ab

torch.set_num_threads(2)

STAGED_CU = _cuda.CSRC / "conv_staged.cu"
# (B, H, W, Cin, Cout): K12a at every K7 shape of the safe twin's 256^2
# stamp, K11 at those that pass the JAX package's streaming_plan test
INPAD = [tuple(s[:5]) for s in kernel_ab.TWIN_K7]
STREAM = [tuple(s[:5]) for s in kernel_ab.TWIN_K11]
# ragged shapes TMA can describe: odd H and W, a 1x1 image, Cout 40, 24,
# 136 and 8 (off the 128-column tile), Cin off the 64-channel chunk
RAGGED = [(1, 7, 5, 8, 40), (2, 3, 9, 16, 24), (1, 1, 1, 48, 136),
          (2, 11, 19, 48, 8), (2, 17, 33, 24, 40)]
# what bf16 TMA cannot describe (16-byte rows): Cin 3, Cin 9, Cout 130
REFUSED = [(2, 5, 7, 3, 40), (1, 1, 1, 9, 24), (1, 17, 9, 48, 130)]
WRAPPERS = {"inpad": (conv3x3.conv3x3_inpad, conv3x3.conv3x3_inpad_launches),
            "stream": (conv3x3.conv3x3_stream,
                       conv3x3.conv3x3_stream_launches)}
COUNTERS = (conv3x3.conv3x3_launches, conv3x3.conv3x3_inpad_launches,
            conv3x3.conv3x3_stream_launches)


def test_shape_sets():
    """K11's set is the 24 twin shapes at H >= 8 (every one passes
    streaming_plan's test: Cin >= 16, Cout >= 128, H a multiple of 8);
    every channel count of both sets is a multiple of 8 (TMA describes
    them all)."""
    assert len(INPAD) == 26 and len(STREAM) == 24
    assert STREAM == [s for s in INPAD if s[1] >= 8]
    assert all(s[1] % 8 == 0 and s[3] >= 16 and s[4] >= 128 for s in STREAM)
    assert all(c % 8 == 0 for s in INPAD for c in s[3:])


def _k7():
    """K7's CPU test module: its fake CUDA tensor and its emulation of the
    kernel's window reads (imported by the CPU tests only: the card runs
    this file without the repository's conftest)."""
    from tests import test_torch_port_conv_same_sm90 as k7

    return k7


def _fake(shape, dtype):
    return _k7()._FakeCuda(shape, dtype)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _patch(monkeypatch):
    """A stub of _cuda.function recording (source, symbol, args), and fake
    CUDA tensors from torch.empty."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return call

    fake = _k7()._FakeCuda

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else shape
        return fake(shape, dtype)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls


@pytest.mark.parametrize("shape", [INPAD[0], INPAD[12], INPAD[13],
                                   INPAD[14], RAGGED[2]], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_dispatch(monkeypatch, kind, dtype, shape):
    """bf16 K12a and K11 reach dtp_conv3x3_sm90 of gn_conv_sm90.cu with
    same_sm90_plan's arguments (a work buffer exactly where the plan
    splits K; the plan's tile and split, not forced), fp32 the staged-tile
    FMA twin dtp_conv3x3_staged with is_bf16 0; the call moves its own
    counter by one and no other."""
    calls = _patch(monkeypatch)
    op, counter = WRAPPERS[kind]
    B, H, W, cin, cout = shape
    x = _fake((B, H, W, cin), dtype)
    w = _fake((3, 3, cin, cout), dtype)
    b = _fake((cout,), dtype)
    before = [c.launches for c in COUNTERS]
    out = op(x, w, b)
    assert out.shape == (B, H, W, cout) and out.dtype == dtype
    after = [c.launches for c in COUNTERS]
    assert [a - b for a, b in zip(after, before)] == [
        int(c is counter) for c in COUNTERS]
    assert counter.shapes[((B, H, W, cin), (3, 3, cin, cout))] >= 1
    assert len(calls) == 1
    source, symbol, args = calls[0]
    if dtype == torch.bfloat16:
        assert (source, symbol) == ("gn_conv_sm90", "dtp_conv3x3_sm90")
        plan = gn_conv.same_sm90_plan(B, H, W, cin, cout)
        assert (args[4] is not None) == (plan["splits"] > 1)
        assert args[5:12] == (B, H, W, cin, cout, 0, 0)
    else:
        assert (source, symbol) == ("conv_staged", "dtp_conv3x3_staged")
        assert args[4:10] == (B, H, W, cin, cout, 0)


def test_in_pad_routes_conv3x3_to_k12a(monkeypatch):
    """conv3x3 of a bf16 CUDA tensor under _IN_PAD takes K12a's counter and
    K7's launch; with the switch off, K7's counter and the same launch."""
    calls = _patch(monkeypatch)
    x = _fake((3, 16, 16, 640), torch.bfloat16)
    w = _fake((3, 3, 640, 640), torch.bfloat16)
    b = _fake((640,), torch.bfloat16)
    seen = []
    for on in (True, False):
        before = [c.launches for c in COUNTERS]
        monkeypatch.setattr(conv3x3, "_IN_PAD", on)
        conv3x3.conv3x3(x, w, b)
        seen.append([c.launches - n for c, n in zip(COUNTERS, before)])
    assert seen == [[0, 1, 0], [1, 0, 0]]
    assert calls[0][1:] == calls[1][1:]
    assert calls[0][1] == "dtp_conv3x3_sm90"


@pytest.mark.parametrize("shape", REFUSED, ids=str)
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_bf16_refuses_what_tma_cannot_describe(monkeypatch, kind, shape):
    """bf16 K12a and K11 at Cin 3, Cin 9 and Cout 130 raise ValueError
    before any launch and move no counter; fp32 runs the staged twin
    there. The staged SAME, UP and GN entries refuse bf16 and instantiate
    no bf16 kernel (bf16 K12b runs K4's kernel, bf16 K10 the affine mode
    of csrc/gn_conv_sm90.cu)."""
    calls = _patch(monkeypatch)
    op, _ = WRAPPERS[kind]
    B, H, W, cin, cout = shape
    before = [c.launches for c in COUNTERS]
    with pytest.raises(ValueError, match="TMA"):
        op(_fake((B, H, W, cin), torch.bfloat16),
           _fake((3, 3, cin, cout), torch.bfloat16),
           _fake((cout,), torch.bfloat16))
    assert calls == [] and [c.launches for c in COUNTERS] == before
    op(_fake((B, H, W, cin), torch.float32),
       _fake((3, 3, cin, cout), torch.float32),
       _fake((cout,), torch.float32))
    assert [c[1] for c in calls] == ["dtp_conv3x3_staged"]
    src = STAGED_CU.read_text()
    assert "  if (is_bf16) return cudaErrorInvalidValue;\n" \
        "  StagedArgs<float> p{};" in src and "__nv_bfloat16" not in src
    assert "dispatch<dtp::kGn>" in src and "constexpr bool gn = MODE == kGn;" \
        in src


@pytest.mark.parametrize("shape", INPAD + RAGGED, ids=str)
def test_plan_fills_the_output_and_the_card(shape):
    """The plan K12a and K11 take at their shapes is K7's: it covers the
    Cout tiles and channel chunks, within the H100's shared memory, with
    at least half the SMs busy at the twin's shapes."""
    B, H, W, cin, cout = shape
    p = gn_conv.same_sm90_plan(B, H, W, cin, cout)
    assert (p["n_tiles"] - 1) * 128 < cout <= p["n_tiles"] * 128
    assert p["splits"] * p["per_split"] >= p["chunks"] > (
        (p["splits"] - 1) * p["per_split"])
    assert p["smem"] <= gn_conv.SMEM_LIMIT and p["stages"] >= 2
    if shape in INPAD:
        assert p["m_tiles"] * p["n_tiles"] * p["splits"] >= (
            gn_conv.SM_COUNT // 2)


@pytest.mark.parametrize("shape,splits", [
    ((2, 16, 16, 32, 128), None), ((1, 8, 10, 16, 128), 2),
    ((2, 5, 7, 16, 128), None)], ids=str)
def test_window_reads_match_pallas_inpad(shape, splits):
    """The kernel's window reads (emulated in torch: each tile's TMA box
    with out-of-bounds zeros, the nine shifted reads, the splits in order)
    and the port's conv3x3_inpad (plain on the CPU) against the JAX
    package's _conv3x3_pallas with in_pad=True (_conv_kernel_inpad, its
    zero border made in VMEM) in interpret mode: fp32, atol and rtol 1e-4
    (sums of up to 9 x 32 products in other orders)."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv

    B, H, W, cin, cout = shape
    x = _rand((B, H, W, cin), 21 + H)
    w = _rand((3, 3, cin, cout), 22, (9 * cin) ** -0.5)
    b = _rand((cout,), 23, 0.1)
    plan = j_conv.pallas_plan(x.shape, w.shape)
    assert plan is not None
    want = np.asarray(j_conv._conv3x3_pallas(
        *(jnp.asarray(a) for a in (x, w, b)), plan, interpret=True,
        in_pad=True))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    for got in (_k7()._emulate(xt, wt, bt, splits),
                conv3x3.conv3x3_inpad(xt, wt, bt)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,splits", [
    ((1, 16, 8, 16, 128), None), ((2, 16, 16, 32, 128), 2),
    ((1, 24, 12, 24, 256), None)], ids=str)
def test_window_reads_match_pallas_stream(shape, splits):
    """The emulated window reads and the port's conv3x3_stream (plain on
    the CPU) against the JAX package's _conv3x3_stream
    (_conv_stream_kernel: a DMA'd window of H_T + 2 rows) with
    streaming_plan's plan in interpret mode: fp32, atol and rtol 1e-4."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv

    B, H, W, cin, cout = shape
    x = _rand((B, H, W, cin), 31 + H)
    w = _rand((3, 3, cin, cout), 32, (9 * cin) ** -0.5)
    b = _rand((cout,), 33, 0.1)
    plan = j_conv.streaming_plan(x.shape, w.shape)
    assert plan is not None
    want = np.asarray(j_conv._conv3x3_stream(
        *(jnp.asarray(a) for a in (x, w, b)), plan, interpret=True))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    for got in (_k7()._emulate(xt, wt, bt, splits),
                conv3x3.conv3x3_stream(xt, wt, bt)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_plans_entry_point_runs_inpad_and_stream_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows inpad,stream on the CPU: the wrappers'
    plain route, equal to K7's (plain) route, nothing timed."""
    import json

    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "inpad,stream"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["kernel"] for r in record["rows"]] == ["K12a", "K12a", "K11"]
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               and r["k7_max_diff"] == 0.0 for r in record["rows"])


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B, H, W, cin, cout):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, H, W, cin).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    return x, w, (rnd(cout) * 0.1).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [("inpad", s) for s in INPAD + RAGGED]
                         + [("stream", s) for s in STREAM + RAGGED], ids=str)
def test_sm90_matches_plain_and_k7(kind, shape):
    """bf16 K12a and K11 against conv3x3_plain (chip_smoke's tolerance:
    2^-5 of the largest output magnitude), and equal bit for bit to K7
    (_conv3x3) on the same inputs: one launch, one plan."""
    gen = _setup()
    op, counter = WRAPPERS[kind]
    x, w, b = _inputs(gen, *shape)
    before = counter.launches
    got = op(x, w, b)
    k7 = conv3x3._conv3x3(x, w, b)
    want = conv3x3.conv3x3_plain(x, w, b).float()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.float() - want).abs().max().item() <= (
        2.0**-5 * want.abs().max().item())
    assert torch.equal(got, k7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("inpad", (3, 4, 4, 2560, 1280)), ("inpad", (3, 8, 8, 1920, 1280)),
    ("stream", (3, 8, 8, 2560, 1280)), ("stream", (2, 64, 64, 256, 512)),
    ("stream", (1, 256, 256, 128, 128))], ids=str)
def test_sm90_replays_are_bit_identical(kind, shape):
    """Each call gives the same bits again (split tiles added in split
    order by an integer counter, no float atomics)."""
    gen = _setup()
    op, _ = WRAPPERS[kind]
    x, w, b = _inputs(gen, *shape)
    first = op(x, w, b)
    again = op(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, again)

