"""The bf16 T10 kernel (csrc/pv_product_sm90.cu): `iters` passes of the
P V product as a split wgmma/TMA GEMM whose operands stay in shared
memory for all passes, in both orientations.

On the CPU, the host logic that needs no card: the split plan (every
(query tile, key chunk, pass group) covered once, every key and pass
counted once, the grid filling the card at the tool's shapes, the work
buffer's layout), the source's constants, the dtype dispatch between the
sm90 entry (bf16) and the FMA twin (fp32, csrc/attn_transposed.cu) through
a patched `_cuda.function`, refusals of what TMA cannot describe, and a
torch emulation of the kernel's order of sums (each pass group's passes of
its key chunk, then the partials in key-chunk and group order, rounded
once) held against plain_pv_product and the TPU tool's _pv_kernel in
interpret mode.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_pv_sm90.py): the kernel against
its plain version at the tool's shapes and ragged ones, every one of 64
passes counted (one fewer fails the check), replays bit-identical, every
split the plan allows within tolerance, refusals that launch nothing (a
work buffer short of the plan's included), the old entry refusing bf16,
the Python plan equal to the built library's.
"""

import ctypes
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import attention_variants as arms

torch.set_num_threads(2)

# The JAX reference (the TPU tool) is imported by the CPU tests that use
# it: the card's machine, which runs the `cuda` tests, has no JAX.

SM90_CU = _cuda.CSRC / "pv_product_sm90.cu"
OLD_CU = _cuda.CSRC / "attn_transposed.cu"
SMEM_LIMIT = 232448
SM_COUNT = 132
# (bq, Lk, hd) of the TPU tool's main(), and its passes a call
TOOL = [(512, 4096, 40), (512, 1024, 80), (256, 256, 160)]
# (bh, bq, Lk, hd): bq off the 64-row tile, Lk off every chunk, hd 8, 40,
# 72, 80, 152, 160, several images
RAGGED = [(3, 100, 1096, 40), (2, 200, 1096, 72), (2, 72, 200, 152),
          (2, 72, 200, 8), (2, 130, 264, 160), (1, 64, 8, 48),
          (5, 1, 24, 80)]


def _blocks(p):
    """(tile, chunk, CTA group) of each CTA, as the kernel derives it from
    blockIdx.x."""
    return [(b // (p["gc"] * p["nk"]), (b // p["gc"]) % p["nk"], b % p["gc"])
            for b in range(p["ctas"])]


def _passes(iters, groups):
    """The passes of each pass group, as the kernel splits them."""
    return [iters // groups + (g < iters % groups) for g in range(groups)]


@pytest.mark.parametrize("shape", [(1, *s) for s in TOOL] + RAGGED, ids=str)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("force", [(None, None), (64, 1), (256, 3)],
                         ids=["plan", "c64g1", "c256g3"])
def test_pv_plan_covers_every_piece_once(shape, transposed, force):
    """Every (query tile, key chunk, CTA group) is one CTA; the chunks
    cover the keys once; the pass groups' passes add up to iters; the
    CTA's operands fit shared memory; the work buffer holds one partial of
    128 threads x acc floats per CTA, then one counter a tile."""
    bh, bq, lk, hd = shape
    iters = 64
    p = arms.pv_sm90_plan(bh, bq, lk, hd, iters, transposed, *force)
    assert p["n_q"] == -(-bq // 64) and p["tiles"] == bh * p["n_q"]
    assert p["chunk"] in arms.PV_CHUNKS
    if force[0]:
        assert (p["chunk"], p["gc"]) == force
    blocks = _blocks(p)
    assert sorted(set(blocks)) == sorted(blocks)
    assert set(blocks) == {(t, c, g) for t in range(p["tiles"])
                           for c in range(p["nk"]) for g in range(p["gc"])}
    keys = [k for c in range(p["nk"])
            for k in range(c * p["chunk"], min(lk, (c + 1) * p["chunk"]))]
    assert keys == list(range(lk))
    assert p["groups"] == 2 * p["gc"]
    assert sum(_passes(iters, p["groups"])) == iters
    if transposed:
        assert (p["nb"], p["acc"]) == (-(-hd // 64), 32 * -(-hd // 64))
    else:
        assert p["nb"] >= hd and p["nb"] in (40, 80, 160)
        assert p["acc"] == p["nb"] // 2
    v_atoms = p["nb"] if transposed else -(-p["nb"] // 64)
    assert p["smem"] == p["chunk"] * 128 * (1 + v_atoms) + 16 + 1024
    assert p["smem"] <= SMEM_LIMIT
    assert p["ws_floats"] == p["ctas"] * 128 * p["acc"]
    assert p["work_floats"] == p["ws_floats"] + p["tiles"]


@pytest.mark.parametrize("shape", TOOL, ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_pv_plan_fills_the_card(shape, transposed):
    """At the tool's bh 1 the grid fills about one wave of 132 SMs (bq / 64
    blocks before: 8, 8 and 4): the key chunks split first, then the
    passes; with the tool's own passes (about 300 GF a call) too."""
    from tools import bench_pv_transpose

    bq, lk, hd = shape
    for iters in (64, bench_pv_transpose._iters(bq, lk, hd)):
        p = arms.pv_sm90_plan(1, bq, lk, hd, iters, transposed)
        assert 0.9 * SM_COUNT <= p["ctas"] <= SM_COUNT
    p = arms.pv_sm90_plan(1, 512, 4096, 40, 64, transposed)
    assert (p["tiles"], p["nk"], p["chunk"], p["gc"]) == (8, 16, 256, 1)
    p = arms.pv_sm90_plan(1, 256, 256, 160, 64, transposed)
    assert (p["tiles"], p["nk"], p["chunk"], p["gc"]) == (4, 4, 64, 8)


def test_pv_plan_at_the_card_fill_and_one_pass():
    """Many images: one chunk of 256 keys a CTA and no pass split once the
    (tile, chunk) grid exceeds a wave; one pass: one CTA group, its second
    warpgroup's group empty."""
    p = arms.pv_sm90_plan(33, 512, 4096, 40, 64, False)
    assert (p["chunk"], p["gc"], p["ctas"]) == (256, 1, 33 * 8 * 16)
    p = arms.pv_sm90_plan(1, 256, 256, 160, 1, True)
    assert p["gc"] == 1 and _passes(1, p["groups"]) == [1, 0]


def test_pv_plan_matches_the_source():
    """pv_sm90_plan mirrors the source's constants and rules."""
    text = SM90_CU.read_text()
    for const in (f"kRows = {arms.PV_ROWS};",
                  f"kMaxChunk = {arms.PV_CHUNKS[-1]};",
                  f"kMinChunk = {arms.PV_CHUNKS[0]};",
                  f"kSMs = {SM_COUNT};", "kThreads = 256;",
                  "kMaxHd = 160;",
                  "p.tiles * chunks(p.chunk / 2) <= kSMs",
                  "std::min<long long>((iters + 1) / 2,",
                  "hd <= 40 ? 40 : hd <= 80 ? 80 : 160",
                  "p.chunk * 128 * (1 + v_atoms) + 16 + 1024",
                  "p.tiles * p.nk * p.gc * 128 * p.acc",
                  "p.ws_floats + p.tiles",
                  "a.iters / groups + (group < a.iters % groups)"):
        assert const in text, const


class _FakeCuda:
    """What the wrapper reads of a CUDA tensor, on a machine without one."""

    def __init__(self, shape, dtype, ptr=1 << 20):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self.ptr = ptr

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()


def _fake_cuda(monkeypatch, allocs=None):
    """Patches torch.empty to fake CUDA tensors (their (shape, dtype) into
    `allocs`) and _cuda.function to a recorder; returns the list of
    (source, symbol, arguments) calls."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return call

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if allocs is not None:
            allocs.append((shape, dtype))
        return _FakeCuda(shape, dtype)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("transposed", [False, True])
def test_pv_dtype_dispatch(monkeypatch, dtype, transposed):
    """A bf16 CUDA call reaches dtp_pv_product_sm90 of the new source with
    the plan's work buffer and no forcing; an fp32 call the FMA twin's
    entry with is_bf16 0; each moves the launch counter by one. The old
    entry refuses bf16, and the wrapper has no fallback."""
    bh, bq, lk, hd = 1, 512, 1024, 80
    calls = _fake_cuda(monkeypatch)
    e, v = _FakeCuda((bh, bq, lk), dtype), _FakeCuda((bh, lk, hd), dtype)
    before = arms.pv_product_launches.launches
    out = arms.pv_product(e, v, transposed=transposed, iters=64)
    assert tuple(out.shape) == (bh, bq, hd) and out.dtype == dtype
    assert arms.pv_product_launches.launches == before + 1
    if dtype == torch.bfloat16:
        assert [c[:2] for c in calls] == [("pv_product_sm90",
                                           "dtp_pv_product_sm90")]
        args = calls[0][2]
        plan = arms.pv_sm90_plan(bh, bq, lk, hd, 64, transposed)
        assert args[4:13] == (plan["work_floats"], bh, bq, lk, hd, 64,
                              int(transposed), 0, 0)
    else:
        assert [c[:2] for c in calls] == [("attn_transposed",
                                           "dtp_pv_product")]
        assert calls[0][2][:-1][-1] == 0  # is_bf16
    assert arms.PV_SM90_SOURCE in _cuda.SOURCES
    assert 'extern "C" cudaError_t dtp_pv_product_sm90(' in SM90_CU.read_text()
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_pv_product('):]
    assert "if (is_bf16 ||" in entry[:entry.index("\n}\n")]
    assert "pv_kernel<" not in old and "launch_pv<" not in old
    src = Path(arms.__file__).read_text()
    assert "try:" not in src and "except" not in src


def test_pv_dispatch_passes_the_plans_work(monkeypatch):
    """The bf16 call allocates the output and the plan's work floats in
    fp32, one buffer, passes the buffer's size and forwards a forced
    split."""
    allocs = []
    calls = _fake_cuda(monkeypatch, allocs)
    e = _FakeCuda((2, 130, 264), torch.bfloat16)
    v = _FakeCuda((2, 264, 160), torch.bfloat16)
    arms._pv_product(e, v, True, 5, 128, 3)
    plan = arms.pv_sm90_plan(2, 130, 264, 160, 5, True, 128, 3)
    assert allocs == [((2, 130, 160), torch.bfloat16),
                      ((plan["work_floats"],), torch.float32)]
    assert calls[-1][2][4] == plan["work_floats"]
    assert calls[-1][2][11:13] == (128, 3)


@pytest.mark.parametrize("lk,hd", [(1100, 40), (1096, 36), (8, 12)])
def test_pv_dispatch_refuses_what_tma_cannot_describe(monkeypatch, lk, hd):
    """bf16 with Lk or hd off a multiple of 8 raises ValueError before any
    launch; the counter does not move."""
    calls = _fake_cuda(monkeypatch)
    before = arms.pv_product_launches.launches
    e = _FakeCuda((1, 64, lk), torch.bfloat16)
    v = _FakeCuda((1, lk, hd), torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        arms.pv_product(e, v)
    assert calls == [] and arms.pv_product_launches.launches == before


def test_pv_tma_describable():
    """Contiguous, 16-byte-aligned bases, Lk and hd multiples of 8."""
    e = torch.zeros((1, 64, 1096), dtype=torch.bfloat16)
    v = torch.zeros((1, 1096, 40), dtype=torch.bfloat16)
    assert arms.pv_tma_describable(e, v)
    assert not arms.pv_tma_describable(e[..., :1092], v[:, :1092])
    assert not arms.pv_tma_describable(e, v[..., :36])
    flat = torch.zeros(1 + 64 * 1096, dtype=torch.bfloat16)
    assert not arms.pv_tma_describable(flat[1:].view(1, 64, 1096), v)


def emulate_pv(e, v, transposed, iters, chunk=None, ctas=None):
    """The kernel's order of sums in fp32 on the CPU: each key chunk's
    product, added pass by pass into each pass group's total from zero;
    a CTA's partial its first group's total + its second's; the partials
    of a query tile added in key-chunk, then CTA-group order from zero; one
    rounding to e's dtype."""
    bh, bq, lk = e.shape
    hd = v.shape[2]
    p = arms.pv_sm90_plan(bh, bq, lk, hd, iters, transposed, chunk, ctas)
    ef, vf = e.float(), v.float()
    out = torch.empty((bh, bq, hd))
    passes = _passes(iters, p["groups"])
    for b in range(bh):
        for q0 in range(0, bq, 64):
            acc = torch.zeros((min(64, bq - q0), hd))
            for c in range(p["nk"]):
                k0, k1 = c * p["chunk"], min(lk, (c + 1) * p["chunk"])
                eb, vb = ef[b, q0:q0 + 64, k0:k1], vf[b, k0:k1]
                prod = (vb.T @ eb.T).T if transposed else eb @ vb
                totals = []
                for n in passes:
                    tot = torch.zeros_like(prod)
                    for _ in range(n):
                        tot += prod
                    totals.append(tot)
                for g in range(p["gc"]):
                    acc += totals[2 * g] + totals[2 * g + 1]
            out[b, q0:q0 + 64] = acc
    return out.to(e.dtype)


def _jax_pv(je, jv, transposed, iters):
    """The tool's Pallas call (bench_shape builds it around its own
    inputs), on the given arrays, in interpret mode."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from tools import bench_pv_transpose

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
        return np.asarray(jax.jit(build())(je, jv), np.float32)


# (bh, bq, Lk, hd, iters, chunk, ctas): several chunks and pass groups
EMULATED = [(1, 100, 200, 40, 5, None, None), (2, 72, 136, 80, 3, 64, 2),
            (1, 64, 264, 160, 4, 128, 1), (1, 130, 72, 8, 6, 64, 3)]


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_emulated_order_matches_plain_and_tool(case, transposed):
    """The kernel's order of sums against plain_pv_product and the tool's
    _pv_kernel in interpret mode, the tool's uniform inputs in bf16: the
    orders differ only in fp32 summation, so at most one bf16 rounding
    step apart: 2^-7 of the peak (two bf16 ulps at that magnitude)."""
    import jax.numpy as jnp

    bh, bq, lk, hd, iters, chunk, ctas = case
    rng = np.random.default_rng(11)
    e = rng.random((bh, bq, lk)).astype(np.float32)
    v = rng.random((bh, lk, hd)).astype(np.float32)
    te, tv = (torch.from_numpy(a).bfloat16() for a in (e, v))
    got = emulate_pv(te, tv, transposed, iters, chunk, ctas).float().numpy()
    want = arms.plain_pv_product(te, tv, transposed=transposed,
                                 iters=iters).float().numpy()
    tool = _jax_pv(jnp.asarray(e, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                   transposed, iters)
    atol = 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, tool, atol=atol, rtol=0)


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


CARD_KEYS = ([((1, bq, lk), (1, lk, hd), t, 64) for bq, lk, hd in TOOL
              for t in (False, True)]
             + [((bh, bq, lk), (bh, lk, hd), t, 3)
                for bh, bq, lk, hd in RAGGED for t in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("key", CARD_KEYS, ids=str)
def test_sm90_pv_matches_plain(key):
    """bf16 T10 against plain_pv_product (chip_smoke's tolerance: 2^-5 of
    the largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("pv_product", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 1024, 80), (1, 256, 256, 160),
                                   (3, 100, 1096, 40), (2, 72, 200, 152)],
                         ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_sm90_pv_replays_and_splits_agree(shape, transposed):
    """Each call is bit-identical on replay (partials added in a fixed
    order, no float atomics); every chunk of 64, 128 and 256 keys under 1,
    2 and 5 CTA groups stays within 2^-7 of the peak of the plain version
    (fp32 summation order only)."""
    gen = _setup()
    bh, bq, lk, hd = shape
    e = torch.rand((bh, bq, lk), generator=gen, device="cuda").bfloat16()
    v = torch.rand((bh, lk, hd), generator=gen, device="cuda").bfloat16()
    iters = 7
    want = arms.plain_pv_product(e, v, transposed=transposed,
                                 iters=iters).float()
    tol = 2.0**-7 * want.abs().max().item()
    first = arms.pv_product(e, v, transposed=transposed, iters=iters)
    again = arms.pv_product(e, v, transposed=transposed, iters=iters)
    forced = [arms._pv_product(e, v, transposed, iters, chunk, ctas)
              for chunk in arms.PV_CHUNKS for ctas in (1, 2, 5)]
    replay = arms._pv_product(e, v, transposed, iters, 64, 5)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(forced[2], replay)
    for got in [first] + forced:
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TOOL, ids=str)
@pytest.mark.parametrize("transposed", [False, True])
def test_sm90_pv_counts_every_pass(shape, transposed):
    """At the smoke's 64 passes each output element is within 2^-7 of its
    own magnitude of 64 e v taken in fp64 (half a bf16 ulp of rounding,
    fp32 sums far below it; the inputs are positive, so no element
    cancels), while one pass fewer is 2^-6 off: the check fails a call of
    63 passes, which the smoke's 2^-5 of the peak would pass."""
    gen = _setup()
    bq, lk, hd = shape
    e = torch.rand((1, bq, lk), generator=gen, device="cuda").bfloat16()
    v = torch.rand((1, lk, hd), generator=gen, device="cuda").bfloat16()
    exact = 64 * (e.double() @ v.double())

    def rel_err(iters):
        got = arms.pv_product(e, v, transposed=transposed, iters=iters)
        return ((got.double() - exact).abs() / exact).max().item()

    assert rel_err(64) <= 2.0**-7
    assert rel_err(63) > 2.0**-7


@pytest.mark.cuda
def test_sm90_pv_refuses_a_short_work_buffer():
    """The entry checks the work buffer's floats against its own plan: one
    float short returns cudaErrorInvalidValue and writes nothing; the
    plan's size runs."""
    gen = _setup()
    e = torch.rand((1, 256, 256), generator=gen, device="cuda").bfloat16()
    v = torch.rand((1, 256, 160), generator=gen, device="cuda").bfloat16()
    plan = arms.pv_sm90_plan(1, 256, 256, 160, 64, True)
    work = torch.empty(plan["work_floats"], dtype=torch.float32,
                       device="cuda")
    out = torch.zeros((1, 256, 160), dtype=torch.bfloat16, device="cuda")
    fn = _cuda.function(arms.PV_SM90_SOURCE, "dtp_pv_product_sm90",
                        arms._PV_SM90_ARGTYPES)

    def call(floats):
        return fn(e.data_ptr(), v.data_ptr(), out.data_ptr(),
                  work.data_ptr(), floats, 1, 256, 256, 160, 64, 1, 0, 0,
                  _cuda.stream_of(e))

    assert call(plan["work_floats"] - 1) == 1  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert not out.any()
    assert call(plan["work_floats"]) == 0
    want = arms.plain_pv_product(e, v, transposed=True, iters=64).float()
    torch.cuda.synchronize()
    assert ((out.float() - want).abs().max().item()
            <= 2.0**-7 * want.abs().max().item())


@pytest.mark.cuda
def test_sm90_pv_refuses_what_tma_cannot_describe():
    """bf16 T10 at Lk 1100, at hd 36 and on an e 2 bytes off 16 raises
    ValueError and launches nothing; the old entry returns
    cudaErrorInvalidValue for bf16; fp32 at those shapes runs the twin."""
    gen = _setup()
    counter = arms.pv_product_launches
    before = counter.launches
    for lk, hd, offset in ((1100, 40, 0), (1096, 36, 0), (1096, 40, 1)):
        flat = torch.rand(offset + 64 * lk, generator=gen,
                          device="cuda").bfloat16()
        e = flat[offset:].view(1, 64, lk)
        v = torch.rand((1, lk, hd), generator=gen, device="cuda").bfloat16()
        with pytest.raises(ValueError, match="TMA"):
            arms.pv_product(e, v)
    assert counter.launches == before
    e = torch.rand((1, 64, 1100), generator=gen, device="cuda").bfloat16()
    v = torch.rand((1, 1100, 40), generator=gen, device="cuda").bfloat16()
    out = torch.empty((1, 64, 40), dtype=torch.bfloat16, device="cuda")
    fn = _cuda.function("attn_transposed", "dtp_pv_product",
                        arms._PV_ARGTYPES)
    code = fn(e.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 64, 1100, 40,
              1, 0, 1, _cuda.stream_of(e))
    assert code == 1  # cudaErrorInvalidValue
    got = arms.pv_product(e.float(), v.float(), iters=2)
    want = arms.plain_pv_product(e.float(), v.float(), iters=2)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_sm90_pv_plan_matches_the_library():
    """pv_sm90_plan equals the built library's plan at the tool's and the
    ragged shapes, forced chunks and CTA groups included."""
    _setup()
    fn = _cuda.library("pv_product_sm90").dtp_pv_product_sm90_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 12)()
    keys = ("n_q", "chunk", "nk", "gc", "groups", "nb", "acc", "smem",
            "tiles", "ctas", "ws_floats", "work_floats")
    for bh, bq, lk, hd in [(1, *s) for s in TOOL] + [(33, 512, 4096, 40)] \
            + RAGGED:
        for t in (False, True):
            for chunk, ctas in ((None, None), (64, 3), (256, 1)):
                for iters in (1, 64, 1788):
                    assert fn(bh, bq, lk, hd, iters, int(t), chunk or 0,
                              ctas or 0, out) == 0
                    p = arms.pv_sm90_plan(bh, bq, lk, hd, iters, t, chunk,
                                          ctas)
                    assert list(out) == [p[k] for k in keys]
