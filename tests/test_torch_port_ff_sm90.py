"""The bf16 K3 kernel (csrc/ff_geglu_sm90.cu): the GEGLU feed-forward as
two wgmma/TMA GEMMs with the GEGLU and the residual in their epilogues.

On the CPU, the host logic that needs no card: the plan of both GEMMs at
every served shape (tiles covering every token, inner column and channel
once, the second GEMM's split covering its K steps once, one buffer for h,
the split tiles and the counters), the check that TMA can describe the
operands, the dtype dispatch between the sm90 entry (bf16) and the FMA twin
(fp32, csrc/ff_geglu.cu) through a patched `_cuda.function`, and a torch
emulation of the kernel's order of work (the first GEMM's value/gate N
tile, the second's splits added in order) held against ff_geglu_plain.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_ff_sm90.py): the kernel against
its plain version at the served and ragged shapes under every consumer
and split choice, bit-identical replays of split calls, the Python plan
held equal to the built library's, refusals that launch nothing.
"""

import ctypes
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import ff_geglu

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "ff_geglu_sm90.cu"
OLD_CU = _cuda.CSRC / "ff_geglu.cu"

# (N tokens, C, inner): one UNet eval's feed-forwards (batch 3, levels 0,
# 1, 2 and the mid block) at 256^2, 512^2 and 1024^2
SERVED = [(n, c, 4 * c)
          for n0 in (3072, 12288, 49152)
          for n, c in ((n0, 320), (n0 // 4, 640), (n0 // 16, 1280),
                       (n0 // 64, 1280))]
# ragged tokens, C off the 128-channel tile, inner off the 64-column tile
RAGGED = [(1, 96, 384), (37, 64, 256), (100, 96, 384), (5, 40, 200),
          (130, 136, 72)]
SMEM_PER_SM = 233472  # two CTAs' dynamic shared memory and reserve


@pytest.mark.parametrize("shape", SERVED + RAGGED, ids=str)
@pytest.mark.parametrize("consumers", [None, 1, 2])
def test_ff_plan_covers_every_output_once(shape, consumers):
    """The first GEMM's tiles cover every token and inner column once, the
    second's every token and channel; the splits cover the K steps once;
    two CTAs fit an SM; the grid within CUDA's y limit; the work buffer
    holds h in whole 16 bytes, then the split tiles and counters."""
    N, C, inner = shape
    p = ff_geglu.ff_sm90_plan(N, C, inner, consumers=consumers)
    gate, down = p["gate"], p["down"]
    for g in (gate, down):
        rows = 64 * g["consumers"]
        assert (g["m_tiles"] - 1) * rows < N <= g["m_tiles"] * rows
        assert g["m_tiles"] <= 65535
        assert 2 * (g["smem"] + 1024) <= SMEM_PER_SM
        if consumers:
            assert g["consumers"] == consumers
    assert (gate["i_tiles"] - 1) * 64 < inner <= gate["i_tiles"] * 64
    assert (down["n_tiles"] - 1) * 128 < C <= down["n_tiles"] * 128
    steps = [k for s in range(down["splits"])
             for k in range(s * down["per_split"],
                            min((s + 1) * down["per_split"],
                                down["chunks"]))]
    assert steps == list(range(-(-inner // 64)))
    assert p["h_floats"] * 4 >= N * inner * 2 and p["h_floats"] % 4 == 0
    tiles = down["m_tiles"] * down["n_tiles"]
    extra = (tiles * down["splits"] * 64 * down["consumers"] * 128 + tiles
             if down["splits"] > 1 else 0)
    assert p["work_floats"] == p["h_floats"] + extra


@pytest.mark.parametrize("shape", SERVED, ids=str)
def test_ff_plan_fills_the_card(shape):
    """At every served shape both GEMMs keep at least half of the 132 SMs
    busy: the 256^2 UNet's levels 1, 2 and mid block split the second
    GEMM's K, within one wave; 64-token tiles wherever 128-token ones
    would not give the first GEMM two CTAs an SM or the second one."""
    N, C, inner = shape
    p = ff_geglu.ff_sm90_plan(N, C, inner)
    gate, down = p["gate"], p["down"]
    assert gate["m_tiles"] * gate["i_tiles"] >= ff_geglu.SM_COUNT // 2
    ctas = down["m_tiles"] * down["n_tiles"] * down["splits"]
    assert ctas >= ff_geglu.SM_COUNT // 2
    if down["splits"] > 1:
        assert ctas <= ff_geglu.SM_COUNT
    if N <= 192 or (N, C) == (768, 640):
        assert down["splits"] > 1
    for g, n, waves in ((gate, gate["i_tiles"], 2),
                        (down, down["n_tiles"], 1)):
        two = -(-N // 128) * n >= waves * ff_geglu.SM_COUNT
        assert g["consumers"] == (2 if two else 1)


def test_ff_plan_of_the_mid_block():
    """The 256^2 mid block (48 tokens): one 64-token tile, 80 inner tiles
    of the first GEMM; the second GEMM's 10 channel tiles split 80 steps
    into 12 runs of 7 (120 CTAs). Level 2 (192 tokens): 64-token tiles in
    the first GEMM, 240 CTAs."""
    p = ff_geglu.ff_sm90_plan(48, 1280, 5120)
    assert (p["gate"]["consumers"], p["gate"]["m_tiles"],
            p["gate"]["i_tiles"]) == (1, 1, 80)
    q = ff_geglu.ff_sm90_plan(192, 1280, 5120)["gate"]
    assert (q["consumers"], q["m_tiles"] * q["i_tiles"]) == (1, 240)
    assert (p["down"]["n_tiles"], p["down"]["chunks"], p["down"]["splits"],
            p["down"]["per_split"]) == (10, 80, 12, 7)


def test_ff_plan_matches_the_source():
    """ff_sm90_plan mirrors the source's constants and rules."""
    text = SM90_CU.read_text()
    for const in (f"kAtom = {ff_geglu.FF_BK};", f"kBN = {ff_geglu.FF_BN};",
                  f"kIT = {ff_geglu.FF_IT};",
                  f"kSMs = {ff_geglu.SM_COUNT};",
                  "return nc == 2 ? 3 : 4;",
                  "return 64 * nc * 128 + kBN * 128;",
                  "16 * stages_for(nc) + 16 + 1024",
                  "1LL * m_tiles(2) * p.i_tiles >= 2 * kSMs ? 2 : 1",
                  "1LL * m_tiles(2) * p.n_tiles >= kSMs ? 2 : 1",
                  "tiles >= kSMs ? 1 : kSMs / tiles",
                  "(1LL * N * inner + 7) / 8 * 4",
                  "tiles * p.splits * 64 * p.nc2 * kBN + tiles"):
        assert const in text, const


@pytest.mark.parametrize("C,inner,offset,ok", [
    (320, 1280, 0, True), (96, 384, 0, True), (40, 200, 0, True),
    (36, 128, 0, False), (64, 36, 0, False), (64, 128, 1, False)])
def test_ff_tma_describable(C, inner, offset, ok):
    """C and inner multiples of 8 (TMA's 16-byte rows, the epilogue's
    16-byte stores) and 16-byte-aligned bases."""
    flat = torch.empty(offset + 16 * C, dtype=torch.bfloat16)
    x = flat[offset:].view(16, C)
    w0 = torch.empty((2 * inner, C), dtype=torch.bfloat16)
    w2 = torch.empty((C, inner), dtype=torch.bfloat16)
    assert ff_geglu.ff_tma_describable(x, w0, w2, x) == ok


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


def _fake_cuda(monkeypatch):
    """Patches torch.empty / empty_like to fake CUDA tensors and
    _cuda.function to a recorder; returns the list of (source, symbol,
    arguments) of the calls."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            if symbol.endswith("_splits"):
                return 1
            return 128 if symbol == "dtp_ff_geglu_chunk" else 0
        return call

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else shape
        return _FakeCuda(shape, dtype)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _FakeCuda(t.shape, t.dtype))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ff_dtype_dispatch(monkeypatch, dtype):
    """A bf16 CUDA call reaches dtp_ff_geglu_sm90 of the new source with
    the plan's work buffer and no forcing; an fp32 call the FMA twin's
    entries; each moves the launch counter by one. The old entry refuses
    bf16 and the wrapper has no fallback."""
    N, C, inner = 192, 1280, 5120
    calls = _fake_cuda(monkeypatch)
    ops = [_FakeCuda(s, dtype) for s in ((N, C), (2 * inner, C),
                                         (2 * inner,), (C, inner), (C,),
                                         (N, C))]
    before = ff_geglu.ff_geglu_launches.launches
    out = ff_geglu.ff_geglu(*ops)
    assert out.shape == (N, C) and out.dtype == dtype
    assert ff_geglu.ff_geglu_launches.launches == before + 1
    if dtype == torch.bfloat16:
        assert [c[:2] for c in calls] == [("ff_geglu_sm90",
                                           "dtp_ff_geglu_sm90")]
        args = calls[0][2]
        assert args[8:13] == (N, C, inner, 0, 0)
    else:
        assert [c[:2] for c in calls] == [("ff_geglu", "dtp_ff_geglu_chunk"),
                                          ("ff_geglu", "dtp_ff_geglu")]
        assert calls[1][2][12] == 0  # is_bf16
    assert ff_geglu.SM90_SOURCE in _cuda.SOURCES
    assert 'extern "C" cudaError_t dtp_ff_geglu_sm90(' in SM90_CU.read_text()
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_ff_geglu('):]
    assert "if (is_bf16 ||" in entry[:entry.index("\n}\n")]
    src = Path(ff_geglu.__file__).read_text()
    assert "try:" not in src and "except" not in src


def test_ff_dispatch_refuses_what_tma_cannot_describe(monkeypatch):
    """A bf16 call at C 36 or inner 36 raises ValueError before any
    launch."""
    calls = _fake_cuda(monkeypatch)
    for N, C, inner in ((16, 36, 128), (16, 64, 36)):
        ops = [_FakeCuda(s, torch.bfloat16)
               for s in ((N, C), (2 * inner, C), (2 * inner,), (C, inner),
                         (C,), (N, C))]
        with pytest.raises(ValueError, match="TMA"):
            ff_geglu.ff_geglu(*ops)
    assert calls == []


def _emulate(x, w0, b0, w2, b2, res, plan):
    """The kernel's order of work in torch: the first GEMM tile by tile
    (64 * consumers tokens x the N tile of 64 value rows of w0 then their
    64 gate rows, as the producer's two TMA boxes place them, rows past
    2 * inner reading zeros), h rounded once per element and stored where
    the column is < inner; the second GEMM tile by tile, each split's fp32
    partial over its run of K steps, added in split order, then b2 and
    the residual and one rounding."""
    N, C = x.shape
    inner = w2.shape[1]
    gate, down = plan["gate"], plan["down"]
    w0p = torch.cat([w0.float(), w0.new_zeros((64, C)).float()])
    h = torch.zeros((N, inner), dtype=x.dtype)
    rows = 64 * gate["consumers"]
    for mt in range(gate["m_tiles"]):
        xs = x[mt * rows:(mt + 1) * rows].float()
        for it in range(gate["i_tiles"]):
            i0 = 64 * it
            b_tile = torch.cat([w0p[i0:i0 + 64], w0p[inner + i0:
                                                     inner + i0 + 64]])
            acc = xs @ b_tile.t()
            cols = min(64, inner - i0)
            v = acc[:, :cols] + b0[i0:i0 + cols].float()
            g = acc[:, 64:64 + cols] + b0[inner + i0:inner + i0 + cols].float()
            h[mt * rows:(mt + 1) * rows, i0:i0 + cols] = (
                v * F.gelu(g)).to(x.dtype)
    out = torch.empty_like(x)
    rows = 64 * down["consumers"]
    for mt in range(down["m_tiles"]):
        hs = h[mt * rows:(mt + 1) * rows].float()
        for nt in range(down["n_tiles"]):
            n0, n1 = 128 * nt, min(128 * nt + 128, C)
            acc = torch.zeros((hs.shape[0], n1 - n0))
            for s in range(down["splits"]):
                k0 = 64 * s * down["per_split"]
                k1 = min(k0 + 64 * down["per_split"], inner)
                acc = acc + hs[:, k0:k1] @ w2[n0:n1, k0:k1].float().t()
            y = acc + b2[n0:n1].float() + res[mt * rows:(mt + 1) * rows,
                                              n0:n1].float()
            out[mt * rows:(mt + 1) * rows, n0:n1] = y.to(x.dtype)
    return out


@pytest.mark.parametrize("shape,consumers,splits", [
    ((37, 64, 256), None, None), ((100, 96, 384), 2, 3),
    ((5, 40, 200), None, None), ((130, 136, 72), 1, 2),
    ((48, 1280, 5120), None, None)], ids=str)
def test_emulated_tiles_equal_the_feed_forward(shape, consumers, splits):
    """The emulation of the kernel's tiles and splits under the plan equals
    ff_geglu_plain: in fp32 to the order of summation (1e-5), in bf16 to
    a rounding of h or of the output (2^-7 of the largest output)."""
    N, C, inner = shape
    gen = torch.Generator().manual_seed(N + C + inner)
    x, res = (torch.randn((N, C), generator=gen) for _ in range(2))
    w0 = torch.randn((2 * inner, C), generator=gen) * C**-0.5
    w2 = torch.randn((C, inner), generator=gen) * inner**-0.5
    b0, b2 = (torch.randn(n, generator=gen) * 0.1 for n in (2 * inner, C))
    plan = ff_geglu.ff_sm90_plan(N, C, inner, consumers, splits)
    ops = (x, w0, b0, w2, b2, res)
    got = _emulate(*ops, plan)
    want = ff_geglu.ff_geglu_plain(*ops)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    ops = tuple(t.bfloat16() for t in ops)
    got = _emulate(*ops, plan).float()
    want = ff_geglu.ff_geglu_plain(*ops).float()
    assert (got - want).abs().max().item() <= 2.0**-7 * want.abs().max()


def test_plans_entry_point_runs_ff_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows ff on the CPU: the plain version under
    the plan's tiles, nothing timed."""
    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "ff"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["kernel"] for r in record["rows"]] == ["K3"]
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               for r in record["rows"])


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("key", SERVED + RAGGED, ids=str)
def test_sm90_ff_matches_plain(key):
    """bf16 K3 against ff_geglu_plain (chip_smoke's tolerance: 2^-5 of the
    largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("ff_geglu", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


def _operands(gen, N, C, inner):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return ((rnd(N, C)).bfloat16(), (rnd(2 * inner, C) * C**-0.5).bfloat16(),
            (rnd(2 * inner) * 0.1).bfloat16(),
            (rnd(C, inner) * inner**-0.5).bfloat16(),
            (rnd(C) * 0.1).bfloat16(), rnd(N, C).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 1280, 5120), (192, 1280, 5120),
                                   (768, 640, 2560), (100, 96, 384),
                                   (3072, 320, 1280)], ids=str)
def test_sm90_ff_replays_and_choices_agree(shape):
    """Each call is bit-identical on replay (the splits added in split
    order, no float atomics); one and two consumer warpgroups and other
    splits of the second GEMM's K stay within tolerance of the plain
    version; without a split both consumer counts give the same bits."""
    gen = _setup()
    ops = _operands(gen, *shape)
    want = ff_geglu.ff_geglu_plain(*ops).float()
    tol = 2.0**-5 * want.abs().max().item()
    first, again = ff_geglu.ff_geglu(*ops), ff_geglu.ff_geglu(*ops)
    forced = [ff_geglu._ff_geglu(*ops, consumers=nc, splits=s)
              for nc in (1, 2) for s in (1, 2, 5)]
    replay = [ff_geglu._ff_geglu(*ops, consumers=nc, splits=5)
              for nc in (1, 2)]
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(forced[2], replay[0])
    assert torch.equal(forced[5], replay[1])
    assert torch.equal(forced[0], forced[3])
    for got in [first] + forced:
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_sm90_ff_refuses_what_tma_cannot_describe():
    """bf16 K3 at C 36, at inner 36 and on an input 2 bytes off 16 raises
    ValueError and launches nothing; fp32 at C 36 runs the FMA twin."""
    gen = _setup()
    counter = ff_geglu.ff_geglu_launches
    before = counter.launches
    for N, C, inner, offset in ((64, 36, 128, 0), (64, 64, 36, 0),
                                (64, 64, 128, 1)):
        x, w0, b0, w2, b2, r = _operands(gen, N, C, inner)
        flat = torch.empty(offset + N * C, dtype=torch.bfloat16,
                           device="cuda")
        xo = flat[offset:].view(N, C)
        xo.copy_(x)
        with pytest.raises(ValueError, match="TMA"):
            ff_geglu.ff_geglu(xo, w0, b0, w2, b2, r)
    assert counter.launches == before
    x, w0, b0, w2, b2, r = (t.float() for t in _operands(gen, 64, 36, 128))
    out = ff_geglu.ff_geglu(x, w0, b0, w2, b2, r)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.cuda
def test_sm90_ff_plan_matches_the_library():
    """ops/ff_geglu.py ff_sm90_plan equals the built library's plan at the
    served and ragged shapes, forced consumers and splits included."""
    _setup()
    fn = _cuda.library("ff_geglu_sm90").dtp_ff_geglu_sm90_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 11)()
    for N, C, inner in SERVED + RAGGED:
        for nc in (0, 1, 2):
            for splits in (0, 1, 3):
                assert fn(N, C, inner, nc, splits, out) == 0
                p = ff_geglu.ff_sm90_plan(N, C, inner, nc or None,
                                          splits or None)
                g, d = p["gate"], p["down"]
                assert list(out) == [
                    g["consumers"], g["m_tiles"], g["i_tiles"],
                    d["consumers"], d["m_tiles"], d["n_tiles"],
                    d["chunks"], d["splits"], d["per_split"],
                    p["h_floats"], p["work_floats"]]
