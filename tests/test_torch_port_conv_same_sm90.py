"""The bf16 K7 kernel: the 3x3 SAME conv + bias as the PLAIN mode of the
K1/K5 kernel in csrc/gn_conv_sm90.cu (no prologue: A read straight from the
TMA window stages).

On the CPU, the host logic that needs no card: the plan at every shape of
the safe twin's stamp and at ragged ones (K1/K5's tile, consumer count and
split of K kept; the tiles covering every output pixel once, the splits
every channel chunk once; three window stages and the B stages within the
H100's shared memory), the check that TMA can describe the operands, the
dtype dispatch between the sm90 entry (bf16) and the FMA twin (fp32,
csrc/conv3x3.cu) through a patched `_cuda.function`, and a torch emulation
of the kernel's window-stage reads (each tile's TMA box with its
out-of-bounds zeros, the nine shifted reads of each chunk, the splits
added in order) against conv3x3_plain and against the JAX package's
_conv3x3_pallas in interpret mode.

The JAX package is imported inside the two tests that run it: the card's
machine has no JAX. Marked `cuda` (skipped without a card; on the card:
python -m pytest -m cuda --noconftest
tests/test_torch_port_conv_same_sm90.py): the kernel
against its plain version at every twin shape and at ragged ones, forced
tiles and splits, bit-identical replays, refusals that launch nothing,
csrc/conv3x3.cu's entry refusing bf16, the Python plan held equal to the
built library's.
"""

import ctypes
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import conv3x3, gn_conv
from diffusiontexturepainting_torch.tools import kernel_ab

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "gn_conv_sm90.cu"
OLD_CU = _cuda.CSRC / "conv3x3.cu"

# (B, H, W, Cin, Cout): every K7 shape of the safe twin's 256^2 stamp
TWIN = [tuple(s[:5]) for s in kernel_ab.TWIN_K7]
# odd sizes, Cin off 64, Cout off 128, one pixel, several images a tile,
# a one-row image at the widest tile
RAGGED = [(2, 12, 10, 96, 136), (1, 9, 19, 40, 136), (2, 1, 1, 16, 8),
          (5, 3, 3, 8, 16), (2, 17, 33, 24, 40), (4, 1, 12, 16, 24)]


def _tile_pixels(p, mt, B, H, W):
    """The tile's 64 * consumers pixels as (b, y, x) or None, and its
    window's origin (b0, i0 - 1, j0 - 1), from the kernel's decode."""
    if p["tpi"] == 1:
        b0, i0, j0 = mt * p["nb"], 0, 0
    else:
        b0, rem = divmod(mt, p["tpi"])
        i0 = (rem // p["tiles_w"]) * p["rows"]
        j0 = (rem % p["tiles_w"]) * p["tw"]
    pix = []
    for m in range(64 * p["consumers"]):
        slot, rem = divmod(m, p["rows"] * p["tw"])
        b, y, x = b0 + slot, i0 + rem // p["tw"], j0 + rem % p["tw"]
        ok = slot < p["nb"] and b < B and y < H and x < W
        pix.append((b, y, x) if ok else None)
    return pix, (b0, i0 - 1, j0 - 1)


@pytest.mark.parametrize("shape", TWIN + RAGGED, ids=str)
@pytest.mark.parametrize("consumers,splits", [(None, None), (1, 1), (2, 3)])
def test_same_plan_covers_the_output_once(shape, consumers, splits):
    """The tiles cover every output pixel once, the N tiles Cout, the
    splits the channel chunks once; three window stages (or the bf16
    output staging that aliases them) and at least two B stages within
    the H100's 232,448 bytes a block; the grid within CUDA's limits; the
    work buffer the split tiles and counters only."""
    B, H, W, cin, cout = shape
    p = gn_conv.same_sm90_plan(B, H, W, cin, cout, consumers, splits)
    seen = {}
    for mt in range(p["m_tiles"]):
        for px in _tile_pixels(p, mt, B, H, W)[0]:
            if px is not None:
                seen[px] = seen.get(px, 0) + 1
    assert len(seen) == B * H * W and set(seen.values()) == {1}
    assert (p["n_tiles"] - 1) * 128 < cout <= p["n_tiles"] * 128
    chunks = [c for s in range(p["splits"])
              for c in range(s * p["per_split"],
                             min((s + 1) * p["per_split"], p["chunks"]))]
    assert chunks == list(range(-(-cin // 64)))
    assert 2 <= p["stages"] <= gn_conv.SAME_MAX_B_STAGES
    region0 = max(3 * p["win_bytes"], 64 * p["consumers"] * 128 * 2)
    assert p["smem"] == (region0 + 8 * 2 * (3 + 12) + 16 + 1024
                         + p["stages"] * gn_conv.GN_B_BYTES)
    assert p["smem"] <= gn_conv.SMEM_LIMIT
    assert p["m_tiles"] <= 65535 and p["splits"] <= 65535
    ctas = p["m_tiles"] * p["n_tiles"]
    assert p["work_floats"] == (ctas * p["splits"] * 64 * p["consumers"]
                                * 128 + ctas if p["splits"] > 1 else 0)


# the twin's shapes where K1/K5's plan takes one consumer warpgroup to split
# K and K7 takes two splitting deeper (full 128-pixel tiles, at least 4
# chunks a split): the UNet's 16^2 level at Cin >= 960
TWO_CONSUMERS = [(3, 16, 16, 960, 640), (3, 16, 16, 1280, 640),
                 (3, 16, 16, 1920, 640)]


@pytest.mark.parametrize("shape", TWIN + RAGGED, ids=str)
def test_same_plan_keeps_the_k1k5_tile(shape):
    """K7 keeps K1/K5's tile geometry, consumer-count rule and split of K,
    except at TWO_CONSUMERS, where it is K1/K5's plan forced to two
    consumers (its own split); only its shared memory differs: more B
    stages than K1/K5's at every twin shape (no V buffers, no per-warp
    statistics)."""
    B, H, W, cin, cout = shape
    p = gn_conv.same_sm90_plan(B, H, W, cin, cout)
    two = shape in TWO_CONSUMERS
    q = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout, cout, False,
                                  2 if two else None)
    for k in ("consumers", "tw", "rows", "nb", "win_lines", "tiles_h",
              "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks", "splits",
              "per_split", "work_floats"):
        assert p[k] == q[k], k
    if two:
        one = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout, cout, False)
        assert (one["consumers"], one["splits"]) == (1, 2)
        assert (p["consumers"], p["splits"]) == (2, 4)
        assert (p["m_tiles"] * p["n_tiles"] * p["splits"]
                == one["m_tiles"] * one["n_tiles"] * one["splits"])
        assert p["per_split"] >= gn_conv.SAME_MIN_CHUNKS
    if shape in TWIN:
        assert p["stages"] > q["stages"]


def test_same_plan_takes_two_consumers_only_at_full_tiles():
    """The two-consumer rule applies at TWO_CONSUMERS and at no other twin
    or ragged shape: not at 16^2 Cin 320 and 640 (2 and 3 chunks a
    split), 8^2 and 4^2 (tiles of 128 pixels over 64 or 48), nor where
    forced."""
    changed = [s for s in TWIN + RAGGED
               if gn_conv.same_sm90_plan(*s)["consumers"]
               != gn_conv.gn_conv_sm90_plan(*s, s[4], False)["consumers"]]
    assert changed == TWO_CONSUMERS
    for s in TWO_CONSUMERS:
        assert gn_conv.same_sm90_plan(*s, consumers=1)["consumers"] == 1
        assert gn_conv.same_sm90_plan(*s, splits=2)["consumers"] == 1


@pytest.mark.parametrize("shape", TWIN, ids=str)
def test_same_plan_fills_the_card(shape):
    """At every twin shape the grid (split K included) keeps at least half
    of the 132 SMs busy, within one wave where it splits."""
    p = gn_conv.same_sm90_plan(*shape)
    ctas = p["m_tiles"] * p["n_tiles"] * p["splits"]
    assert ctas >= gn_conv.SM_COUNT // 2
    if p["splits"] > 1:
        assert ctas <= gn_conv.SM_COUNT


def test_same_plan_matches_the_source():
    """same_sm90_plan mirrors the source's constants and rules."""
    text = SM90_CU.read_text()
    for const in (f"kSameWinStages = {gn_conv.SAME_WIN_STAGES};",
                  f"kSameMaxBStages = {gn_conv.SAME_MAX_B_STAGES};",
                  "GnPlan p = plan(B, H, W, Cin, Cout, nc, splits);",
                  f"kSameMinChunks = {gn_conv.SAME_MIN_CHUNKS};",
                  "if (nc == 0 && splits == 0 && p.nc == 1 && p.splits > 1) {",
                  "const GnPlan q = plan(B, H, W, Cin, Cout, 2, 0);",
                  "static_cast<long long>(B) * H * W &&",
                  "q.per_split >= kSameMinChunks)",
                  "const int staging = 64 * p.nc * kBN * 2;",
                  "8 * 2 * (kSameWinStages + kSameMaxBStages) + 16 + 1024;",
                  "p.stages = (kSmemLimit - fixed) / kBBytes;",
                  "constexpr int kWS = PLAIN ? kSameWinStages : kWinStages;",
                  "dtp::work_layout(p, B, Cout, false).total};"):
        assert const in text, const


@pytest.mark.parametrize("cin,cout,offset,ok", [
    (1280, 1280, 0, True), (96, 136, 0, True), (16, 8, 0, True),
    (20, 16, 0, False), (16, 12, 0, False), (16, 16, 1, False)])
def test_conv3x3_tma_describable(cin, cout, offset, ok):
    """Cin and Cout multiples of 8 and 16-byte-aligned bases (every twin
    shape is: its channel counts are multiples of 64)."""
    flat = torch.empty(offset + 4 * 4 * cin, dtype=torch.bfloat16)
    x = flat[offset:].view(1, 4, 4, cin)
    w = torch.empty((3, 3, cin, cout), dtype=torch.bfloat16)
    assert gn_conv.upconv_tma_describable(x, w) == ok
    assert all(c % 8 == 0 for s in TWIN for c in s[3:])


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_dtype_dispatch(monkeypatch, dtype):
    """A bf16 CUDA call of conv3x3 reaches dtp_conv3x3_sm90 of
    gn_conv_sm90.cu with the plan's split buffer (the 4x4 level splits K),
    an fp32 call conv3x3.cu's entry; each moves the launch counter by one;
    a bf16 call TMA cannot describe raises before any launch. The old
    entry refuses bf16; the wrapper has no fallback."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 1 if symbol.endswith("_splits") else 0
        return call

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else shape
        return _FakeCuda(shape, dtype)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    B, H, W, cin, cout = 3, 4, 4, 2560, 1280
    x, w = (_FakeCuda(s, dtype) for s in ((B, H, W, cin),
                                          (3, 3, cin, cout)))
    b = _FakeCuda((cout,), dtype)
    before = conv3x3.conv3x3_launches.launches
    out = conv3x3.conv3x3(x, w, b)
    assert out.shape == (B, H, W, cout) and out.dtype == dtype
    assert conv3x3.conv3x3_launches.launches == before + 1
    if dtype == torch.bfloat16:
        assert [c[:2] for c in calls] == [("gn_conv_sm90",
                                           "dtp_conv3x3_sm90")]
        args = calls[0][2]
        assert args[4] is not None  # the split tiles and counters
        assert args[5:12] == (B, H, W, cin, cout, 0, 0)
        calls.clear()
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.conv3x3(_FakeCuda((1, 4, 4, 20), dtype),
                            _FakeCuda((3, 3, 20, 16), dtype), None)
        assert calls == []
    else:
        assert [c[:2] for c in calls] == [("conv3x3", "dtp_conv3x3_splits"),
                                          ("conv3x3", "dtp_conv3x3")]
        assert calls[1][2][11] == 0  # is_bf16
    assert conv3x3.conv3x3_launches.launches == before + 1
    assert 'extern "C" cudaError_t dtp_conv3x3_sm90(' in SM90_CU.read_text()
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_conv3x3('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 ||" in entry and "return cudaErrorInvalidValue;" in entry
    assert "launch<float, dtp::kSame>" in entry
    assert "dispatch<" not in old and "dispatch_fused" not in old
    src = Path(conv3x3.__file__).read_text()
    assert "try:" not in src and "except" not in src


def _emulate(x, w, b, splits=None, consumers=None):
    """The kernel's reads in torch (fp32): for each tile of the plan, the
    TMA box of each 64-channel chunk (nb images x (rows+2) x (tw+2)
    lines, out-of-bounds pixels and channels zero: the conv's padding);
    tap (di, dj) of pixel m reads window line line0(m) + di * (tw+2) + dj;
    each split accumulates its chunks, the last adds the splits in split
    order, + bias, one rounding to x's dtype."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    p = gn_conv.same_sm90_plan(B, H, W, cin, cout, consumers, splits)
    tw, rows, nb = p["tw"], p["rows"], p["nb"]
    kww, img_lines = tw + 2, (rows + 2) * (tw + 2)
    cpad = p["chunks"] * 64
    xp = F.pad(x.float(), (0, cpad - cin, 1, rows + tw + 2,
                           1, rows + tw + 2))
    xp = torch.cat([xp, xp.new_zeros((nb,) + xp.shape[1:])])
    wf = F.pad(w.float(), (0, 0, 0, cpad - cin)).reshape(9, cpad, cout)
    out = torch.zeros((B, H, W, cout))
    for mt in range(p["m_tiles"]):
        pix, (b0, y0, x0) = _tile_pixels(p, mt, B, H, W)
        # the box: lines (slot, wy, wx), padded coordinates y0 + 1 + wy
        box = xp[b0:b0 + nb, y0 + 1:y0 + 1 + rows + 2,
                 x0 + 1:x0 + 1 + kww].reshape(nb * img_lines, cpad)
        line0 = []
        for m in range(len(pix)):
            slot, rem = divmod(m, rows * tw)
            line0.append(slot * img_lines + (rem // tw) * kww + rem % tw
                         if slot < nb else 0)
        line0 = torch.tensor(line0)
        acc = torch.zeros((len(pix), cout))
        for s in range(p["splits"]):
            part = torch.zeros((len(pix), cout))
            for k in range(s * p["per_split"],
                           min((s + 1) * p["per_split"], p["chunks"])):
                c = slice(64 * k, 64 * k + 64)
                for tap in range(9):
                    a = box[line0 + (tap // 3) * kww + tap % 3, c]
                    part = part + a @ wf[tap, c]
            acc = acc + part
        for m, px in enumerate(pix):
            if px is not None:
                out[px] = acc[m] + b.float()
    return out.to(x.dtype)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape,splits", [
    ((2, 8, 10, 128, 128), None), ((2, 8, 10, 128, 128), 2),
    ((3, 4, 4, 64, 136), None), ((1, 9, 19, 40, 136), 1),
    ((4, 1, 12, 16, 24), None), ((1, 17, 9, 192, 128), 3)], ids=str)
def test_emulated_window_reads_equal_the_conv(shape, splits):
    """The emulated window-stage reads (tiled and whole-image tiles, a
    tile past the last image, split and unsplit K) equal conv3x3_plain in
    fp32 (1e-4: fp32 sums of up to 9 x 192 products in another order)."""
    B, H, W, cin, cout = shape
    x = torch.from_numpy(_rand((B, H, W, cin), cin + H))
    w = torch.from_numpy(_rand((3, 3, cin, cout), cout + W,
                               (9 * cin) ** -0.5))
    b = torch.from_numpy(_rand((cout,), 7, 0.1))
    got = _emulate(x, w, b, splits)
    want = conv3x3.conv3x3_plain(x, w, b)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape,splits", [
    ((2, 8, 10, 128, 128), None), ((2, 8, 10, 128, 128), 2),
    ((1, 6, 5, 16, 128), None)], ids=str)
def test_emulated_window_reads_match_pallas(shape, splits):
    """The emulated reads against the JAX package's _conv3x3_pallas
    (interpret mode, force="pallas"): fp32, atol and rtol 1e-4 (the two
    sum in other orders)."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.ops import conv3x3 as j_conv

    B, H, W, cin, cout = shape
    x = _rand((B, H, W, cin), 11)
    w = _rand((3, 3, cin, cout), 12, (9 * cin) ** -0.5)
    b = _rand((cout,), 13, 0.1)
    assert j_conv.pallas_plan(x.shape, w.shape) is not None
    want = np.asarray(j_conv.conv3x3(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), force="pallas"))
    got = _emulate(*(torch.from_numpy(a) for a in (x, w, b)), splits)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_plans_entry_point_runs_same_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows same on the CPU: the plain version, the
    plan's tiles, nothing timed."""
    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "same"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["kernel"] for r in record["rows"]] == ["K7", "K7"]
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
@pytest.mark.parametrize("shape", TWIN + RAGGED, ids=str)
def test_sm90_conv3x3_matches_plain(shape):
    """bf16 K7 against conv3x3_plain (chip_smoke's tolerance: 2^-5 of the
    largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    B, H, W, cin, cout = shape
    r = chip_smoke.compare("conv3x3", ((B, H, W, cin), (3, 3, cin, cout)),
                           torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 2560, 1280),
                                   (3, 8, 8, 1920, 1280),
                                   (3, 16, 16, 640, 640),
                                   (2, 64, 64, 256, 512),
                                   (1, 9, 19, 40, 136)], ids=str)
def test_sm90_conv3x3_replays_and_forced_choices_agree(shape):
    """Each call is bit-identical on replay (the splits added in split
    order); forced consumer counts and splits stay within tolerance of the
    plain version."""
    gen = _setup()
    B, H, W, cin, cout = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, H, W, cin).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    b = (rnd(cout) * 0.1).bfloat16()
    want = conv3x3.conv3x3_plain(x, w, b).float()
    tol = 2.0**-5 * want.abs().max().item()
    first, again = conv3x3.conv3x3(x, w, b), conv3x3.conv3x3(x, w, b)
    forced = [conv3x3._conv3x3(x, w, b, consumers=nc, splits=s)
              for nc in (1, 2) for s in (1, 2, 7)]
    replay = conv3x3._conv3x3(x, w, b, consumers=2, splits=7)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(forced[-1], replay)
    for got in [first] + forced:
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_sm90_conv3x3_refuses_what_tma_cannot_describe():
    """bf16 K7 at Cin 20, at Cout 12 and on an input 2 bytes off 16 raises
    ValueError and launches nothing; fp32 at Cin 20 runs the FMA twin;
    conv3x3.cu's entry called in bf16 returns cudaErrorInvalidValue (1)
    and its split plan -1."""
    gen = _setup()
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    counter = conv3x3.conv3x3_launches
    before = counter.launches
    flat = rnd(1 + 8 * 8 * 16).bfloat16()
    off = flat[1:].view(1, 8, 8, 16)
    for x, cout in ((rnd(1, 8, 8, 20).bfloat16(), 16),
                    (rnd(1, 8, 8, 16).bfloat16(), 12), (off, 16)):
        w = rnd(3, 3, x.shape[-1], cout).bfloat16()
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.conv3x3(x, w, None)
    assert counter.launches == before
    x, w, b = rnd(1, 8, 8, 20), rnd(3, 3, 20, 16), rnd(16)
    out = conv3x3.conv3x3(x, w, b)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    ob = torch.empty((1, 8, 8, 16), dtype=torch.bfloat16, device="cuda")
    fn = _cuda.function("conv3x3", "dtp_conv3x3", conv3x3._ARGTYPES)
    assert fn(xb.data_ptr(), wb.data_ptr(), bb.data_ptr(), ob.data_ptr(),
              None, 1, 8, 8, 20, 16, 1, 1, _cuda.stream_of(xb)) == 1
    splits = _cuda.function("conv3x3", "dtp_conv3x3_splits",
                            conv3x3._SPLIT_ARGTYPES)
    assert splits(1, 8, 8, 20, 16, 1) == -1


@pytest.mark.cuda
def test_sm90_same_plan_matches_the_library():
    """ops/gn_conv.py same_sm90_plan equals the built library's plan at the
    twin and ragged shapes, forced tiles and splits included (the
    two-consumer rule at TWO_CONSUMERS among them)."""
    _setup()
    fn = _cuda.library("gn_conv_sm90").dtp_conv3x3_sm90_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 16)()
    fields = ("consumers", "tw", "rows", "nb", "win_lines", "stages", "smem",
              "tiles_h", "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks",
              "splits", "per_split", "work_floats")
    for B, H, W, cin, cout in TWIN + RAGGED:
        for nc, splits in ((0, 0), (1, 1), (2, 3), (1, 0), (0, 2)):
            assert fn(B, H, W, cin, cout, nc, splits, out) == 0
            p = gn_conv.same_sm90_plan(B, H, W, cin, cout, nc or None,
                                       splits or None)
            assert list(out) == [p[f] for f in fields]
