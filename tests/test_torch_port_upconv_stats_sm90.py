"""The bf16 K6 kernel: the x2-upsample conv with the fp32 statistics of its
output before the rounding, K4's kernel in csrc/gn_conv_sm90.cu with the
statistics in its epilogue.

On the CPU, the host logic that needs no card: the plan with statistics at
every served shape and at ragged ones (the work buffer holding the
(B, 2, Cout) statistics first, then the tile partials, then the split tiles
and counters; the per-warp sums past the staged tiles within the shared
memory), the dtype dispatch between the sm90 entry (bf16) and the FMA twin
(fp32, csrc/conv3x3.cu) through a patched `_cuda.function`, and a torch
emulation of the kernel's order of summation (per 8-column group over a
thread's two rows, the warp's 8 row groups by shuffles, the 4 warps x 4
planes per image of the tile, then each image's tile partials in the
reduction kernel's order; the splits added in split order) against
upconv_stream_plain and against the JAX package's _upconv_stream_pallas in
interpret mode.

The JAX package is imported inside the two tests that run it: the card's
machine has no JAX. Marked `cuda` (skipped without a card; on the card:
python -m pytest -m cuda --noconftest
tests/test_torch_port_upconv_stats_sm90.py): the kernel
against its plain version at the served and ragged shapes, its statistics
within 2^-14 of the sums of its own fp32 output before the rounding,
forced splits, bit-identical replays, refusals that launch nothing,
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

# (B, H, W, Cin, Cout): the VAE decoder's three upsamplers' sources at
# 256^2, 512^2 and 1024^2 (batch 1)
SERVED = sorted({(B, H, W, C, C) for B, H, W, C, _ in kernel_ab.UPSTATS})
# odd sizes, Cin off 64, Cout off 128, one pixel, several images a tile
RAGGED = [(1, 5, 7, 64, 72), (1, 9, 19, 40, 136), (2, 1, 1, 16, 8),
          (5, 3, 3, 8, 16), (2, 17, 33, 24, 40)]


@pytest.mark.parametrize("shape", SERVED + RAGGED, ids=str)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_upstats_plan_work_layout(shape, splits):
    """With statistics, K4's plan (the same tiles, stages and split) and a
    work buffer of the (B, 2, Cout) statistics, then one partial a tile
    where an image spans tiles, then the split tiles and counters; the
    per-warp sums (16 warps x 2 x 128 fp32) fit past the staged output
    tiles (4 planes x 64 x 128 bf16) within the block's shared memory."""
    B, H, W, cin, cout = shape
    p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits, True)
    q = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits)
    assert {k: v for k, v in p.items() if k != "work_floats"} == \
        {k: v for k, v in q.items() if k != "work_floats"}
    partials = 2 * B * p["tpi"] * cout if p["tpi"] > 1 else 0
    assert p["work_floats"] == 2 * B * cout + partials + q["work_floats"]
    assert 4 * 64 * 128 * 2 + 16 * 2 * 128 * 4 + 1024 <= p["smem"]
    assert p["smem"] <= gn_conv.SMEM_LIMIT
    if p["tpi"] == 1:
        assert p["nb"] * p["rows"] * p["tw"] <= 64
        assert (p["rows"] * p["tw"]) % 16 == 0  # a warp's rows in one image


@pytest.mark.parametrize("shape", SERVED, ids=str)
def test_upstats_plan_fills_the_card(shape):
    """At every served shape the grid (split K included) keeps at least
    half of the 132 SMs busy, within one wave where it splits."""
    p = gn_conv.upconv_sm90_plan(*shape, None, True)
    ctas = p["m_tiles"] * p["n_tiles"] * p["splits"]
    assert ctas >= gn_conv.SM_COUNT // 2
    if p["splits"] > 1:
        assert ctas <= gn_conv.SM_COUNT


def test_upstats_plan_matches_the_source():
    """The source takes K6 on K4's kernel and plan, its sums past the
    staged tiles, the work buffer's layout and the tile-order reduction."""
    text = SM90_CU.read_text()
    for const in ("template <int TW, bool STATS>",
                  "float* const red = reinterpret_cast<float*>(gbase + kRows"
                  " * kBN * 2);",
                  "const GnPlan p = up_plan(B, H, W, Cin, Cout, splits);",
                  "const WorkLayout wl = work_layout(p, B, Cout, want_stats);",
                  "dtp::work_layout(p, B, Cout, want_stats != 0).total};",
                  "return launch_tile_stats_reduce(args.partial, args.stats,"
                  " args.B, p.tpi,",
                  'extern "C" cudaError_t dtp_upsample2x_conv3x3_stats_sm90('):
        assert const in text, const
    epilogue = text[text.index("template <int TW, bool STATS>"):]
    assert "atomicAdd(a.stats" not in epilogue and "atomicAdd(red" not in \
        epilogue


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

    def __getitem__(self, index):
        return self

    def view(self, *shape):
        return _FakeCuda(shape, self.dtype, self.ptr)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upconv_stream_dtype_dispatch(monkeypatch, dtype):
    """A bf16 CUDA call of upconv_stream reaches
    dtp_upsample2x_conv3x3_stats_sm90 of gn_conv_sm90.cu with one work
    buffer whose front is the returned (B, 2, Cout) statistics, an fp32
    call conv3x3.cu's entries; each moves the launch counter by one; a
    bf16 call TMA cannot describe raises before any launch. The old entry
    refuses bf16; the wrapper has no fallback."""
    calls, allocs = [], []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 1 if symbol.endswith("_splits") else (
                8 if symbol == "dtp_stats_workspace_floats" else 0)
        return call

    def empty(shape, dtype=None, device=None, **_):
        shape = (shape,) if isinstance(shape, int) else shape
        allocs.append(tuple(shape))
        return _FakeCuda(shape, dtype, ptr=len(allocs) << 20)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    B, H, W, C = 1, 32, 32, 512
    x, taps, w = (_FakeCuda(s, dtype) for s in ((B, H, W, C), (16, C, C),
                                                (3, 3, C, C)))
    b = _FakeCuda((C,), dtype)
    before = gn_conv.upconv_stream_launches.launches
    out, stats = gn_conv.upconv_stream(x, w, b, taps)
    assert out.shape == (B, 2 * H, 2 * W, C) and out.dtype == dtype
    assert stats.shape == (B, 2, C)
    assert gn_conv.upconv_stream_launches.launches == before + 1
    if dtype == torch.bfloat16:
        assert [c[:2] for c in calls] == [
            ("gn_conv_sm90", "dtp_upsample2x_conv3x3_stats_sm90")]
        plan = gn_conv.upconv_sm90_plan(B, H, W, C, C, None, True)
        assert plan["splits"] == 2 and plan["tpi"] == 16
        assert allocs == [(B, 2 * H, 2 * W, C), (plan["work_floats"],)]
        args = calls[0][2]
        assert args[3] == out.data_ptr() != stats.data_ptr()
        assert args[4] == stats.data_ptr()  # the statistics lead the buffer
        assert args[5:12] == (B, H, W, C, C, 1, 0)
        calls.clear()
        with pytest.raises(ValueError, match="TMA"):
            gn_conv.upconv_stream(_FakeCuda((1, 4, 4, 20), dtype), w, None,
                                  _FakeCuda((16, 20, 16), dtype))
        assert calls == []
    else:
        assert [c[:2] for c in calls] == [
            ("conv3x3", "dtp_upsample2x_conv3x3_splits"),
            ("conv3x3", "dtp_stats_workspace_floats"),
            ("conv3x3", "dtp_upsample2x_conv3x3_stats")]
        assert calls[2][2][14] == 0  # is_bf16
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t '
                          'dtp_upsample2x_conv3x3_stats('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 ||" in entry and "return cudaErrorInvalidValue;" in entry
    assert "launch_fused<float, dtp::kUp>" in entry
    src = Path(gn_conv.__file__).read_text()
    assert "try:" not in src and "except" not in src


def _f32(t):
    """t rounded to fp32 (the emulation's every sum is one fp32 add)."""
    return t.to(torch.float32)


def _emulate(x, taps, b, splits=None):
    """The kernel in torch (fp32 throughout): per tile of the plan (64
    source pixels) and split, each plane's accumulators over its chunks;
    the splits added in split order from zero; y = that + bias. Its
    statistics in the kernel's order: per column, a thread's rows g and
    g + 8 added, then the 8 row groups by the shuffles xor 4, 8, 16 (a
    tree); the 16 warps (plane-major) of each image slot of the tile added
    in order from zero; an image spanning tiles: each tile a partial, then
    tile_stats_reduce's order (lane j adds tiles j, j + 8, ... from zero,
    then the 8 lanes in order). Returns (out rounded to x's dtype, stats)."""
    B, H, W, cin = x.shape
    cout = taps.shape[-1]
    p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits, True)
    tw, rows, nb, tpi = p["tw"], p["rows"], p["nb"], p["tpi"]
    img_pix = rows * tw
    xp = F.pad(x.float(), (0, 0, 1, 2 + rows + tw, 1, 2 + rows + tw))
    xp = torch.cat([xp, xp.new_zeros((nb,) + xp.shape[1:])])
    out = torch.zeros((B, 2 * H, 2 * W, cout))
    stats = torch.zeros((B, 2, cout))
    partial = torch.zeros((B, tpi, 2, cout))
    tf = taps.float()
    for mt in range(p["m_tiles"]):
        if tpi == 1:
            b0, i0, j0, timg = mt * nb, 0, 0, 0
        else:
            b0, timg = divmod(mt, tpi)
            i0, j0 = (timg // p["tiles_w"]) * rows, (timg % p["tiles_w"]) * tw
        ms = torch.arange(64)
        slot, rem = ms // img_pix, ms % img_pix
        bb, yy, xx = b0 + slot, i0 + rem // tw, j0 + rem % tw
        inside = (slot < nb) & (bb < B) & (yy < H) & (xx < W)
        bi = torch.clamp(bb, max=xp.shape[0] - 1)
        red = torch.zeros((16, 2, cout))
        for pl in range(4):
            ry, rx = divmod(pl, 2)
            acc = torch.zeros((64, cout))
            for s in range(p["splits"]):
                part = torch.zeros((64, cout))
                for k in range(s * p["per_split"],
                               min((s + 1) * p["per_split"], p["chunks"])):
                    c = slice(64 * k, 64 * k + 64)
                    for t in range(4):
                        ai, bi_ = divmod(t, 2)
                        a = xp[bi, yy + ry + ai, xx + rx + bi_, c]
                        part = part + a @ tf[pl * 4 + t, c]
                acc = _f32(acc + part)
            y = acc + b.float()
            for m in range(64):
                if inside[m]:
                    out[bb[m], 2 * yy[m] + ry, 2 * xx[m] + rx] = y[m]
            u = torch.where(inside[:, None], y, torch.zeros(()))
            for warp in range(4):
                for row, v in enumerate((u, u * u)):
                    r = v[16 * warp:16 * warp + 16]
                    a = r[:8] + r[8:]
                    a = a[0::2] + a[1::2]
                    a = a[0::2] + a[1::2]
                    red[pl * 4 + warp, row] = a[0] + a[1]
        for k in range(nb):
            if b0 + k >= B:
                continue
            total = torch.zeros((2, cout))
            for wid in range(16):
                if 16 * (wid % 4) // img_pix == k:
                    total = total + red[wid]
            if tpi == 1:
                stats[b0 + k] = total
            else:
                partial[b0 + k, timg] = total
    if tpi > 1:
        for img in range(B):
            lanes = []
            for j in range(8):
                s = torch.zeros((2, cout))
                for t in range(j, tpi, 8):
                    s = s + partial[img, t]
                lanes.append(s)
            s = torch.zeros((2, cout))
            for lane in lanes:
                s = s + lane
            stats[img] = s
    return out.to(x.dtype), stats


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _inputs(shape, seed):
    B, H, W, cin, cout = shape
    x = _rand((B, H, W, cin), seed)
    x = x * (1 + np.arange(B)[:, None, None, None] / 4) \
        + 0.5 * np.arange(B)[:, None, None, None]  # images that differ
    w = _rand((3, 3, cin, cout), seed + 1, (9 * cin) ** -0.5)
    b = _rand((cout,), seed + 2, 0.1, 0.3)
    return x.astype(np.float32), w, b


# fp32 on both sides, sums in other orders: outputs to fp32 accumulation
# error; statistics to 1e-5 of the sums of |y| and y^2 they add (up to
# 4 * 190 pixels of outputs near 1: an order's error is ~1e-6 of them)
STATS_REL = 1e-5


def _assert_stats(got, want, y):
    scale = torch.stack([y.abs().sum((1, 2)), y.square().sum((1, 2))], 1)
    assert ((got - want).abs() <= STATS_REL * scale).all(), \
        ((got - want).abs() / scale).max()


@pytest.mark.parametrize("shape,splits", [
    ((2, 8, 10, 128, 128), None), ((2, 8, 10, 128, 128), 2),
    ((3, 4, 4, 64, 136), None), ((5, 3, 3, 8, 16), None),
    ((1, 9, 19, 40, 136), 1), ((2, 17, 9, 192, 24), 3)], ids=str)
def test_emulated_order_equals_the_plain_version(shape, splits):
    """The emulated kernel (tiles spanning an image, several images a
    tile, a tile past the last image, split and unsplit K) equals
    upconv_stream_plain in fp32: the output within 1e-4, the statistics
    within STATS_REL of their sums."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(shape, sum(shape)))
    got, got_st = _emulate(x, conv3x3.fold_upsample_weights(w), b, splits)
    want, want_st = gn_conv.upconv_stream_plain(x, w, b)
    assert (got - want).abs().max().item() <= 1e-4
    _assert_stats(got_st, want_st, want)


@pytest.mark.parametrize("shape,splits", [
    ((2, 8, 10, 128, 128), None), ((2, 8, 10, 128, 128), 2),
    ((1, 8, 8, 16, 128), None)], ids=str)
def test_emulated_order_matches_pallas(shape, splits):
    """The emulated kernel against the JAX package's _upconv_stream_pallas
    (interpret mode, force="pallas"), statistics included: fp32, the
    output within atol and rtol 1e-4, the statistics within STATS_REL of
    their sums (the two add in other orders)."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.ops import gn_conv_stream as j_gn

    x, w, b = _inputs(shape, 40)
    assert j_gn.upconv_stream_plan(x.shape, w.shape, 4) is not None
    want, want_st = j_gn.upconv_stream(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), True, force="pallas")
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got, got_st = _emulate(xt, conv3x3.fold_upsample_weights(wt), bt, splits)
    want = np.array(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want_st = torch.from_numpy(np.array(want_st)[:, :2])
    _assert_stats(got_st, want_st, torch.from_numpy(want))


def test_plans_entry_point_runs_upstats_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows upstats on the CPU: the plain version,
    the plan's tiles, nothing timed."""
    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "upstats"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["kernel"] for r in record["rows"]] == ["K6", "K6"]
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               and r["stats_max_diff"] == 0.0 for r in record["rows"])


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _card_inputs(gen, B, H, W, cin, cout):
    import chip_smoke

    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = chip_smoke.per_image(rnd(B, H, W, cin), 0.5).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    b = (rnd(cout) * 0.1).bfloat16()
    return x, w, b, conv3x3.fold_upsample_weights(w)


def _pre_rounding(x, taps, b):
    """K6's output before its rounding, in fp32: the same folded bf16 taps
    through F.conv_transpose2d in fp32 (TF32 off)."""
    w4 = conv3x3.transposed_upsample_weight(taps).float()
    return F.conv_transpose2d(x.float().permute(0, 3, 1, 2), w4, b.float(),
                              stride=2, padding=1).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SERVED + RAGGED, ids=str)
def test_sm90_upconv_stream_matches_plain(shape):
    """bf16 K6 against upconv_stream_plain (chip_smoke's tolerance: 2^-5 of
    the largest output magnitude, and of the sums for the statistics), and
    its statistics within 2^-14 of the sums of its own fp32 output before
    the rounding."""
    gen = _setup()
    import chip_smoke

    B, H, W, cin, cout = shape
    r = chip_smoke.compare("upconv_stream",
                           ((B, H, W, cin), (3, 3, cin, cout), True),
                           torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r
    assert r["stats_self_err"] <= chip_smoke.STATS_SELF_TOL, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 32, 512, 512),
                                   (1, 128, 128, 256, 256),
                                   (3, 4, 4, 64, 136),
                                   (1, 9, 19, 40, 136)], ids=str)
def test_sm90_upconv_stream_replays_and_splits_agree(shape):
    """Each call is bit-identical on replay, output and statistics; forced
    splits stay within tolerance of the plain version, and every
    statistics within 2^-14 of the sums of the fp32 output before the
    rounding; without statistics the same output."""
    gen = _setup()
    import chip_smoke

    x, w, b, taps = _card_inputs(gen, *shape)
    want = gn_conv.upconv_stream_plain(x, w, b)[0].float()
    pre = _pre_rounding(x, taps, b)
    tol = 2.0**-5 * want.abs().max().item()
    first, again = (gn_conv.upconv_stream(x, w, b, taps) for _ in range(2))
    forced = [gn_conv._upconv_stream(x, b, taps, True, s) for s in (1, 2, 7)]
    replay = gn_conv._upconv_stream(x, b, taps, True, 7)
    bare, none = gn_conv.upconv_stream(x, w, b, taps, False)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert torch.equal(forced[2][0], replay[0])
    assert torch.equal(forced[2][1], replay[1])
    assert none is None and torch.equal(bare, first[0])
    for out, st in [first] + forced:
        assert (out.float() - want).abs().max().item() <= tol
        assert chip_smoke.stats_self_err(pre, st) <= chip_smoke.STATS_SELF_TOL


@pytest.mark.cuda
def test_sm90_upconv_stream_refuses_what_tma_cannot_describe():
    """bf16 K6 at Cin 20, at Cout 12 and on an input 2 bytes off 16 raises
    ValueError and launches nothing; fp32 at Cin 20 runs the FMA twin;
    conv3x3.cu's entry called in bf16 returns cudaErrorInvalidValue (1)."""
    gen = _setup()
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    counter = gn_conv.upconv_stream_launches
    before = counter.launches
    flat = rnd(1 + 8 * 8 * 16).bfloat16()
    off = flat[1:].view(1, 8, 8, 16)
    for x, cout in ((rnd(1, 8, 8, 20).bfloat16(), 16),
                    (rnd(1, 8, 8, 16).bfloat16(), 12), (off, 16)):
        w = rnd(3, 3, x.shape[-1], cout).bfloat16()
        with pytest.raises(ValueError, match="TMA"):
            gn_conv.upconv_stream(x, w, None,
                                  conv3x3.fold_upsample_weights(w))
    assert counter.launches == before
    x, w, b = rnd(1, 8, 8, 20), rnd(3, 3, 20, 16), rnd(16)
    out, st = gn_conv.upconv_stream(x, w, b, conv3x3.fold_upsample_weights(w))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(st).all()
    xb, tb, bb = (t.bfloat16() for t in (x, conv3x3.fold_upsample_weights(w),
                                         b))
    ob = torch.empty((1, 16, 16, 16), dtype=torch.bfloat16, device="cuda")
    sb = torch.empty((1, 2, 16), device="cuda")
    fn = _cuda.function("conv3x3", "dtp_upsample2x_conv3x3_stats",
                        gn_conv._UP_ARGTYPES)
    assert fn(xb.data_ptr(), tb.data_ptr(), bb.data_ptr(), ob.data_ptr(),
              sb.data_ptr(), sb.data_ptr(), sb.data_ptr(), 1, 8, 8, 20, 16,
              1, 1, 1, _cuda.stream_of(xb)) == 1


@pytest.mark.cuda
def test_sm90_upstats_plan_matches_the_library():
    """ops/gn_conv.py upconv_sm90_plan with statistics equals the built
    library's plan at the served and ragged shapes, forced splits
    included."""
    _setup()
    fn = _cuda.library("gn_conv_sm90").dtp_upsample2x_conv3x3_sm90_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 15)()
    fields = ("tw", "rows", "nb", "win_lines", "stages", "smem", "tiles_h",
              "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks", "splits",
              "per_split", "work_floats")
    for B, H, W, cin, cout in SERVED + RAGGED:
        for splits in (0, 1, 3):
            assert fn(B, H, W, cin, cout, 1, splits, out) == 0
            p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits or None,
                                         True)
            assert list(out) == [p[f] for f in fields]
