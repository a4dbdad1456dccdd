"""bf16 K10 (ops/conv3x3.py gn_silu_conv3x3) and T12 (ops/conv_variants.py
pipelined) on the affine mode of csrc/gn_conv_sm90.cu's K1/K5 kernel.

K10 launches K14's sums of x (csrc/moments.cu), then
dtp_gn_silu_conv3x3_sm90: the GroupNorm folded in the CTA, the prologue
silu(x*a + c) in fp32 rounded once, 0 outside the image, and acc + bias +
temb + residual in fp32 rounded once. T12 launches
dtp_gn_conv_pipelined_sm90: the same prologue from given fp32 a, c on
every window pixel, TMA's zeros included (its border is silu(c)), and
acc + bias rounded once. fp32 stays on the FMA twins (conv_staged.cu,
conv_arms.cu), whose entries refuse bf16.

On the CPU, the host logic that needs no card: the dispatch through a
patched `_cuda.function` (the entries' arguments from the plans, a Cout
off 8 zero-padded and the real channels stored, one count a call; the
fp32 twins' entries with is_bf16 0), the refusals of what TMA cannot
describe (ValueError, no launch), the plans (every output pixel once,
within the H100's shared memory, the tables in the place of the per-warp
statistics) and the sources (the new entries instantiate the mode; the
old entries refuse bf16).

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_affine_sm90.py): each against its
plain version in bf16 at the paths' shapes and ragged ones, bit-identical
replays under the plan's and a forced split of K, the refusals, the
Python plans equal to the library's, the fp32 twins refusing bf16.
"""

import ctypes
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import conv3x3, gn_conv
from diffusiontexturepainting_torch.ops import conv_variants as cv
from test_torch_port_gn_conv_sm90 import _tiles
from test_torch_port_upconv_inpad_taps_sm90 import _FakeCuda, _patch

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "gn_conv_sm90.cu"

# (B, H, W, Cin, Cout): K10 at one UNet eval's resnet convs at 256^2
# (batch 3: conv1 of every body's input, conv2 at Cout -> Cout), among them
# the 4x4 level (three whole images a tile, K split)
K10_UNET = [(3, 32, 32, 320, 320), (3, 32, 32, 960, 320),
            (3, 32, 32, 640, 320), (3, 16, 16, 320, 640),
            (3, 16, 16, 640, 640), (3, 16, 16, 1920, 640),
            (3, 16, 16, 960, 640), (3, 8, 8, 640, 1280),
            (3, 8, 8, 1280, 1280), (3, 8, 8, 2560, 1280),
            (3, 8, 8, 1920, 1280), (3, 4, 4, 1280, 1280),
            (3, 4, 4, 2560, 1280)]
# T12 at the conv_arms path's shapes: the default 256^2/20 stamp's K5
# launches with a prologue (the VAE encoder at batch 2, the decoder at 1)
T12_ARMS = [(2, 256, 256, 128, 128), (2, 128, 128, 128, 256),
            (2, 128, 128, 256, 256), (2, 64, 64, 256, 512),
            (2, 64, 64, 512, 512), (2, 32, 32, 512, 512),
            (2, 32, 32, 512, 8), (1, 32, 32, 512, 512),
            (1, 64, 64, 512, 512), (1, 128, 128, 512, 256),
            (1, 128, 128, 256, 256), (1, 256, 256, 256, 128),
            (1, 256, 256, 128, 128), (1, 256, 256, 128, 3)]
# ragged shapes TMA can describe: odd H and W, Cin 8 and 40, Cout 130
# (padded to 136, 130 stored), a 1x1 image, several images a tile
RAGGED = [(2, 5, 7, 8, 40), (1, 9, 19, 40, 130), (2, 1, 1, 16, 24),
          (5, 3, 3, 8, 16), (2, 17, 33, 64, 256), (3, 4, 4, 96, 40)]
# the bf16 refusals: Cin off 8 (rows of 6, 18 and 40 bytes)
REFUSED_CIN = (3, 9, 20)


def _groups(cin):
    """The GroupNorm's groups of a K10 case: 32 where they divide Cin (the
    UNet's), else the largest of 8, 4, 2, 1 that does."""
    return next(g for g in (32, 8, 4, 2, 1) if cin % g == 0)


class _Fake(_FakeCuda):
    """_FakeCuda with what the K10 and T12 wrappers also read."""

    def element_size(self):
        return torch.empty(0, dtype=self.dtype).element_size()

    def float(self):
        return _Fake(self.shape, torch.float32, self.ptr)

    def contiguous(self):
        return self


def _fakes(B, H, W, cin, cout, dtype, ptr=1 << 20):
    return (_Fake((B, H, W, cin), dtype, ptr),
            _Fake((3, 3, cin, cout), dtype, 3 << 20),
            _Fake((cout,), dtype, 4 << 20))


def _patch_moments(monkeypatch):
    """launch_moments as a stub returning fake (B, 2, C) fp32 sums at a
    known address; returns the list of its calls."""
    seen = []

    def moments(name, x):
        seen.append((name, tuple(x.shape)))
        return _Fake((x.shape[0], 2, x.shape[3]), torch.float32, 5 << 20)
    monkeypatch.setattr(conv3x3, "launch_moments", moments)
    return seen


# --- the plans ---


@pytest.mark.parametrize("shape", K10_UNET + T12_ARMS + RAGGED, ids=str)
@pytest.mark.parametrize("fold", [True, False], ids=["K10", "T12"])
@pytest.mark.parametrize("consumers", [None, 1, 2])
def test_affine_plan_covers_the_output_once(shape, fold, consumers):
    """K1/K5's tile and split (every output pixel once, each warp's 16 rows
    in one image, at most 4 x consumers images a tile: the tables' slots),
    the tables in the place of the per-warp statistics, within the H100's
    232,448 bytes a block with at least 4 B stages; the work buffer the
    split tiles and counters only."""
    B, H, W, cin, cout = shape
    cw = -(-cout // 8) * 8
    plan = gn_conv.gn_silu_sm90_plan if fold else gn_conv.pipelined_sm90_plan
    p = plan(B, H, W, cin, cw, cout, consumers)
    k1 = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cw, cout, False, consumers)
    for key in ("consumers", "tw", "rows", "nb", "m_tiles", "n_tiles",
                "chunks", "splits", "per_split", "work_floats"):
        assert p[key] == k1[key], key
    seen = {}
    for pix in _tiles(p, B, H, W):
        for px in pix:
            seen[px] = seen.get(px, 0) + 1
    assert len(seen) == B * H * W and set(seen.values()) == {1}
    assert p["nb"] <= 4 * p["consumers"]
    region0 = max(4 * p["win_bytes"], 64 * p["consumers"] * 128 * 2)
    tables = gn_conv.affine_table_bytes(p["consumers"], fold)
    assert tables == p["consumers"] * (8192 if fold else 4096)
    assert p["smem"] == (region0 + tables + 8 * 2 * (2 + 8) + 16 + 1024
                         + p["stages"] * gn_conv.GN_B_BYTES)
    assert 4 <= p["stages"] <= 8 and p["smem"] <= gn_conv.SMEM_LIMIT
    ctas = p["m_tiles"] * p["n_tiles"]
    assert p["work_floats"] == (0 if p["splits"] == 1 else
                                ctas * p["splits"] * 64 * p["consumers"]
                                * 128 + ctas)


def test_affine_plan_splits_the_weight_bound_level():
    """At (3, 4, 4, 2560) -> 1280, the three 4x4 images share one tile of
    one consumer warpgroup and K splits over the card (10 N tiles x 10
    splits of 4 chunks)."""
    p = gn_conv.gn_silu_sm90_plan(3, 4, 4, 2560, 1280)
    assert (p["consumers"], p["nb"], p["m_tiles"], p["n_tiles"]) == (
        1, 3, 1, 10)
    assert (p["splits"], p["per_split"]) == (10, 4)


def test_affine_plan_matches_the_source():
    """The Python plans mirror the source's affine_plan and its table
    bytes; the mode's bits are the ones the header names."""
    text = SM90_CU.read_text()
    for line in (
            "constexpr int kMaxGroups = 128;",
            "return 4 * nc * (2 * 2 * kAtom + (fold ? 2 * kMaxGroups : 0)) "
            "* 4;",
            "GnPlan p = plan(B, H, W, Cin, Cout, nc, splits);\n"
            "  const int fixed = p.region0 + affine_table_bytes(p.nc, fold) "
            "+\n                    8 * 2 * (kWinStages + kMaxBStages) + 16 "
            "+ 1024;",
            "constexpr int kK10 = kF32Affine | kMask | kFold | kOneRound;",
            "constexpr int kT12 = kF32Affine | kOneRound;"):
        assert line in text, line
    assert gn_conv.AFFINE_MAX_GROUPS == 128


# --- the sources ---


def _entry(text, head):
    body = text[text.index(head):]
    return body[:body.index("\n}\n")]


def test_the_mode_is_instantiated_by_the_new_entries_only():
    """K1/K5's and K7's launches name no affine mode; the affine launches
    are K10's and T12's, each entry with its bits; the kernel reads the
    mode only in if constexpr conditions."""
    text = SM90_CU.read_text()
    assert 'extern "C" cudaError_t dtp_gn_silu_conv3x3_sm90(' in text
    assert 'extern "C" cudaError_t dtp_gn_conv_pipelined_sm90(' in text
    assert 'extern "C" int dtp_gn_silu_conv3x3_sm90_plan(' in text
    assert 'extern "C" int dtp_gn_conv_pipelined_sm90_plan(' in text
    assert "template <int TW, int NC, bool PLAIN, int AFF = 0>" in text
    assert text.count("launch<2, false, AFF>") == 1
    assert text.count("launch<2, false>(tx, tw, args, p, s)") == 1
    assert text.count("launch<2, true>(tx, tw, args, p, s)") == 1
    assert "affine_conv<kK10>(" in _entry(
        text, 'extern "C" cudaError_t dtp_gn_silu_conv3x3_sm90(')
    assert "affine_conv<kT12>(" in _entry(
        text, 'extern "C" cudaError_t dtp_gn_conv_pipelined_sm90(')
    kernel = text[text.index("gn_conv_sm90(const __grid_constant__"):
                  text.index("// K4: warpgroup p computes parity plane")]
    for bit in ("kF32Affine", "kFold", "kOneRound"):
        assert f"if constexpr (has(AFF, {bit}))" in kernel
    # no local constants of the mode's bits (they moved the other modes'
    # machine code)
    assert "constexpr bool" not in kernel


def test_the_fp32_twins_refuse_bf16():
    """conv_staged.cu's K10 entry and conv_arms.cu's T12 entry return
    cudaErrorInvalidValue for bf16 and instantiate fp32 only."""
    staged = (_cuda.CSRC / "conv_staged.cu").read_text()
    assert "if (is_bf16) return cudaErrorInvalidValue;" in _entry(
        staged, "cudaError_t dispatch(")
    assert "__nv_bfloat16" not in staged
    arms = (_cuda.CSRC / "conv_arms.cu").read_text()
    entry = _entry(arms, 'extern "C" cudaError_t dtp_gn_conv_pipelined(')
    assert "if (is_bf16) return cudaErrorInvalidValue;" in entry
    assert "launch_pipelined<float>" in entry and "__nv_bfloat16" not in arms


def test_wrappers_have_no_fallback():
    for mod, head, tail in ((conv3x3, "def _gn_silu_conv3x3(", None),
                            (cv, "def _pipelined(", "def taps_tma_")):
        src = Path(mod.__file__).read_text()
        body = src[src.index(head):src.index(tail) if tail else None]
        assert "try:" not in body and "except" not in body
        assert body.index("torch.bfloat16") < body.index("GN_SM90_SOURCE")


# --- the dispatch on the CPU ---


@pytest.mark.parametrize("shape", K10_UNET[-2:] + RAGGED[:3], ids=str)
@pytest.mark.parametrize("extras", [(False, False), (True, False),
                                    (False, True)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k10_dispatch(monkeypatch, dtype, extras, shape):
    """bf16 K10 takes K14's sums, then dtp_gn_silu_conv3x3_sm90 with
    gn_silu_sm90_plan's arguments (a work buffer exactly where the plan
    splits K; a Cout off 8 padded to 8 with the real one stored); fp32
    takes the same sums, then the staged twin with is_bf16 0; one count
    a call, with the counter's shape key."""
    calls = _patch(monkeypatch)
    moments = _patch_moments(monkeypatch)
    B, H, W, cin, cout = shape
    x, w, b = _fakes(B, H, W, cin, cout, dtype)
    scale, shift = _Fake((cin,), dtype, 6 << 20), _Fake((cin,), dtype,
                                                        7 << 20)
    temb = _Fake((B, cout), dtype, 8 << 20) if extras[0] else None
    res = _Fake((B, H, W, cout), dtype, 9 << 20) if extras[1] else None
    g = _groups(cin)
    counter = conv3x3.gn_silu_conv3x3_launches
    before = counter.launches
    out = conv3x3.gn_silu_conv3x3(x, scale, shift, w, b, temb, res, g, 1e-6)
    assert out.shape == (B, H, W, cout) and out.dtype == dtype
    assert counter.launches == before + 1
    assert counter.shapes[((B, H, W, cin), (3, 3, cin, cout), extras[0],
                           extras[1], g)] >= 1
    assert moments == [("gn_silu_conv3x3", (B, H, W, cin))]
    assert len(calls) == 1
    source, symbol, args = calls[0]
    ptrs = (x.ptr, 5 << 20, 6 << 20, 7 << 20)
    tail = (None if temb is None else temb.ptr,
            None if res is None else res.ptr)
    if dtype == torch.bfloat16:
        cw = -(-cout // 8) * 8
        assert (source, symbol) == ("gn_conv_sm90",
                                    "dtp_gn_silu_conv3x3_sm90")
        plan = gn_conv.gn_silu_sm90_plan(B, H, W, cin, cw, cout)
        assert args[:4] == ptrs
        # a weight and bias padded to 8 channels are new tensors
        assert (args[4], args[5]) == ((w.ptr, b.ptr) if cw == cout
                                      else (2 << 20, 2 << 20))
        assert args[6:8] == tail
        assert (args[9] is not None) == (plan["splits"] > 1)
        assert args[10] == pytest.approx(1e-6)
        assert args[11:20] == (B, H, W, cin, cw, cout, g, 0, 0)
    else:
        assert (source, symbol) == ("conv_staged",
                                    "dtp_gn_silu_conv3x3_staged")
        assert args[:7] == ptrs + (w.ptr, b.ptr, tail[0])
        assert args[7] == tail[1]
        assert args[10:17] == (B, H, W, cin, cout, g, 0)


def test_k10_bf16_refuses_what_tma_cannot_describe(monkeypatch):
    """bf16 K10 at Cin 3, 9, 20 and on an x or a residual 2 bytes off 16
    raises ValueError before K14's sums or any launch, and moves no count;
    fp32 runs the staged twin there."""
    calls = _patch(monkeypatch)
    moments = _patch_moments(monkeypatch)
    counter = conv3x3.gn_silu_conv3x3_launches
    before = counter.launches
    cases = []
    for cin in REFUSED_CIN:
        cases.append(_fakes(1, 5, 7, cin, 16, torch.bfloat16) + (cin, None))
    cases.append(_fakes(1, 5, 7, 16, 16, torch.bfloat16, (1 << 20) + 2)
                 + (16, None))
    cases.append(_fakes(1, 5, 7, 16, 16, torch.bfloat16)
                 + (16, _Fake((1, 5, 7, 16), torch.bfloat16, (9 << 20) + 2)))
    for x, w, b, cin, res in cases:
        s = _Fake((cin,), torch.bfloat16)
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.gn_silu_conv3x3(x, s, s, w, b, None, res, _groups(cin))
    assert calls == [] and moments == [] and counter.launches == before
    x, w, b = _fakes(1, 5, 7, 3, 16, torch.float32)
    s = _Fake((3,), torch.float32)
    conv3x3.gn_silu_conv3x3(x, s, s, w, b, num_groups=3)
    assert [c[1] for c in calls] == ["dtp_gn_silu_conv3x3_staged"]


@pytest.mark.parametrize("shape", T12_ARMS[:2] + T12_ARMS[-2:] + RAGGED[:3],
                         ids=str)
@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pipelined_dispatch(monkeypatch, dtype, has_bias, shape):
    """bf16 T12 reaches dtp_gn_conv_pipelined_sm90 with
    pipelined_sm90_plan's arguments (a Cout off 8 padded, the real one
    stored; a work buffer exactly where the plan splits K); fp32 the FMA
    twin dtp_gn_conv_pipelined with is_bf16 0; one count a call."""
    calls = _patch(monkeypatch)
    B, H, W, cin, cout = shape
    x, w, b = _fakes(B, H, W, cin, cout, dtype)
    b = b if has_bias else None
    a = _Fake((B, cin), torch.float32, 6 << 20)
    c = _Fake((B, cin), torch.float32, 7 << 20)
    before = cv.pipelined_launches.launches
    out = cv.pipelined(x, a, c, w, b)
    assert out.shape == (B, H, W, cout) and out.dtype == dtype
    assert cv.pipelined_launches.launches == before + 1
    assert len(calls) == 1
    source, symbol, args = calls[0]
    if dtype == torch.bfloat16:
        cw = -(-cout // 8) * 8
        assert (source, symbol) == ("gn_conv_sm90",
                                    "dtp_gn_conv_pipelined_sm90")
        plan = gn_conv.pipelined_sm90_plan(B, H, W, cin, cw, cout)
        assert args[:3] == (x.ptr, a.ptr, c.ptr)
        padded = cw != cout
        assert args[3] == (2 << 20 if padded else w.ptr)
        assert args[4] == (None if b is None else
                           2 << 20 if padded else b.ptr)
        assert (args[6] is not None) == (plan["splits"] > 1)
        assert args[7:15] == (B, H, W, cin, cw, cout, 0, 0)
    else:
        assert (source, symbol) == ("conv_arms", "dtp_gn_conv_pipelined")
        assert args[:5] == (x.ptr, a.ptr, c.ptr, w.ptr,
                            None if b is None else b.ptr)
        assert args[6:12] == (B, H, W, cin, cout, 0)


def test_pipelined_bf16_refuses_what_tma_cannot_describe(monkeypatch):
    """bf16 T12 at Cin 3, 9 and 20 and on an x 2 bytes off 16 raises
    ValueError before any launch and moves no count; fp32 runs the FMA
    twin there."""
    calls = _patch(monkeypatch)
    before = cv.pipelined_launches.launches
    cases = [_fakes(2, 5, 7, cin, 40, torch.bfloat16) + (cin,)
             for cin in REFUSED_CIN]
    cases.append(_fakes(2, 5, 7, 16, 40, torch.bfloat16, (1 << 20) + 2)
                 + (16,))
    for x, w, b, cin in cases:
        a = _Fake((2, cin), torch.float32)
        with pytest.raises(ValueError, match="TMA"):
            cv.pipelined(x, a, a, w, b)
    assert calls == [] and cv.pipelined_launches.launches == before
    x, w, b = _fakes(2, 5, 7, 3, 40, torch.float32)
    cv.pipelined(x, _Fake((2, 3), torch.float32),
                 _Fake((2, 3), torch.float32), w, b)
    assert [c[1] for c in calls] == ["dtp_gn_conv_pipelined"]


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _k10_key(B, H, W, cin, cout, temb=True, res=True):
    return ((B, H, W, cin), (3, 3, cin, cout), temb, res, _groups(cin))


def _t12_key(B, H, W, cin, cout, bias=True):
    return ((B, H, W, cin), (3, 3, cin, cout), bias)


K10_KEYS = ([_k10_key(*s, res=False) for s in K10_UNET]
            + [_k10_key(*s, temb=False) for s in K10_UNET[::3]]
            + [_k10_key(*s, temb=t, res=r) for s in RAGGED
               for t, r in ((True, True), (False, False))])
T12_KEYS = ([_t12_key(*s) for s in T12_ARMS]
            + [_t12_key(*s, bias=bias) for s in RAGGED
               for bias in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("key", K10_KEYS, ids=str)
def test_k10_matches_plain(key):
    """bf16 K10 against gn_silu_conv3x3_plain (chip_smoke's tolerance: 2^-5
    of the largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("gn_silu_conv3x3", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("key", T12_KEYS, ids=str)
def test_t12_matches_plain(key):
    """bf16 T12 against plain_pipelined (the same tolerance)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("pipelined", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


def _k10_operands(gen, B, H, W, cin, cout):
    rnd = lambda *s, std=1.0: (torch.randn(s, generator=gen, device="cuda")
                               * std).bfloat16()
    return (rnd(B, H, W, cin) + 0.3, rnd(cin, std=0.2) + 1, rnd(cin, std=0.2),
            rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout, std=0.1),
            rnd(B, cout), rnd(B, H, W, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 2560, 1280),
                                   (3, 8, 8, 1920, 1280),
                                   (3, 32, 32, 320, 320),
                                   (2, 17, 33, 64, 136)], ids=str)
def test_replays_are_bit_identical_under_split(shape):
    """K10 (temb and residual) and T12, each twice under the plan's split
    of K and twice under a forced split of 3 (the epilogue once, after
    the ordered sum): bit-identical on replay; the split and unsplit
    outputs within the tolerance of each other; one and two consumer
    warpgroups without a split give the same bits."""
    gen = _setup()
    x, s, sh, w, b, t, r = _k10_operands(gen, *shape)
    B, cin = shape[0], shape[3]
    a = torch.rand((B, cin), generator=gen, device="cuda") + 0.5
    c = torch.randn((B, cin), generator=gen, device="cuda") * 0.2
    k10 = lambda **kw: conv3x3._gn_silu_conv3x3(x, s, sh, w, b, t, r, 32,
                                                1e-5, **kw)
    t12 = lambda **kw: cv._pipelined(x, a, c, w, b, **kw)
    for op in (k10, t12):
        outs = {kw: (op(**dict(kw)), op(**dict(kw)))
                for kw in ((), (("splits", 3),), (("splits", 1),),
                           (("consumers", 1), ("splits", 1)),
                           (("consumers", 2), ("splits", 1)))}
        torch.cuda.synchronize()
        for first, again in outs.values():
            assert torch.equal(first, again)
        one = outs[(("consumers", 1), ("splits", 1))][0]
        assert torch.equal(one, outs[(("consumers", 2), ("splits", 1))][0])
        ref = outs[(("splits", 1),)][0].float()
        tol = 2.0**-5 * ref.abs().max().item()
        for first, _ in outs.values():
            assert (first.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_t12_border_is_silu_of_c_in_bf16():
    """x = 0, a = 0: every conv input, the pad ring included (TMA's zeros
    through the prologue), is silu(c), so every output is the full 9-tap
    sum, corners included; Cout 130 stored from the padded 136."""
    _setup()
    cin, cout = 40, 130
    x = torch.zeros((2, 9, 21, cin), device="cuda").bfloat16()
    a = torch.zeros((2, cin), device="cuda")
    c = torch.linspace(-2, 2, cin, device="cuda").repeat(2, 1)
    w = torch.ones((3, 3, cin, cout), device="cuda").bfloat16()
    got = cv.pipelined(x, a, c, w, None).float()
    v = F.silu(c[0]).bfloat16().float()
    full = 9 * v.sum().item()
    assert got.shape == (2, 9, 21, cout)
    assert (got - full).abs().max().item() <= 2.0**-7 * abs(full)


@pytest.mark.cuda
def test_k10_border_is_zero_and_temb_is_per_image():
    """K10 at the 4x4 level of three images in one tile: x constant within
    each image, scale 0 and shift 1 (v = silu(1) inside, 0 outside), unit
    weights, temb different per image: a corner pixel sums 4 taps, an
    edge pixel 6, an interior one 9, plus its own image's temb."""
    _setup()
    B, H, W, cin, cout = 3, 4, 4, 64, 16
    x = torch.arange(B, device="cuda").float().view(B, 1, 1, 1).expand(
        B, H, W, cin).contiguous().bfloat16()
    scale = torch.zeros(cin, device="cuda").bfloat16()
    shift = torch.ones(cin, device="cuda").bfloat16()
    w = torch.full((3, 3, cin, cout), 1.0 / 64, device="cuda").bfloat16()
    temb = (torch.arange(B, device="cuda").float()[:, None] * 10).expand(
        B, cout).contiguous().bfloat16()
    got = conv3x3.gn_silu_conv3x3(x, scale, shift, w, None, temb, None,
                                  32).float()
    v = F.silu(torch.tensor(1.0)).bfloat16().float().item()
    taps = torch.tensor([[4, 6, 6, 4], [6, 9, 9, 6], [6, 9, 9, 6],
                         [4, 6, 6, 4]], dtype=torch.float32, device="cuda")
    want = taps[None, :, :, None] * v + torch.arange(
        B, device="cuda").float().view(B, 1, 1, 1) * 10
    assert (got - want).abs().max().item() <= 2.0**-7 * want.abs().max()


@pytest.mark.cuda
def test_refusals_launch_nothing_on_the_card():
    """bf16 K10 and T12 at Cin 3, 9, 20 and on a base 2 bytes off 16 raise
    ValueError and move no count; the fp32 twins run there."""
    gen = _setup()
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    counters = (conv3x3.gn_silu_conv3x3_launches, cv.pipelined_launches)
    before = [c.launches for c in counters]
    for cin in REFUSED_CIN:
        x, w = rnd(1, 5, 7, cin).bfloat16(), rnd(3, 3, cin, 16).bfloat16()
        s = rnd(cin).bfloat16()
        a = rnd(1, cin)
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.gn_silu_conv3x3(x, s, s, w, None,
                                    num_groups=_groups(cin))
        with pytest.raises(ValueError, match="TMA"):
            cv.pipelined(x, a, a, w, None)
    flat = rnd(1 + 5 * 7 * 16).bfloat16()
    off = flat[1:].view(1, 5, 7, 16)
    w, s, a = rnd(3, 3, 16, 16).bfloat16(), rnd(16).bfloat16(), rnd(1, 16)
    with pytest.raises(ValueError, match="TMA"):
        conv3x3.gn_silu_conv3x3(off, s, s, w, None, num_groups=8)
    with pytest.raises(ValueError, match="TMA"):
        cv.pipelined(off, a, a, w, None)
    assert [c.launches for c in counters] == before
    x = rnd(1, 5, 7, 3)
    out = conv3x3.gn_silu_conv3x3(x, rnd(3), rnd(3), rnd(3, 3, 3, 16), None,
                                  num_groups=3)
    out2 = cv.pipelined(x, rnd(1, 3), rnd(1, 3), rnd(3, 3, 3, 16), None)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(out2).all()


@pytest.mark.cuda
def test_fp32_twin_entries_refuse_bf16():
    """dtp_gn_silu_conv3x3_staged and dtp_gn_conv_pipelined called with
    is_bf16 1 return cudaErrorInvalidValue (1) and launch nothing."""
    gen = _setup()
    x = torch.randn((1, 8, 8, 16), generator=gen, device="cuda").bfloat16()
    w = torch.randn((3, 3, 16, 16), generator=gen, device="cuda").bfloat16()
    st = torch.ones((1, 2, 16), device="cuda")
    a = torch.ones((1, 16), device="cuda")
    out = torch.empty_like(x)
    stream = _cuda.stream_of(x)
    staged = _cuda.function("conv_staged", "dtp_gn_silu_conv3x3_staged",
                            conv3x3._GN_STAGED_ARGTYPES)(
        x.data_ptr(), st.data_ptr(), x.data_ptr(), x.data_ptr(),
        w.data_ptr(), None, None, None, out.data_ptr(), 1e-5, 1, 8, 8, 16,
        16, 4, 1, stream)
    piped = _cuda.function("conv_arms", "dtp_gn_conv_pipelined",
                           cv._PIPE_ARGTYPES)(
        x.data_ptr(), a.data_ptr(), a.data_ptr(), w.data_ptr(), None,
        out.data_ptr(), 1, 8, 8, 16, 16, 1, stream)
    torch.cuda.synchronize()
    assert (staged, piped) == (1, 1)


@pytest.mark.cuda
def test_plans_match_the_library():
    """gn_silu_sm90_plan and pipelined_sm90_plan equal the built library's
    plans at the paths' shapes and ragged ones, forced tiles and splits
    included."""
    _setup()
    lib = _cuda.library("gn_conv_sm90")
    fields = ("consumers", "tw", "rows", "nb", "win_lines", "stages", "smem",
              "tiles_h", "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks",
              "splits", "per_split", "work_floats")
    out = (ctypes.c_longlong * 16)()
    for symbol, plan in (("dtp_gn_silu_conv3x3_sm90_plan",
                          gn_conv.gn_silu_sm90_plan),
                         ("dtp_gn_conv_pipelined_sm90_plan",
                          gn_conv.pipelined_sm90_plan)):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        for B, H, W, cin, cout in K10_UNET + T12_ARMS + RAGGED:
            cw = -(-cout // 8) * 8
            for nc in (0, 1, 2):
                for splits in (0, 3):
                    assert fn(B, H, W, cin, cw, cout, nc, splits, out) == 0
                    p = plan(B, H, W, cin, cw, cout, nc or None,
                             splits or None)
                    assert list(out) == [int(p[f]) for f in fields]
        assert fn(1, 4, 4, 12, 16, 16, 0, 0, out) == -1


@pytest.mark.cuda
def test_counts_move_once_a_call():
    """A CUDA call of each wrapper launches its kernel once (its count
    moves by one) in bf16 and in fp32."""
    gen = _setup()
    for dt in (torch.bfloat16, torch.float32):
        x, s, sh, w, b, t, r = (v.to(dt) for v in _k10_operands(
            gen, 2, 6, 6, 32, 24))
        a = torch.ones((2, 32), device="cuda")
        for counter, call in (
                (conv3x3.gn_silu_conv3x3_launches,
                 lambda: conv3x3.gn_silu_conv3x3(x, s, sh, w, b, t, r, 8)),
                (cv.pipelined_launches,
                 lambda: cv.pipelined(x, a, a, w, b))):
            before = counter.launches
            out = call()
            torch.cuda.synchronize()
            assert out.dtype == dt and counter.launches == before + 1
            assert math.isfinite(out.float().abs().max().item())
