"""The bf16 K4 kernel: the x2-upsample conv as four parity planes over one
staged window, the upsample mode of csrc/gn_conv_sm90.cu.

On the CPU, the host logic that needs no card: the plan at every served
shape (the tiles covering every source pixel once, the splits covering the
channel chunks once, the stages a multiple of the four planes, within the
H100's shared memory, filling the card), the check that TMA can describe
the operands, the dtype dispatch between the sm90 entry (bf16) and the
FMA twin (fp32, csrc/conv3x3.cu) through a patched `_cuda.function`, a
torch emulation of the kernel's taps (each plane's window shifts and the
weight ring's order) against the plain version, and the yardstick:
F.conv_transpose2d on the 4x4 weight assembled from the folded taps
computes upsample2x_conv3x3_plain's function.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_upconv_sm90.py): the kernel
against its plain version at the served and ragged shapes, forced splits
included, bit-identical replays of split calls, the Python plan held equal
to the built library's, refusals that launch nothing.
"""

import ctypes
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import conv3x3, gn_conv

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "gn_conv_sm90.cu"
OLD_CU = _cuda.CSRC / "conv3x3.cu"

# (B, H, W, Cin, Cout): the UNet's upsamplers' sources (batch 3) at 256^2,
# 512^2 and 1024^2, and the safe twin's VAE decoder's at 256^2
SERVED = [(3, 4, 4, 1280, 1280), (3, 8, 8, 1280, 1280),
          (3, 16, 16, 640, 640), (3, 16, 16, 1280, 1280),
          (3, 32, 32, 640, 640), (3, 32, 32, 1280, 1280),
          (3, 64, 64, 640, 640)]
TWIN_VAE = [(1, 32, 32, 512, 512), (1, 64, 64, 512, 512),
            (1, 128, 128, 256, 256)]
# odd sizes, Cin off 64, Cout off 128, one pixel, several images a tile
RAGGED = [(1, 5, 7, 64, 72), (1, 9, 19, 40, 136), (2, 1, 1, 16, 8),
          (5, 3, 3, 8, 16), (2, 17, 33, 24, 40)]


def _tiles(p, B, H, W):
    """Each tile's source pixels as (b, y, x), from the kernel's decode."""
    for mt in range(p["m_tiles"]):
        if p["tpi"] == 1:
            b0, i0, j0 = mt * p["nb"], 0, 0
        else:
            b0, rem = divmod(mt, p["tpi"])
            i0 = (rem // p["tiles_w"]) * p["rows"]
            j0 = (rem % p["tiles_w"]) * p["tw"]
        pix = []
        for m in range(64):
            slot, rem = divmod(m, p["rows"] * p["tw"])
            b, y, x = b0 + slot, i0 + rem // p["tw"], j0 + rem % p["tw"]
            if slot < p["nb"] and b < B and y < H and x < W:
                pix.append((b, y, x))
        yield pix


@pytest.mark.parametrize("shape", SERVED + TWIN_VAE + RAGGED, ids=str)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_upconv_plan_covers_the_output_once(shape, splits):
    """The 64-pixel tiles cover every source pixel once (so the four
    planes every output pixel once); the N tiles cover Cout; the splits
    cover the channel chunks once; the B stages are a multiple of the four
    planes, at least two a plane, and the shared memory (which the output
    staging of 4 x 64 x 128 bf16 aliases) within the H100's 232,448 bytes
    a block; the grid within CUDA's y and z limits."""
    B, H, W, cin, cout = shape
    p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits)
    seen = {}
    for pix in _tiles(p, B, H, W):
        for px in pix:
            seen[px] = seen.get(px, 0) + 1
    assert len(seen) == B * H * W and set(seen.values()) == {1}
    assert p["consumers"] == gn_conv.UP_PLANES == 4
    assert p["nb"] * p["rows"] * p["tw"] <= 64
    assert (p["n_tiles"] - 1) * 128 < cout <= p["n_tiles"] * 128
    chunks = [c for s in range(p["splits"])
              for c in range(s * p["per_split"],
                             min((s + 1) * p["per_split"], p["chunks"]))]
    assert chunks == list(range(-(-cin // 64)))
    assert p["stages"] % 4 == 0 and p["stages"] >= 8
    assert p["smem"] <= gn_conv.SMEM_LIMIT
    staged = 2 * p["win_bytes"] + p["stages"] * gn_conv.GN_B_BYTES
    assert staged >= 4 * 64 * 128 * 2
    assert p["m_tiles"] <= 65535 and p["splits"] <= 65535
    ctas = p["m_tiles"] * p["n_tiles"]
    assert p["work_floats"] == (ctas * p["splits"] * 4 * 64 * 128 + ctas
                                if p["splits"] > 1 else 0)


@pytest.mark.parametrize("shape", SERVED + TWIN_VAE, ids=str)
def test_upconv_plan_fills_the_card(shape):
    """At every served shape the grid (split K included) keeps at least
    half of the 132 SMs busy, within one wave where it splits; the three
    4x4 images share one tile."""
    B, H, W, cin, cout = shape
    p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout)
    ctas = p["m_tiles"] * p["n_tiles"] * p["splits"]
    assert ctas >= gn_conv.SM_COUNT // 2
    if p["splits"] > 1:
        assert ctas <= gn_conv.SM_COUNT
    if H == 4:
        assert p["nb"] == 3 and p["m_tiles"] == 1 and p["splits"] == 10


def test_upconv_plan_matches_the_source():
    """upconv_sm90_plan mirrors the source's constants and rules."""
    text = SM90_CU.read_text()
    for const in (f"kUpWG = {gn_conv.UP_PLANES};",
                  f"kUpMaxStages = {gn_conv.UP_MAX_B_STAGES};",
                  "GnPlan p = plan_of(1, B, H, W, Cin, Cout);",
                  "p.region0 = kWinStages * p.win_bytes;",
                  "p.region0 + 8 * (2 * kWinStages + kUpMaxStages) + 16 + 1024;",
                  "p.stages = (kSmemLimit - fixed) / kBBytes / kUpWG * kUpWG;",
                  "blocks >= kSMs ? 1 : kSMs / blocks"):
        assert const in text, const


@pytest.mark.parametrize("cin,cout,offset,ok", [
    (1280, 1280, 0, True), (64, 72, 0, True), (16, 8, 0, True),
    (20, 16, 0, False), (16, 12, 0, False), (16, 16, 1, False)])
def test_upconv_tma_describable(cin, cout, offset, ok):
    """Cin and Cout multiples of 8 and 16-byte-aligned bases."""
    flat = torch.empty(offset + 4 * 4 * cin, dtype=torch.bfloat16)
    x = flat[offset:].view(1, 4, 4, cin)
    taps = torch.empty((16, cin, cout), dtype=torch.bfloat16)
    assert gn_conv.upconv_tma_describable(x, taps) == ok


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
def test_upconv_dtype_dispatch(monkeypatch, dtype):
    """A bf16 CUDA call of upsample2x_conv3x3 reaches
    dtp_upsample2x_conv3x3_sm90 of gn_conv_sm90.cu with the plan's split
    buffer (the 4x4 level splits K), an fp32 call conv3x3.cu's entry; each
    moves the launch counter by one; a bf16 call TMA cannot describe
    raises before any launch. The old entry refuses bf16; the wrapper has
    no fallback."""
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
    B, H, W, C = 3, 4, 4, 1280
    x, taps, w = (_FakeCuda(s, dtype) for s in ((B, H, W, C), (16, C, C),
                                                (3, 3, C, C)))
    b = _FakeCuda((C,), dtype)
    before = conv3x3.upsample_launches.launches
    out = conv3x3.upsample2x_conv3x3(x, w, b, taps)
    assert out.shape == (B, 2 * H, 2 * W, C) and out.dtype == dtype
    assert conv3x3.upsample_launches.launches == before + 1
    if dtype == torch.bfloat16:
        assert [c[:2] for c in calls] == [("gn_conv_sm90",
                                           "dtp_upsample2x_conv3x3_sm90")]
        args = calls[0][2]
        assert args[4] is not None  # the split tiles and counters
        assert args[5:11] == (B, H, W, C, C, 0)
        calls.clear()
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.upsample2x_conv3x3(_FakeCuda((1, 4, 4, 20), dtype), w,
                                       None, _FakeCuda((16, 20, 16), dtype))
        assert calls == []
    else:
        assert [c[:2] for c in calls] == [
            ("conv3x3", "dtp_upsample2x_conv3x3_splits"),
            ("conv3x3", "dtp_upsample2x_conv3x3")]
        assert calls[1][2][11] == 0  # is_bf16
    assert 'extern "C" cudaError_t dtp_upsample2x_conv3x3_sm90(' in \
        SM90_CU.read_text()
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_upsample2x_conv3x3('):]
    assert "if (is_bf16) return cudaErrorInvalidValue;" in \
        entry[:entry.index("\n}\n")]
    src = Path(conv3x3.__file__).read_text()
    assert "try:" not in src and "except" not in src


def _emulate(x, taps, b):
    """The kernel's taps in torch: the producer's ring order (position
    4 * (4 * chunk + t) + p holds plane p's tap t, taps[p * 4 + t]) read
    back by warpgroup p at positions p, p + 4, ...; plane (ry, rx) = (p / 2,
    p % 2) sums, over its taps t = (ai, bi), the source window shifted by
    (ry + ai, rx + bi) (the source zero-padded by one pixel, as TMA's
    out-of-bounds zeros give it) times the tap; + bias, one rounding;
    output pixel (2y + ry, 2x + rx)."""
    B, H, W, cin = x.shape
    ring = [(q % 4, q // 4) for q in range(16)]  # (plane, tap) by position
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.empty((B, 2 * H, 2 * W, taps.shape[-1]), dtype=x.dtype)
    for p in range(4):
        ry, rx = divmod(p, 2)
        acc = 0.0
        for t in range(4):
            plane, tap_t = ring[4 * t + p]
            assert plane == p and tap_t == t
            ai, bi = divmod(t, 2)
            win = xp[:, ry + ai:ry + ai + H, rx + bi:rx + bi + W]
            acc = acc + win @ taps[p * 4 + t].float()
        out[:, ry::2, rx::2] = (acc + b.float()).to(x.dtype)
    return out


@pytest.mark.parametrize("shape", [(1, 5, 7, 8, 16), (2, 4, 4, 16, 8),
                                   (1, 9, 6, 24, 40)], ids=str)
def test_emulated_planes_equal_the_upsample_conv(shape):
    """The emulation of the kernel's planes and taps equals
    upsample2x_conv3x3_plain in fp32 (1e-5: the folded taps' sums)."""
    B, H, W, cin, cout = shape
    gen = torch.Generator().manual_seed(H * W + cin)
    x = torch.randn((B, H, W, cin), generator=gen)
    w = torch.randn((3, 3, cin, cout), generator=gen) * (9 * cin) ** -0.5
    b = torch.randn(cout, generator=gen) * 0.1
    got = _emulate(x, conv3x3.fold_upsample_weights(w), b)
    want = conv3x3.upsample2x_conv3x3_plain(x, w, b)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(1, 5, 7, 8, 16), (3, 4, 4, 32, 24),
                                   (2, 1, 1, 16, 8), (1, 6, 9, 12, 20)],
                         ids=str)
def test_conv_transpose_on_the_assembled_weight_is_the_upsample_conv(shape):
    """F.conv_transpose2d(x, W4, stride 2, padding 1) with W4 assembled
    from the 16 folded taps (k = 0: (1, 1) w2, 1: (0, 1) w1 + w2, 2:
    (1, 0) w0 + w1, 3: (0, 0) w0 per axis) equals upsample2x_conv3x3_plain
    in fp32 (atol 1e-5): the yardstick computes K4's function."""
    B, H, W, cin, cout = shape
    gen = torch.Generator().manual_seed(B + H + W + cin)
    x = torch.randn((B, H, W, cin), generator=gen)
    w = torch.randn((3, 3, cin, cout), generator=gen) * (9 * cin) ** -0.5
    b = torch.randn(cout, generator=gen) * 0.1
    w4 = conv3x3.transposed_upsample_weight(conv3x3.fold_upsample_weights(w))
    assert w4.shape == (cin, cout, 4, 4)
    got = F.conv_transpose2d(x.permute(0, 3, 1, 2), w4, b, stride=2,
                             padding=1).permute(0, 2, 3, 1)
    want = conv3x3.upsample2x_conv3x3_plain(x, w, b)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


def test_plans_entry_point_runs_upconv_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows upconv on the CPU: the plain version,
    the plan's tiles, nothing timed."""
    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "upconv"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["kernel"] for r in record["rows"]] == ["K4", "K4"]
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               for r in record["rows"])


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _key(B, H, W, cin, cout):
    return ((B, H, W, cin), (3, 3, cin, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SERVED + TWIN_VAE + RAGGED, ids=str)
def test_sm90_upconv_matches_plain(shape):
    """bf16 K4 against upsample2x_conv3x3_plain (chip_smoke's tolerance:
    2^-5 of the largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("upsample2x_conv3x3", _key(*shape),
                           torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 1280, 1280),
                                   (3, 8, 8, 1280, 1280),
                                   (3, 16, 16, 640, 640),
                                   (1, 9, 19, 40, 136)], ids=str)
def test_sm90_upconv_replays_and_splits_agree(shape):
    """Each call is bit-identical on replay (the splits added in split
    order); forced splits stay within tolerance of the plain version."""
    gen = _setup()
    B, H, W, cin, cout = shape
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, H, W, cin).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    b = (rnd(cout) * 0.1).bfloat16()
    taps = conv3x3.fold_upsample_weights(w)
    want = conv3x3.upsample2x_conv3x3_plain(x, w, b).float()
    tol = 2.0**-5 * want.abs().max().item()
    first = conv3x3.upsample2x_conv3x3(x, w, b, taps)
    again = conv3x3.upsample2x_conv3x3(x, w, b, taps)
    forced = [conv3x3._upsample2x_conv3x3(x, b, taps, splits=s)
              for s in (1, 2, 7)]
    replay = conv3x3._upsample2x_conv3x3(x, b, taps, splits=7)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(forced[2], replay)
    for got in [first] + forced:
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_sm90_upconv_refuses_what_tma_cannot_describe():
    """bf16 K4 at Cin 20, at Cout 12 and on an input 2 bytes off 16 raises
    ValueError and launches nothing; fp32 at Cin 20 runs the FMA twin."""
    gen = _setup()
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    counter = conv3x3.upsample_launches
    before = counter.launches
    flat = rnd(1 + 8 * 8 * 16).bfloat16()
    off = flat[1:].view(1, 8, 8, 16)
    for x, cout in ((rnd(1, 8, 8, 20).bfloat16(), 16),
                    (rnd(1, 8, 8, 16).bfloat16(), 12), (off, 16)):
        w = rnd(3, 3, x.shape[-1], cout).bfloat16()
        with pytest.raises(ValueError, match="TMA"):
            conv3x3.upsample2x_conv3x3(x, w, None,
                                       conv3x3.fold_upsample_weights(w))
    assert counter.launches == before
    x, w, b = rnd(1, 8, 8, 20), rnd(3, 3, 20, 16), rnd(16)
    out = conv3x3.upsample2x_conv3x3(x, w, b, conv3x3.fold_upsample_weights(w))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.cuda
def test_sm90_upconv_plan_matches_the_library():
    """ops/gn_conv.py upconv_sm90_plan equals the built library's plan at
    the served and ragged shapes, forced splits included."""
    _setup()
    fn = _cuda.library("gn_conv_sm90").dtp_upsample2x_conv3x3_sm90_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 15)()
    fields = ("tw", "rows", "nb", "win_lines", "stages", "smem", "tiles_h",
              "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks", "splits",
              "per_split", "work_floats")
    for B, H, W, cin, cout in SERVED + TWIN_VAE + RAGGED:
        for splits in (0, 1, 3):
            assert fn(B, H, W, cin, cout, splits, out) == 0
            p = gn_conv.upconv_sm90_plan(B, H, W, cin, cout, splits or None)
            assert list(out) == [p[f] for f in fields]
