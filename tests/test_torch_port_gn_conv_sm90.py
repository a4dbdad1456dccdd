"""The bf16 K1/K5 kernel (csrc/gn_conv_sm90.cu) and K14's plan
(csrc/moments.cu).

On the CPU, the host logic that needs no card: K1/K5's tile and split
plan (every output pixel and channel once, within the H100's shared
memory, filling the card at the served shapes), the check that TMA can
describe the operands (the split concat conv's weight slices included),
the dtype dispatch between the wgmma kernel (bf16) and the FMA twin (fp32,
csrc/conv3x3.cu), the VAE decoder head's zero-padded weight, the served
wrappers' arguments, and K14's plan (a band pass and a reduction pass).

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_gn_conv_sm90.py): the kernels
against their plain versions at the paths' shapes and ragged ones,
statistics included, on images that differ from one another, and the
statistics also against those of the kernel's own output (chip_smoke's
STATS_SELF_TOL); bit-identical replays; the Python plans held equal to the
built libraries' plans; refusals that launch nothing.
"""

from pathlib import Path

import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import gn_conv, groupnorm

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "gn_conv_sm90.cu"
OLD_CU = _cuda.CSRC / "conv3x3.cu"
MOMENTS_CU = _cuda.CSRC / "moments.cu"

# (B, H, W, Cin, Cout): the UNet's resnet convs at 256^2 (batch 3: levels
# 32, 16, 8, 4, the split concat conv's halves among them) and 1024^2
# (level 0), the VAE's at 256^2 (encoder batch 2, decoder batch 1) and
# 1024^2, and its heads (Cout 8 and the padded 3)
UNET = [(3, 32, 32, 320, 320), (3, 32, 32, 640, 320), (3, 16, 16, 320, 640),
        (3, 16, 16, 640, 640), (3, 16, 16, 1280, 640), (3, 8, 8, 640, 1280),
        (3, 8, 8, 1280, 1280), (3, 4, 4, 1280, 1280), (3, 128, 128, 320, 320)]
VAE = [(2, 256, 256, 128, 128), (2, 128, 128, 256, 256), (2, 64, 64, 512, 512),
       (2, 32, 32, 512, 512), (1, 256, 256, 256, 128), (1, 32, 32, 512, 512),
       (2, 32, 32, 512, 8), (1, 256, 256, 128, 8), (2, 1024, 1024, 128, 128)]
# odd sizes, Cin off 64, Cout off 128, 4x4 images at batch 3, one pixel
RAGGED = [(3, 4, 4, 96, 40), (2, 5, 7, 40, 24), (2, 9, 10, 16, 8),
          (1, 1, 1, 48, 136), (2, 17, 33, 64, 256), (5, 3, 3, 8, 16),
          (2, 12, 6, 24, 8)]


def _tiles(p, B, H, W):
    """Each tile's output pixels as (b, y, x), from the kernel's decode."""
    for mt in range(p["m_tiles"]):
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
            if slot < p["nb"] and b < B and y < H and x < W:
                pix.append((b, y, x))
        yield pix


@pytest.mark.parametrize("shape", UNET + VAE + RAGGED, ids=str)
@pytest.mark.parametrize("consumers", [None, 1, 2])
def test_gn_conv_plan_covers_the_output_once(shape, consumers):
    """The tiles cover every output pixel once (a tile holds whole images
    or a rows x tw window of one; each warp's 16 rows lie in one image);
    the N tiles cover Cout; the splits cover the channel chunks once; the
    shared memory is within the H100's 232,448 bytes a block; the grid
    within CUDA's y and z limits."""
    B, H, W, cin, cout = shape
    p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, -(-cout // 8) * 8, cout,
                                  consumers=consumers)
    seen = {}
    for pix in _tiles(p, B, H, W):
        for px in pix:
            seen[px] = seen.get(px, 0) + 1
    assert len(seen) == B * H * W and set(seen.values()) == {1}
    assert (p["rows"] * p["tw"]) % 16 == 0
    assert p["nb"] * p["rows"] * p["tw"] <= 64 * p["consumers"]
    assert (p["n_tiles"] - 1) * p["bn"] < cout <= p["n_tiles"] * p["bn"]
    chunks = [c for s in range(p["splits"])
              for c in range(s * p["per_split"],
                             min((s + 1) * p["per_split"], p["chunks"]))]
    assert chunks == list(range(-(-cin // 64)))
    assert p["stages"] >= 2 and p["smem"] <= gn_conv.SMEM_LIMIT
    assert p["m_tiles"] <= 65535 and p["splits"] <= 65535
    if consumers:
        assert p["consumers"] == consumers


@pytest.mark.parametrize("shape", UNET + VAE, ids=str)
def test_gn_conv_plan_fills_the_card(shape):
    """At every served shape the grid (split K included) keeps at least
    half of the 132 SMs busy; the UNet's 8x8 and 4x4 levels, whose tiles
    alone give 10-30 CTAs, split K."""
    B, H, W, cin, cout = shape
    p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout)
    ctas = p["m_tiles"] * p["n_tiles"] * p["splits"]
    assert ctas >= gn_conv.SM_COUNT // 2
    if H <= 8 and B == 3:
        assert p["splits"] > 1
        assert ctas <= gn_conv.SM_COUNT
    if H == 4:  # the three 4x4 images share one tile
        assert p["nb"] == 3 and p["m_tiles"] == 1


def test_gn_conv_plan_work_buffer():
    """One buffer beside the output: the (B, 2, Cs) statistics, the tile
    partials where an image spans tiles, the split tiles and counters;
    none when neither statistics nor a split is needed."""
    p = gn_conv.gn_conv_sm90_plan(3, 4, 4, 1280, 1280)
    assert p["tpi"] == 1 and p["splits"] > 1
    assert p["work_floats"] == (2 * 3 * 1280 + 10 * p["splits"] * 64 * 128
                                + 10)
    p = gn_conv.gn_conv_sm90_plan(2, 64, 64, 512, 512)
    assert p["splits"] == 1 and p["tpi"] == 32  # 8 x 16 pixel tiles
    assert p["work_floats"] == 2 * 2 * 512 * (1 + 32)
    p = gn_conv.gn_conv_sm90_plan(2, 64, 64, 512, 512, want_stats=False)
    assert p["work_floats"] == 0
    p = gn_conv.gn_conv_sm90_plan(1, 256, 256, 128, 8, 3, want_stats=False)
    assert p["work_floats"] == 0 and p["n_tiles"] == 1


def test_gn_conv_plan_matches_the_source():
    """gn_conv_sm90_plan mirrors the source's constants and rules."""
    text = SM90_CU.read_text()
    for const in (f"kBN = {gn_conv.GN_BN};", f"kAtom = {gn_conv.GN_BK};",
                  f"kWinStages = {gn_conv.GN_WIN_STAGES};",
                  f"kMaxBStages = {gn_conv.GN_MAX_B_STAGES};",
                  f"kSMs = {gn_conv.SM_COUNT};",
                  f"kSmemLimit = {gn_conv.SMEM_LIMIT};",
                  "p.tw = W <= 4 ? 4 : W <= 8 ? 8 : 16;",
                  "if (W <= p.tw && H * p.tw <= pix) {",
                  "const int unit = 16 / p.tw;",
                  "2LL * p.m_tiles * p.n_tiles >= kSMs",
                  "blocks >= kSMs ? 1 : kSMs / blocks",
                  "8 * 2 * (kWinStages + kMaxBStages) + 16 + 1024;"):
        assert const in text, const


@pytest.mark.parametrize("cin,cout,offset,ok", [
    (128, 128, 0, True), (96, 40, 0, True), (16, 8, 0, True),
    (20, 16, 0, False), (16, 12, 0, False), (16, 3, 0, False),
    (16, 16, 1, False)])
def test_gn_conv_tma_describable(cin, cout, offset, ok):
    """Cin and Cout multiples of 8 (rows of whole 16 bytes) and
    16-byte-aligned bases."""
    flat = torch.empty(offset + 8 * 8 * cin, dtype=torch.bfloat16)
    x = flat[offset:].view(1, 8, 8, cin)
    w = torch.empty((3, 3, cin, cout), dtype=torch.bfloat16)
    assert gn_conv.gn_conv_tma_describable(x, w) == ok


@pytest.mark.parametrize("ca,cs,cout,ok", [
    (1280, 1280, 1280, True), (640, 320, 320, True), (40, 56, 48, True),
    (16, 24, 12, False), (12, 20, 8, False)])
def test_weight_slices_are_describable_in_place(ca, cs, cout, ok):
    """The split concat conv's halves w[:, :, :ca] and w[:, :, ca:]: TMA
    reads them in place (the second's base ca * cout elements in, the taps
    (ca + cs) * cout apart) wherever Cin and Cout are multiples of 8."""
    w = torch.empty((3, 3, ca + cs, cout), dtype=torch.bfloat16)
    for half in (w[:, :, :ca], w[:, :, ca:]):
        assert not half.is_contiguous()
        x = torch.empty((1, 4, 4, half.shape[2]), dtype=torch.bfloat16)
        assert gn_conv.gn_conv_tma_describable(x, half) == ok


def test_bf16_gn_conv_goes_to_the_sm90_source_and_fp32_to_the_twin():
    """The new source is built with the others and defines the entry and
    its plan; the old K1/K5 entry refuses bf16 and instantiates only the
    fp32 kernel; the wrapper has no fallback."""
    assert gn_conv.GN_SM90_SOURCE == "gn_conv_sm90" in _cuda.SOURCES
    text = SM90_CU.read_text()
    assert 'extern "C" cudaError_t dtp_gn_conv3x3_sm90(' in text
    assert 'extern "C" int dtp_gn_conv3x3_sm90_plan(' in text
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_gn_conv3x3('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 ||" in entry
    assert "return cudaErrorInvalidValue;" in entry
    assert "launch_fused<float, dtp::kSame>" in entry
    assert "dispatch_fused" not in entry
    src = Path(gn_conv.__file__).read_text()
    assert "try:" not in src and "except" not in src
    body = src[src.index("def _gn_conv3x3("):src.index("def _shape_key(")]
    assert body.index("torch.bfloat16") < body.index("GN_SM90_SOURCE")
    assert body.count("_cuda.function(") == 3


def test_gn_conv_wrapper_runs_plain_on_cpu_only():
    """On the CPU the wrapper takes the plain version in both dtypes,
    operands TMA could not describe and padded heads included."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 5, 20), generator=gen)
    w = torch.randn((3, 3, 20, 3), generator=gen) * 0.1
    b = torch.randn(3, generator=gen)
    a, c = torch.rand((2, 20), generator=gen) + 0.5, torch.randn((2, 20))
    for dt in (torch.float32, torch.bfloat16):
        want, want_st = gn_conv.gn_conv3x3_plain(x.to(dt), a, c, w.to(dt),
                                                 b.to(dt))
        got, st = gn_conv.gn_conv_stream(x.to(dt), a, c, w.to(dt), b.to(dt))
        assert torch.equal(got, want) and torch.equal(st, want_st)
        w8, b8 = gn_conv.pad_cout(w.to(dt), b.to(dt))
        assert w8.shape == (3, 3, 20, 8) and b8.shape == (8,)
        assert not w8[..., 3:].any() and torch.equal(w8[..., :3], w.to(dt))
        got, st = gn_conv.gn_conv_stream(x.to(dt), a, c, w8, b8,
                                         out_channels=3)
        assert torch.equal(got, want) and torch.equal(st, want_st)


def test_served_wrappers_take_no_probe_settings():
    """gn_conv_resident and gn_conv_stream take the function's operands and
    out_channels; the tile and split forcing (consumers, splits) stays on
    the private entry the tests and tools/sm90_plans.py call."""
    import inspect

    served = ["x", "a", "c", "w", "b", "residual", "want_stats", "apply_gn",
              "out_channels"]
    for fn in (gn_conv.gn_conv_resident, gn_conv.gn_conv_stream):
        assert list(inspect.signature(fn).parameters) == served
    forcing = inspect.signature(gn_conv._gn_conv3x3).parameters
    assert "consumers" in forcing and "splits" in forcing


def test_vae_decoder_pads_its_head_once_at_load():
    """The decoder keeps its 3-channel head's weight and bias zero-padded
    to 8 channels as non-persistent buffers, made again after every
    load_state_dict; the state_dict's names are unchanged."""
    from diffusiontexturepainting_torch.core.config import VAEConfig
    from diffusiontexturepainting_torch.models.vae import VAEDecoder

    cfg = VAEConfig(block_out_channels=(32, 32), layers_per_block=1,
                    norm_num_groups=8)
    dec = VAEDecoder(cfg, fused=True)
    head = dec.decoder
    assert head.conv_out_w8.shape[-1] == 8
    assert not any("_w8" in k or "_b8" in k for k in dec.state_dict())
    sd = {k: torch.randn_like(v) for k, v in dec.state_dict().items()}
    dec.load_state_dict(sd)
    assert torch.equal(head.conv_out_w8[..., :3], head.conv_out.weight)
    assert torch.equal(head.conv_out_b8[:3], head.conv_out.bias)
    assert not head.conv_out_w8[..., 3:].any()
    z = torch.randn((1, 4, 4, 4))
    dec.fused = False
    want = dec(z)
    dec.fused = True
    torch.testing.assert_close(dec(z), want, rtol=1e-4, atol=1e-4)


# --- K14's plan (csrc/moments.cu plan) ---


@pytest.mark.parametrize("B,H,W,C,item", [
    (3, 4, 4, 1280, 2), (3, 32, 32, 640, 2), (2, 32, 32, 512, 2),
    (3, 9, 7, 40, 4), (2, 256, 256, 128, 2), (3, 128, 128, 320, 2),
    (2, 1024, 1024, 128, 2), (1, 32, 32, 2560, 4)])
def test_moments_plan(B, H, W, C, item):
    """A band pass of up to 256 channel groups a block, about eight
    blocks an SM, at least 4 rows a row lane, then a reduction pass over
    the band partials: the slices cover the channel groups, the bands the
    rows."""
    p = groupnorm.moments_plan(B, H * W, C, item, True)
    G = -(-C // (16 // item))
    assert (p["slices"] - 1) * p["gpb"] < G <= p["slices"] * p["gpb"]
    assert -(-(H * W) // p["bands"]) * p["bands"] >= H * W
    assert p["gpb"] <= 256
    assert p["partial_floats"] == B * p["bands"] * 2 * C
    assert p["bands"] == 1 or (H * W) // p["bands"] >= 4 * (256 // p["gpb"])
    assert B * p["slices"] * p["bands"] <= 8 * 132 + B * p["slices"]


def test_moments_plan_scalar_rows_and_source():
    """Rows off the 16-byte groups are read one element at a time: the
    plan cuts channels, not groups; the mirror follows the source's
    constants; the wrapper makes one ctypes call and one allocation."""
    p = groupnorm.moments_plan(2, 63, 40, 2, False)
    assert p["gpb"] == 40 and p["slices"] == 1
    assert p["bands"] == 2  # 63 rows, 6 row lanes: at least 4 rows a lane
    p = groupnorm.moments_plan(1, 4096, 2600, 2, False)
    assert p["gpb"] == 256 and p["slices"] == 11
    text = MOMENTS_CU.read_text()
    for const in (f"kMomentThreads = {groupnorm.MOMENT_THREADS};",
                  f"kSMs = {groupnorm.SM_COUNT};"):
        assert const in text, const
    assert "cluster" not in text.split("#include")[-1]
    src = Path(groupnorm.__file__).read_text()
    launch = src[src.index("def launch_moments("):
                 src.index("@functools.cache")]
    # one ctypes call and one allocation
    assert launch.count("_cuda.function(") == 1
    assert launch.count("torch.empty(") == 1


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _key(B, H, W, cin, cout, bias=True, res=True, stats=True, gn=True):
    return ((B, H, W, cin), (3, 3, cin, cout), bias, res, stats, gn)


# the served shapes at 256^2 (UNet batch 3, VAE), the 1024^2 level 0, and
# ragged ones: Cin 96 -> Cout 40, odd H and W, 4x4 images at batch 3, the
# heads (Cout 3 and 8), no bias / residual / statistics / prologue
K1_KEYS = [_key(*s) for s in UNET[:8]] + [
    _key(2, 256, 256, 128, 128), _key(2, 64, 64, 512, 512, res=False),
    _key(1, 256, 256, 128, 3, res=False, stats=False),
    _key(2, 32, 32, 512, 8, res=False, stats=False),
    _key(3, 4, 4, 96, 40), _key(2, 5, 7, 40, 24, bias=False),
    _key(2, 9, 10, 16, 3, res=False, stats=False),
    _key(1, 16, 16, 64, 128, gn=False), _key(2, 17, 33, 64, 256),
    _key(5, 3, 3, 8, 16), _key(1, 1, 1, 48, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("key", K1_KEYS, ids=str)
@pytest.mark.parametrize("kind", ["gn_conv_resident", "gn_conv_stream"])
def test_sm90_gn_conv_matches_plain(kind, key):
    """bf16 K1/K5 against gn_conv3x3_plain on images that differ, output
    and statistics (chip_smoke's tolerance: 2^-5 of the largest output
    magnitude, and of the sums of |y| and y^2), the statistics also within
    STATS_SELF_TOL of those of the kernel's own output."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare(kind, key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r
    if key[4]:  # want_stats
        assert r["stats_self_err"] <= chip_smoke.STATS_SELF_TOL, r


def _operands(gen, B, H, W, cin, cout):
    """Seeded bf16 operands whose images differ (chip_smoke.per_image)."""
    from chip_smoke import per_image

    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = per_image(rnd(B, H, W, cin), 0.5).bfloat16()
    w = (rnd(3, 3, cin, cout) * (9 * cin) ** -0.5).bfloat16()
    b = (rnd(cout) * 0.1).bfloat16()
    a, c = rnd(B, cin) * 0.2 + 1, rnd(B, cin) * 0.2
    r = per_image(rnd(B, H, W, cout), 0.25).bfloat16()
    return x, a, c, w, b, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 1280, 1280),
                                   (3, 16, 16, 640, 640),
                                   (2, 64, 64, 256, 256),
                                   (2, 160, 96, 128, 128)], ids=str)
def test_sm90_gn_conv_replays_and_tiles_agree(shape):
    """Each call's output and statistics are bit-identical on replay (the
    split tiles added in split order, the tile partials in tile order);
    one and two consumer warpgroups give the same output bits without a
    split (their statistics add other tile partials); another split of K
    stays within tolerance; every tiling's statistics are those of its own
    output, image by image."""
    gen = _setup()
    from chip_smoke import STATS_SELF_TOL, stats_self_err

    x, a, c, w, b, r = _operands(gen, *shape)
    forced = gn_conv._gn_conv3x3
    first = gn_conv.gn_conv_resident(x, a, c, w, b, r)
    again = gn_conv.gn_conv_resident(x, a, c, w, b, r)
    one = forced(x, a, c, w, b, r, consumers=1, splits=1)
    two = forced(x, a, c, w, b, r, consumers=2, splits=1)
    three = forced(x, a, c, w, b, r, splits=3)
    torch.cuda.synchronize()
    for got in (first, one, two, three):
        assert stats_self_err(*got) <= STATS_SELF_TOL
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert torch.equal(one[0], two[0])
    peak = first[0].float().abs().max().item()
    scale = first[0].float().square().sum((1, 2)).max().item()
    for got in (one, two, three):
        err = (got[0].float() - first[0].float()).abs().max().item()
        assert err <= 2.0**-5 * peak
        assert (got[1] - first[1]).abs().max().item() <= 2.0**-5 * scale


@pytest.mark.cuda
def test_sm90_gn_conv_reads_weight_halves_in_place():
    """The split concat conv: both halves of one weight, read in place,
    the second with the first's output as its residual, equal the plain
    version on contiguous copies."""
    gen = _setup()
    B, H, W, ca, cs, cout = 3, 8, 8, 640, 320, 320
    x, a, c, w, b, _ = _operands(gen, B, H, W, ca + cs, cout)
    xa, xs = x[..., :ca].contiguous(), x[..., ca:].contiguous()
    h1, _ = gn_conv.gn_conv_resident(xa, a[:, :ca], c[:, :ca], w[:, :, :ca],
                                     b, None, False)
    h, st = gn_conv.gn_conv_resident(xs, a[:, ca:], c[:, ca:], w[:, :, ca:],
                                     None, h1, True)
    p1, _ = gn_conv.gn_conv3x3_plain(xa, a[:, :ca], c[:, :ca],
                                     w[:, :, :ca].contiguous(), b, None,
                                     False)
    p, pst = gn_conv.gn_conv3x3_plain(xs, a[:, ca:], c[:, ca:],
                                      w[:, :, ca:].contiguous(), None, p1)
    peak = p.float().abs().max().item()
    assert (h.float() - p.float()).abs().max().item() <= 2.0**-5 * peak
    scale = p.float().abs().sum((1, 2)).max().item()
    assert (st - pst)[:, 0].abs().max().item() <= 2.0**-5 * scale
    from chip_smoke import STATS_SELF_TOL, stats_self_err

    assert stats_self_err(h, st) <= STATS_SELF_TOL


@pytest.mark.cuda
def test_sm90_gn_conv_refuses_what_tma_cannot_describe():
    """bf16 K1/K5 at Cin 20, at Cout 12 and 3 without padding, and on a
    base 2 bytes off 16 raise ValueError and launch nothing; fp32 at
    Cin 20 runs the FMA twin."""
    gen = _setup()
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    a, c = rnd(1, 20) + 1, rnd(1, 20)
    a16, c16 = a[:, :16].contiguous(), c[:, :16].contiguous()
    x = rnd(1, 8, 8, 20)
    w = rnd(3, 3, 20, 16)
    flat = rnd(1 + 8 * 8 * 16).bfloat16()
    off = flat[1:].view(1, 8, 8, 16)
    w16 = rnd(3, 3, 16, 16).bfloat16()
    counter = gn_conv.gn_conv_stream_launches
    before = counter.launches
    for call in (
            lambda: gn_conv.gn_conv_stream(x.bfloat16(), a, c, w.bfloat16(),
                                           None),
            lambda: gn_conv.gn_conv_stream(off.contiguous(), a16, c16,
                                           rnd(3, 3, 16, 12).bfloat16(),
                                           None),
            lambda: gn_conv.gn_conv_stream(off.contiguous(), a16, c16,
                                           rnd(3, 3, 16, 3).bfloat16(),
                                           None),
            lambda: gn_conv.gn_conv_stream(off, a16, c16, w16, None)):
        with pytest.raises(ValueError, match="TMA"):
            call()
    assert counter.launches == before
    out, stats = gn_conv.gn_conv_stream(x, a, c, w, None)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(stats).all()


@pytest.mark.cuda
def test_sm90_gn_conv_plan_matches_the_library():
    """ops/gn_conv.py gn_conv_sm90_plan equals the built library's plan at
    the paths' shapes and ragged ones, forced tiles and splits included."""
    _setup()
    import ctypes

    fn = _cuda.library("gn_conv_sm90").dtp_gn_conv3x3_sm90_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 16)()
    fields = ("consumers", "tw", "rows", "nb", "win_lines", "stages", "smem",
              "tiles_h", "tiles_w", "tpi", "m_tiles", "n_tiles", "chunks",
              "splits", "per_split", "work_floats")
    for B, H, W, cin, cout in UNET + VAE + RAGGED:
        cw = -(-cout // 8) * 8
        for nc in (0, 1, 2):
            for splits in (0, 2):
                for want in (0, 1):
                    assert fn(B, H, W, cin, cw, cout, want, nc, splits,
                              out) == 0
                    p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cw, cout,
                                                  bool(want), nc or None,
                                                  splits or None)
                    assert list(out) == [int(p[f]) for f in fields]


@pytest.mark.cuda
def test_moments_plan_matches_the_library():
    """ops/groupnorm.py moments_plan equals the built library's plan, and
    dtp_moments_bands its bands, at the paths' shapes and ragged ones."""
    _setup()
    import ctypes

    lib = _cuda.library("moments")
    fn = lib.dtp_moments_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bands = lib.dtp_moments_bands
    bands.argtypes = [ctypes.c_int] * 4
    out = (ctypes.c_longlong * 4)()
    for B, N, C in ((3, 16, 1280), (3, 1024, 640), (2, 65536, 128),
                    (2, 1 << 20, 128), (3, 16384, 320), (2, 63, 40),
                    (1, 1, 8), (3, 4096, 2560)):
        for item in (2, 4):
            for vec in (0, 1):
                assert fn(B, N, C, item, vec, out) == 0
                p = groupnorm.moments_plan(B, N, C, item, bool(vec))
                assert list(out) == [p["bands"], p["gpb"], p["slices"],
                                     p["partial_floats"]]
            vec = C % (16 // item) == 0
            assert bands(B, N, C, item) == groupnorm.moments_plan(
                B, N, C, item, vec)["bands"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 4, 1280), (3, 8, 8, 1280),
                                   (3, 16, 16, 640), (3, 32, 32, 320),
                                   (3, 32, 32, 640), (2, 32, 32, 512),
                                   (2, 1024, 1024, 128), (2, 9, 7, 40)],
                         ids=str)
def test_moments_match_plain_and_replay(shape):
    """K14 at the UNet's shapes, the VAE mid block's and the 1024^2
    encoder stem's, and rows off the 16-byte groups, on images that differ:
    within the statistics tolerance of its plain version (2^-5 of the
    sums of |x| and x^2), each (image, channel) within STATS_SELF_TOL of
    its own sums, bit-identical on replay."""
    gen = _setup()
    from chip_smoke import STATS_SELF_TOL, per_image, stats_self_err

    x = per_image(torch.randn(shape, generator=gen, device="cuda") + 0.5,
                  0.25).bfloat16()
    got = groupnorm.spatial_moments(x)
    again = groupnorm.spatial_moments(x)
    want = groupnorm.spatial_moments_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    xf = x.float()
    for row, scale in enumerate((xf.abs().sum((1, 2)).max().item(),
                                 xf.square().sum((1, 2)).max().item())):
        err = (got[:, row] - want[:, row]).abs().max().item()
        assert err <= 2.0**-5 * scale
    assert stats_self_err(x, got) <= STATS_SELF_TOL
