"""The host logic of the bf16 K9 kernel (csrc/conv_sm90.cu), which needs no
card: the tile plan (consumer warpgroups, stages, shared memory, grid) at
every shape the paths launch and at ragged ones, its mirror of the
source's constants and rule, the check that TMA can describe the operands,
and the dtype dispatch between the wgmma kernel (bf16) and the FMA twin
(fp32, csrc/conv3x3.cu).

The kernel itself is held against its plain version on the card
(test_torch_port_cuda.py, chip_smoke.py); the plain version against the
JAX kernel here (test_torch_port_session_kernels.py).
"""

from pathlib import Path

import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import gn_conv

torch.set_num_threads(2)

SM90_CU = _cuda.CSRC / "conv_sm90.cu"
OLD_CU = _cuda.CSRC / "conv3x3.cu"

# (B, H, W, Cin, Cout): the default path's three calls at 256^2 and at the
# 1024^2 envelope, then odd sizes, ragged channels, one output pixel
PATH_SHAPES = [(2, 2 * h, 2 * h, c, c) for h, c in
               ((128, 128), (64, 256), (32, 512),
                (512, 128), (256, 256), (128, 512))]
RAGGED = [(1, 18, 34, 48, 40), (2, 7, 9, 24, 136), (2, 2, 2, 16, 8),
          (1, 33, 31, 200, 264)]


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED, ids=str)
@pytest.mark.parametrize("consumers", [None, 1, 2])
def test_downconv_plan_covers_the_output(shape, consumers):
    """The tiles cover the H/2 x W/2 output and Cout with no tile wholly
    outside; a tile is 64 pixels a consumer warpgroup (4 rows of 16); the
    K steps cover 9 taps x Cin; shared memory within the H100's 232,448
    bytes a block; the grid within CUDA's y limit."""
    B, H, W, cin, cout = shape
    p = gn_conv.downconv_sm90_plan(B, H, W, cin, cout, consumers)
    oh, ow = H // 2, W // 2
    assert p["rows"] * p["cols"] == 64 * p["consumers"]
    assert (p["tiles_h"] - 1) * p["rows"] < oh <= p["tiles_h"] * p["rows"]
    assert (p["tiles_w"] - 1) * p["cols"] < ow <= p["tiles_w"] * p["cols"]
    assert p["m_tiles"] == B * p["tiles_h"] * p["tiles_w"] <= 65535
    assert (p["n_tiles"] - 1) * p["bn"] < cout <= p["n_tiles"] * p["bn"]
    assert p["k_steps"] * p["bk"] >= 9 * cin > (p["k_steps"] - 9) * p["bk"]
    assert p["stages"] >= 2 and p["smem"] <= gn_conv.SMEM_LIMIT
    if consumers:
        assert p["consumers"] == consumers


@pytest.mark.parametrize("shape,consumers", [
    ((2, 256, 256, 128, 128), 2),  # 256 CTAs
    ((2, 128, 128, 256, 256), 2),  # 128 CTAs
    ((2, 64, 64, 512, 512), 1),    # 64 CTAs at two: 128 at one
    ((2, 1024, 1024, 128, 128), 2)])
def test_downconv_plan_fills_the_card(shape, consumers):
    """Two consumer warpgroups unless that grid would leave more than half
    of the 132 SMs idle."""
    p = gn_conv.downconv_sm90_plan(*shape)
    assert p["consumers"] == consumers
    assert p["m_tiles"] * p["n_tiles"] >= gn_conv.SM_COUNT // 2


def test_downconv_plan_matches_the_source():
    """downconv_sm90_plan mirrors the source's tile constants and its
    consumer rule."""
    text = SM90_CU.read_text()
    p = gn_conv.downconv_sm90_plan(2, 64, 64, 64, 128, 2)
    for const in (f"kTileW = {p['cols']};", f"kBN = {p['bn']};",
                  f"kAtom = {p['bk']};", f"kStages = {p['stages']};",
                  f"kSMs = {gn_conv.SM_COUNT};", "kRows = 4 * NC;",
                  "kPix = 64 * NC;",
                  "2LL * two.m_tiles * two.n_tiles >= kSMs"):
        assert const in text, const


@pytest.mark.parametrize("cin,cout,offset,ok", [
    (128, 128, 0, True), (48, 40, 0, True), (16, 8, 0, True),
    (20, 16, 0, False), (16, 12, 0, False), (16, 16, 1, False)])
def test_downconv_tma_describable(cin, cout, offset, ok):
    """Cin and Cout multiples of 8 (rows of whole 16 bytes) and
    16-byte-aligned bases."""
    flat = torch.empty(offset + 8 * 8 * cin, dtype=torch.bfloat16)
    x = flat[offset:].view(1, 8, 8, cin)
    w = torch.empty((3, 3, cin, cout), dtype=torch.bfloat16)
    assert gn_conv.downconv_tma_describable(x, w) == ok


def test_bf16_downconv_goes_to_the_sm90_source_and_fp32_to_the_twin():
    """The new source is built with the others and defines the entry and
    its plan; the old K9 entry refuses bf16 and instantiates only the
    fp32 kernel; the wrapper has no fallback."""
    assert gn_conv.DOWN_SM90_SOURCE == "conv_sm90" in _cuda.SOURCES
    text = SM90_CU.read_text()
    assert 'extern "C" cudaError_t dtp_downsample_conv3x3_stats_sm90(' in text
    assert 'extern "C" int dtp_downsample_conv3x3_sm90_plan(' in text
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t '
                          'dtp_downsample_conv3x3_stats('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 ||" in entry and "return cudaErrorInvalidValue;" in entry
    assert "launch_fused<float, dtp::kDown>" in entry
    assert "dispatch_fused" not in entry
    src = Path(gn_conv.__file__).read_text()
    assert "try:" not in src and "except" not in src


def test_downconv_wrapper_runs_plain_on_cpu_only():
    """On the CPU the wrapper takes the plain version in both dtypes,
    operands TMA could not describe included."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 6, 5, 20), generator=gen)
    w = torch.randn((3, 3, 20, 12), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        out, stats = gn_conv.downconv_stream(x.to(dt), w.to(dt), None)
        want, want_st = gn_conv.downconv_stream_plain(x.to(dt), w.to(dt),
                                                      None)
        assert torch.equal(out, want) and torch.equal(stats, want_st)
