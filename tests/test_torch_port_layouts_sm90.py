"""bf16 T6 (nomax_4d) and T8 (nomax_laneslice) on the one-pass static-shift
softmax of the wgmma/TMA attention kernel (csrc/flash_attention_sm90.cu
dtp_nomax_4d_sm90, dtp_nomax_laneslice_sm90): T2's safe launch (s clamped
at shift + 88, p = exp2(s - shift) in fp32, l their fp32 sum + 1e-30,
bf16(p) into P V, K2's bucket for hd) on the heads read in place from the
packed (B, L, h*hd) rows. T6 runs it on the head-major grid (query tile,
head, image), T8 on the head-fastest grid (head, query tile, image): the
same CTAs in another order, so both give T2-safe's bits.

On the CPU: T2-safe's tile emulation (test_torch_port_nomax_sm90.py: the
bucket's key tiles, O times 1 / l rounded once) against the TPU tools
nomax_4d and nomax_laneslice in interpret mode, with the tools' exp2 of
bf16 native and not, at query lengths that are multiples of the tools' q
blocks (the tools drop tail queries); a Python mirror of the kernel's
block map on each grid, every (image, head, query tile) visited once and
T8's heads fastest, at the attn_arms path's shapes and at ragged lengths;
the grid and the entries in the source.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_layouts_sm90.py): T6 and T8
against their plain versions at hd 40, 80 and 160, L 1100, 3 images of 8
heads (and T2-safe's bits, chip_smoke's family check); T6, T8, T5 and
T2-safe bit-equal; two eager calls and one CUDA-graph replay bit-identical
at the attn_arms path's L0 and L1 shapes.
"""

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import attention
from diffusiontexturepainting_torch.ops import attention_variants as arms

torch.set_num_threads(2)

# The JAX reference (the TPU tools) and the emulations beside it are
# imported by the CPU tests that use them: the card's machine, which runs
# the `cuda` tests, has no JAX.

SM90_CU = _cuda.CSRC / "flash_attention_sm90.cu"
# (B, L, D, heads), the tools' q_block (a divisor of L): hd 40 over a full
# and a ragged key tile, hd 80 over two key tiles, hd 160 over the 64-key
# tiles of its bucket (one ragged)
CASES = [((2, 192, 160, 4), 64), ((1, 256, 160, 2), 128),
         ((1, 96, 320, 2), 32)]
TOOLS = ("nomax_4d", "nomax_laneslice")
# (B, L, D, heads): the 1024^2/4 stamp's UNet self-attentions (the
# attn_arms path), then ragged lengths
GRID_SHAPES = [(3, 16384, 320, 8), (3, 4096, 640, 8), (3, 1024, 1280, 8),
               (2, 1100, 320, 8), (2, 1100, 1280, 4), (1, 65, 640, 8)]


@pytest.mark.parametrize("case,q_block", CASES, ids=str)
@pytest.mark.parametrize("native_exp2", [False, True])
@pytest.mark.parametrize("tool", TOOLS)
def test_emulated_t2_safe_matches_layout_tools(monkeypatch, case, q_block,
                                               native_exp2, tool):
    """T2-safe's emulation (what T6 and T8 launch) against the tool's
    nomax_4d or nomax_laneslice at q_block < L in interpret mode, with and
    without the native exp2 of bf16 (the tools take exp2 of fp32 logits,
    so both agree), and against the port's plain version, bf16: atol
    2^-7."""
    from tests.test_torch_port_nomax_sm90 import (
        BF16_ATOL,
        _bkv,
        _interpret,
        _tool,
        emulate_nomax,
    )

    bench = _tool(monkeypatch, native_exp2)
    B, L, D, heads = case
    rng = np.random.default_rng(51)
    tq, tk, tv = (torch.from_numpy(rng.standard_normal((B, L, D)).astype(
        np.float32)).bfloat16() for _ in range(3))
    got = emulate_nomax(tq, tk, tv, heads, _bkv(tq, heads)).float().numpy()
    want = _interpret(getattr(bench, tool), (tq, tk, tv), heads,
                      q_block=q_block)
    plain = getattr(arms, f"plain_{tool}")(tq, tk, tv, heads).float()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got, plain.numpy(), atol=BF16_ATOL, rtol=0)


def block_map(B, H, Lq, hd, head_fastest):
    """The (image, head, first query row) of each CTA of T6's or T8's grid
    in launch order (blockIdx.x fastest, then y, then z), as
    csrc/flash_attention_sm90.cu's launch and attn_sm90 compute them, and
    the query rows a CTA: 64 times the consumer warpgroups of K2's bucket
    (sm90_plan(hd, Lq, B*H)). T6: (query tile, head, image); T8: (head,
    query tile, image)."""
    rows = 64 * attention.sm90_plan(hd, Lq, B * H)["consumers"]
    tiles = -(-Lq // rows)
    grid = (H, tiles, B) if head_fastest else (tiles, H, B)
    ctas = []
    for z in range(grid[2]):
        for y in range(grid[1]):
            for x in range(grid[0]):
                tile, head = (y, x) if head_fastest else (x, y)
                ctas.append((z, head, tile * rows))
    return ctas, rows


@pytest.mark.parametrize("shape", GRID_SHAPES, ids=str)
def test_block_maps_cover_every_tile_once(shape):
    """On both grids every (image, head, query tile) is one CTA's, and the
    two grids hold the same CTAs; T6's consecutive CTAs walk one head's
    query tiles, T8's the H heads of one query tile (so they launch
    together), the grid's y axis (T8's query tiles) within CUDA's 65535."""
    B, L, D, H = shape
    hd = D // H
    t6, rows = block_map(B, H, L, hd, False)
    t8, rows8 = block_map(B, H, L, hd, True)
    assert rows == rows8
    want = {(b, h, q0) for b in range(B) for h in range(H)
            for q0 in range(0, L, rows)}
    assert len(t8) == len(set(t8)) == len(want) and set(t8) == want
    assert len(t6) == len(set(t6)) and set(t6) == want
    tiles = -(-L // rows)
    assert tiles <= 65535
    for i in range(0, len(t8), H):
        group = t8[i:i + H]
        assert [c[1] for c in group] == list(range(H))
        assert len({(c[0], c[2]) for c in group}) == 1
    for i in range(0, len(t6), tiles):
        group = t6[i:i + tiles]
        assert [c[2] for c in group] == [j * rows for j in range(tiles)]
        assert len({(c[0], c[1]) for c in group}) == 1


def test_sm90_source_grids_and_entries():
    """The source holds what block_map mirrors (the grid's axes, the tile
    and head a CTA reads from them), the head-fastest bit or-ed into the
    head-major kShift (its own instantiation, fp32 p, the five buckets of
    hd <= 160), and T6's and T8's entries on T2's safe launch."""
    text = SM90_CU.read_text()
    for frag in ("kGridHeadFastest = 16",
                 "return mode & ~(kBf16P | kGridHeadFastest);",
                 "constexpr bool HF = (LAST & kGridHeadFastest) != 0;",
                 "const int q0 = (HF ? blockIdx.y : blockIdx.x) * "
                 "P::kQRows;",
                 "return AH ? hi : static_cast<int>(HF ? blockIdx.x : "
                 "blockIdx.y);",
                 "const int b = blockIdx.z / a.nslices",
                 "const dim3 grid = HF ? dim3(a.H, tiles, B * a.nslices)",
                 ": dim3(tiles, AH ? 1 : a.H, B * a.nslices);",
                 "if (HF && tiles > 65535) return cudaErrorInvalidValue;",
                 "launch_two_pass<kShift | kGridHeadFastest>(bucket"):
        assert frag in text, frag
    for name, mode in (("dtp_nomax_4d_sm90", "dtp::kShift, -1, true,"),
                       ("dtp_nomax_laneslice_sm90",
                        "dtp::kShift | dtp::kGridHeadFastest, -1, true,")):
        entry = text[text.index(f'extern "C" cudaError_t {name}('):]
        entry = entry[:entry.index("\n}\n")]
        assert mode in entry, name


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(shape, gen):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("name", TOOLS)
def test_sm90_matches_plain(name, hd):
    """T6 and T8 against their plain versions at L 1100 (a ragged last
    tile), 3 images of 8 heads, and with fewer keys than queries
    (chip_smoke's tolerance: 2^-5 of the largest output magnitude);
    chip_smoke's compare also holds each equal to T2-safe bit for bit."""
    gen = _setup()
    import chip_smoke

    for lk in (1100, 900):
        key = ((3, 1100, 8 * hd), (3, lk, 8 * hd), 8)
        r = chip_smoke.compare(name, key, torch.bfloat16, gen)
        assert r["err_over_tol"] <= 1.0, (key, r)
        assert r["family_max_abs_diff"] == 0.0, (key, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [((2, 1100, 160), 4),
                                         ((2, 1100, 640), 8),
                                         ((3, 1024, 1280), 8),
                                         ((1, 4096, 640), 8)], ids=str)
def test_sm90_t6_t8_t5_t2_bit_equal(shape, heads):
    """T6, T8 and T5 give T2-safe's bits: one launch (T5 on its copies of
    the heads, T8 on the head-fastest grid)."""
    gen = _setup()
    q, k, v = _rnd(shape, gen)
    t2 = arms.nomax_attention(q, k, v, heads, safe=True)
    for wrapper in (arms.nomax_4d, arms.nomax_laneslice,
                    arms.nomax_unpadded):
        assert torch.equal(wrapper(q, k, v, heads), t2), wrapper.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("name", TOOLS)
def test_sm90_replays_at_the_path_shapes(name):
    """Two eager calls and one replayed from a CUDA graph give the same
    bits at the attn_arms path's L0 and L1 shapes."""
    gen = _setup()
    wrapper = getattr(arms, name)
    for shape in ((3, 16384, 320), (3, 4096, 640)):
        q, k, v = _rnd(shape, gen)
        first, again = wrapper(q, k, v, 8), wrapper(q, k, v, 8)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = wrapper(q, k, v, 8)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, captured)
