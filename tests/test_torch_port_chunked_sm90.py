"""bf16 T1 (sublane_attention) and T3 (chunked_attention) on the chunked
mode of the wgmma/TMA attention kernel (csrc/flash_attention_sm90.cu
dtp_sublane_attention_sm90, dtp_chunked_attention_sm90): the running max
updated once per chunk of bk keys (T3; T1 in one chunk of every key, the
exact row max). A chunk of several K/V tiles takes a max pass over its
tiles, then the rescale of l and O by exp2(m - m_new), then a pass against
m_new; a chunk of one tile takes the tile's own max first (K8/K2's online
sequence; with fp32 p, K8/K2's launch itself); 64-key chunks under a
128-key tile take the max per 64-column half of S.

On the CPU, the host logic that needs no card: the dtype dispatch between
the sm90 entries (bf16) and the FMA twins (fp32: csrc/attn_transposed.cu,
csrc/attn_arms.cu) through a patched `_cuda.function`, refusals of chunks
the kernel cannot tile and of what TMA cannot describe, the twins' refusal
of bf16 in their source, T3's plan (chunked_sm90_plan), the port's T3
against the TPU tool in interpret mode at a multi-tile chunk, at bk = Lk
against the tool's T1 and at the tool's default chunk, and a torch
emulation of the kernel's chunk arithmetic against the tools.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_chunked_sm90.py): T1 and T3 at the
TPU tool's chunks against their plain versions, T3 at 64-key chunks under
a 128-key tile, T1's and T3's p and chunk arithmetic by the P precision
probe, replays bit-identical (eagerly and from a CUDA graph), refusals that launch
nothing. test_torch_port_cuda.py holds T3 at the K/V tile bit-equal to
K8/K2, the C plan equal to chunked_sm90_plan and fp32 on the twins.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import attention
from diffusiontexturepainting_torch.ops import attention_variants as arms

torch.set_num_threads(2)

# The JAX reference (the TPU tools) is imported by the CPU tests that use
# it: the card's machine, which runs the `cuda` tests, has no JAX.

SM90_CU = _cuda.CSRC / "flash_attention_sm90.cu"
LOG2E = 1.4426950408889634
# two bf16 ulps at the outputs' magnitude (|o| < 2); fp32: summation order
BF16_ATOL = 2.0**-7
FP32_TOL = dict(atol=3e-5, rtol=1e-4)


def _inputs(shape, seed, scale=1.0):
    b, l, d = shape
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, l, d)) * s).astype(np.float32)
            for s in (scale, scale, 1.0)]


def _jax(fn, arrays, dtype, *args, **kwargs):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(a, getattr(jnp, dtype))
                               for a in arrays), *args, **kwargs),
                          np.float32)


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _tol(dtype):
    return FP32_TOL if dtype == "float32" else dict(atol=BF16_ATOL, rtol=0)


# --- dispatch and refusals (no card) ---


WRAPPERS = {"sublane_attention": (dict(), "attn_transposed"),
            "chunked_attention": (dict(bk=128), "attn_arms")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_dtype_dispatch(monkeypatch, name, dtype):
    """A bf16 CUDA call reaches dtp_<name>_sm90 of the wgmma/TMA source
    with B, H, Lq, Lk, hd and scale*log2(e) (T3: then bk and bf16_p); an
    fp32 call the FMA twin's entry
    with is_bf16 0; each moves the counter by one, and the wrappers have
    no fallback."""
    from tests.test_torch_port_arms_sm90 import _FakeCuda, _fake_cuda

    calls = _fake_cuda(monkeypatch)
    options, twin = WRAPPERS[name]
    counter = arms.LAUNCHES[name]
    q = _FakeCuda((3, 1024, 640), dtype)
    k = _FakeCuda((3, 1024, 640), dtype)
    before = counter.launches
    out = getattr(arms, name)(q, k, k, 8, **options)
    assert tuple(out.shape) == (3, 1024, 640)
    assert counter.launches == before + 1
    (source, symbol, args), = calls
    assert args[4:9] == (3, 8, 1024, 1024, 80)
    assert args[9] == pytest.approx(80**-0.5 * LOG2E)
    if dtype == torch.bfloat16:
        assert (source, symbol) == ("flash_attention_sm90",
                                    f"dtp_{name}_sm90")
        assert args[10:-1] == ((128, 0) if options else ())
    else:
        assert (source, symbol) == (twin, f"dtp_{name}")
        assert args[10:-1] == ((128, 0, 0) if options else (0,))
    assert f'extern "C" cudaError_t dtp_{name}_sm90(' in SM90_CU.read_text()
    src = Path(arms.__file__).read_text()
    assert "try:" not in src and "except" not in src


@pytest.mark.parametrize("bk,lk", [(96, 1152), (32, 1024), (192, 1152),
                                   (256, 1152)])
def test_bf16_refuses_chunks_the_kernel_cannot_tile(monkeypatch, bk, lk):
    """bf16 T3 at hd 40 (128-key tiles): a chunk off 64 (32, 96), or a
    multiple of 64 that is not one of the tile (192) or does not divide Lk
    (256 over 1152 keys: ValueError already from the divisor rule) raises
    ValueError before any launch; the counter does not move."""
    from tests.test_torch_port_arms_sm90 import _FakeCuda, _fake_cuda

    calls = _fake_cuda(monkeypatch)
    before = arms.chunked_launches.launches
    q = _FakeCuda((2, 1024, 320), torch.bfloat16)
    k = _FakeCuda((2, lk, 320), torch.bfloat16)
    with pytest.raises(ValueError):
        arms.chunked_attention(q, k, k, 8, bk=bk)
    assert calls == [] and arms.chunked_launches.launches == before


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("D,ptr", [(4 * 36, 1 << 20), (320, (1 << 20) + 2)])
def test_bf16_refuses_what_tma_cannot_describe(monkeypatch, name, D, ptr):
    """bf16 with hd off a multiple of 8 (36) or a base off 16 bytes raises
    ValueError before any launch; the counter does not move."""
    from tests.test_torch_port_arms_sm90 import _FakeCuda, _fake_cuda

    calls = _fake_cuda(monkeypatch)
    counter = arms.LAUNCHES[name]
    before = counter.launches
    q = _FakeCuda((2, 128, D), torch.bfloat16, ptr)
    with pytest.raises(ValueError, match="TMA"):
        getattr(arms, name)(q, q, q, 4 if D % 36 == 0 else 8,
                            **WRAPPERS[name][0])
    assert calls == [] and counter.launches == before


def test_fp32_twin_keeps_its_chunks(monkeypatch):
    """fp32 T3 takes chunks of 64 or 128 keys (its twin's K/V tile): 1024
    raises ValueError naming fp32, before any launch."""
    from tests.test_torch_port_arms_sm90 import _FakeCuda, _fake_cuda

    calls = _fake_cuda(monkeypatch)
    q = _FakeCuda((2, 2048, 320), torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        arms.chunked_attention(q, q, q, 8)
    assert calls == []


@pytest.mark.parametrize("name,source", [("dtp_sublane_attention",
                                          "attn_transposed.cu"),
                                         ("dtp_chunked_attention",
                                          "attn_arms.cu")])
def test_old_entries_refuse_bf16(name, source):
    """The FMA twins' entries return cudaErrorInvalidValue for bf16 and
    launch the fp32 body only; the mma.sync bf16 body of T1 (movmatrix
    transposes) and the bf16 chunked body of attn_arms.cuh (its Q K^T one
    tile ahead) are gone, as is every bf16 kernel of that header."""
    text = (_cuda.CSRC / source).read_text()
    entry = text[text.index(f'extern "C" cudaError_t {name}('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 || dtp::bad(" in entry
    assert "launch_f32<" in entry or "dispatch_f32<" in entry
    assert "dispatch<" not in entry and "launch_sublane" not in entry
    assert "movmatrix" not in (_cuda.CSRC / "attn_transposed.cu").read_text()
    header = (_cuda.CSRC / "attn_arms.cuh").read_text()
    assert "OVERLAP" not in header
    assert "mma.sync" not in header and "arms_kernel(" not in header


def test_sm90_source_modes():
    """The chunked mode in the source: kOnline with bf16 p, T3's chunk
    modes, the chunk loop (one chunk of every tile for K13, T4 and T1; a
    max pass a chunk, O stashed across it, the first chunk not rescaled),
    the halves' P V, K8/K2's launch at a chunk of one tile with fp32 p, T1
    as one chunk of every tile."""
    text = SM90_CU.read_text()
    for frag in ("kHalves = 6,", "kChunked = 7,", "kBf16P = 8",
                 "return mode == kFixedMax || (mode & kBf16P) != 0;",
                 "int chunk_tiles;",
                 "const int ct = MULTI ? a.chunk_tiles : ntiles;",
                 "for (int i = 0; i < NV / 2; ++i) stash[i * 128 * NC] = o[i];",
                 "for (int i = 0; i < NV / 2; ++i) o[i] = stash[i * 128 * NC];",
                 "const float mo0 = m0, mo1 = m1;",
                 "span(std::integral_constant<int, kMaxPass>{}, c0, c1);",
                 "if (c0 > 0) {",
                 "const float corr0 = ex2(mo0 - m0), corr1 = ex2(mo1 - m1);",
                 "softmax_part<G, G, OWN, BF16P, false, NV, BKV>(s, pa, o, m0, m1,",
                 "pv_issue<NV, BKV, KH, KH>(o, pa, vt);",
                 "qk<KD, BKV, NC, MULTI>(s, qa, sK + st * P::kKBytes);",
                 "if (p.last == dtp::kOnline && !p.narrow)",
                 "return dtp::run(q, k, v, a, B, hd, D, Lq * D, D, Lk * D, "
                 "dtp::kFixedMaxF32,"):
        assert frag in text, frag


# --- the plan ---


@pytest.mark.parametrize("hd,bkv", [(8, 128), (40, 128), (48, 128),
                                    (80, 128), (128, 128), (136, 64),
                                    (160, 64)])
def test_plan_tiles_of_each_bucket(hd, bkv):
    """T3's K/V tile is K2's bucket's (sm90_plan): 128 keys up to hd 128,
    64 above; a chunk of the tile is one tile (fp32 p: K8/K2's launch,
    one pass); a chunk of several tiles takes two passes over K; bk = Lk
    one chunk of every tile, the ragged last one included."""
    p = arms.chunked_sm90_plan(hd, 16384, 24, 16384, bkv)
    assert (p["bkv"], p["chunk_tiles"], p["passes"]) == (bkv, 1, 1)
    assert p["online"] and not p["halves"]
    assert not arms.chunked_sm90_plan(hd, 16384, 24, 16384, bkv,
                                      bf16_p=True)["online"]
    assert p["bucket"] == attention.sm90_bucket(hd, 16384, 24)
    p = arms.chunked_sm90_plan(hd, 4096, 24, 4096, 1024)
    assert (p["chunk_tiles"], p["passes"]) == (1024 // bkv, 2)
    p = arms.chunked_sm90_plan(hd, 1100, 8, 1100, 1100)
    assert (p["chunk_tiles"], p["passes"]) == (-(-1100 // bkv), 2)
    assert p["smem"] <= attention.SMEM_LIMIT


@pytest.mark.parametrize("hd", [40, 80])
def test_plan_chunk64_under_a_128_key_tile(hd):
    """bk 64 under a 128-key tile at hd <= 80: the max per 64-column half
    of the tile, one pass, never K8/K2's launch; at hd 81..128 the bucket
    on 64-key tiles (the halves' registers run out there), with less K/V
    staging than its 128-key tiles."""
    p = arms.chunked_sm90_plan(128, 4096, 24, 4096, 64)
    assert p["bkv"] == 64 and not p["halves"] and not p["online"]
    assert p["smem"] < arms.chunked_sm90_plan(128, 4096, 24, 4096,
                                              128)["smem"]
    half = arms.chunked_sm90_plan(hd, 4096, 24, 4096, 64)
    assert half["halves"] and half["bkv"] == 128 and not half["online"]
    assert (half["chunk_tiles"], half["passes"]) == (1, 1)
    # hd 160's own tile is 64 keys: K2's launch
    assert arms.chunked_sm90_plan(160, 4096, 24, 4096, 64)["online"]


@pytest.mark.parametrize("hd,lk,bk", [(40, 1152, 96), (40, 1152, 192),
                                      (40, 1088, 128), (40, 1024, 32),
                                      (160, 1152, 96), (40, 1100, 64),
                                      (168, 1024, 1024)])
def test_plan_refuses(hd, lk, bk):
    """Chunks the kernel cannot tile (off 64, a multiple of 64 but not of
    a 128-key tile, a tile that does not divide Lk, 64 over a Lk off 64)
    and hd above 160 raise ValueError."""
    with pytest.raises(ValueError):
        arms.chunked_sm90_plan(hd, 1024, 8, lk, bk)


# --- against the TPU tools (interpret mode) ---


# (B, L, D, heads): hd 40 and 80 over 512 keys
MULTI = {"hd40": (1, 512, 80, 2), "hd80": (1, 512, 160, 2)}


@pytest.mark.parametrize("shape", list(MULTI))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_multi_tile_chunk_matches_tool(monkeypatch, shape, dtype, bf16_p):
    """T3 at bk 256 over Lk 512 (two chunks of two 128-key tiles on the
    card) against the tool's chunked_attention at the same bk, with its
    exp2 of bf16 native (TPUExp2): the port (plain on the CPU) and, in
    bf16, the emulation of the kernel's chunk arithmetic. fp32: atol 3e-5,
    rtol 1e-4; bf16: atol 2^-7."""
    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    if bf16_p:
        monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    B, L, D, heads = MULTI[shape]
    arrays = _inputs((B, L, D), 41)
    want = _jax(bench_attn_variants.chunked_attention, arrays, dtype, heads,
                bk=256, bf16_p=bf16_p)
    tq, tk, tv = _torch(arrays, dtype)
    got = arms.chunked_attention(tq, tk, tv, heads, bk=256, bf16_p=bf16_p)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    if dtype == "bfloat16":
        p = arms.chunked_sm90_plan(D // heads, L, B * heads, L, 256, bf16_p)
        assert (p["chunk_tiles"], p["passes"]) == (2, 2)
        emu = emulate_chunked(tq, tk, tv, heads, 256, bf16_p, p)
        np.testing.assert_allclose(emu.float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_chunk_is_the_tools_t1(dtype):
    """T3 at bk = Lk against the tool's sublane_attention (T1): one
    function (the exact row max, fp32 p, bf16(p) into P V), 256 queries at
    hd 40 over 384 keys and over 300 (a ragged last tile on the card); the
    port's T1 beside. (The tool raises off its 256-query block.)"""
    from tools import bench_attn_sublane

    for L in (384, 300):
        arrays = _inputs((1, 256, 80), 43)[:1] + _inputs((1, L, 80), 42)[1:]
        want = _jax(bench_attn_sublane.sublane_attention, arrays, dtype,
                    num_heads=2)
        tq, tk, tv = _torch(arrays, dtype)
        for got in (arms.chunked_attention(tq, tk, tv, 2, bk=L),
                    arms.sublane_attention(tq, tk, tv, 2)):
            np.testing.assert_allclose(got.float().numpy(), want,
                                       **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_chunk_is_the_tools(monkeypatch, dtype):
    """chunked_attention with no bk against the tool's with no bk (1024
    both), at Lk 1024 with bf16 p (where the chunk moves the rounding),
    and without."""
    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    assert arms.DEFAULT_CHUNK == 1024
    arrays = _inputs((1, 1024, 80), 44)
    tq, tk, tv = _torch(arrays, dtype)
    for bf16_p in (False, True):
        want = _jax(bench_attn_variants.chunked_attention, arrays, dtype, 2,
                    bf16_p=bf16_p)
        got = arms.chunked_attention(tq, tk, tv, 2, bf16_p=bf16_p)
        np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


# --- a torch emulation of the kernel's chunk arithmetic ---


def emulate_chunked(q, k, v, heads, bk, bf16_p, plan):
    """T3's kernel on the CPU, per (image, head): q scaled by scale*log2(e)
    and rounded; S in fp32 per K/V tile of plan["bkv"] keys; per chunk of
    plan["chunk_tiles"] tiles: several, the chunk's max (a max pass), then
    (but for the first chunk) l and O times exp2(m - m_new), then per tile
    p against m_new, l += its fp32 sum, O += bf16(p) v; one tile (or, with
    plan["halves"], each 64-column half of one), its own max first, l = l
    alpha + sum p, O = O alpha + bf16(p) v. O * (1 / l) rounded once. p:
    exp2(s - m) in fp32, or bf16(exp2(bf16(s - m))) with bf16_p."""
    B, L, D = q.shape
    hd = D // heads
    qs, kh, vh = arms._heads(q, k, v, heads)
    qs, kh, vh = qs.float(), kh.float(), vh.float()
    Lk = kh.shape[2]
    bkv, ct = plan["bkv"], plan["chunk_tiles"]

    def p_of(s, m):
        if bf16_p:
            return torch.exp2((s - m).to(torch.bfloat16).float()).to(
                torch.bfloat16).float()
        return torch.exp2(s - m)

    o = torch.zeros(qs.shape)
    m = torch.full(qs.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    tiles = list(range(0, Lk, bkv))
    for c in range(0, len(tiles), ct):
        chunk = tiles[c:c + ct]
        scores = [qs @ kh[:, :, j:j + bkv].transpose(-1, -2) for j in chunk]
        if ct > 1:
            m_new = torch.maximum(m, torch.cat(scores, -1).amax(
                -1, keepdim=True))
            if c > 0:
                corr = torch.exp2(m - m_new)
                l, o = l * corr, o * corr
            m = m_new
            for j, s in zip(chunk, scores):
                p = p_of(s, m)
                l = l + p.sum(-1, keepdim=True)
                o = o + p.to(torch.bfloat16).float() @ vh[:, :, j:j + bkv]
            continue
        (j,), (s,) = chunk, scores
        step = 64 if plan["halves"] else bkv
        for h0 in range(0, s.shape[-1], step):
            sh = s[..., h0:h0 + step]
            mx = torch.maximum(m, sh.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mx)
            m = mx
            p = p_of(sh, m)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + (p.to(torch.bfloat16).float()
                             @ vh[:, :, j + h0:j + h0 + sh.shape[-1]])
    out = (o * (1.0 / l)).to(q.dtype)
    return out.transpose(1, 2).reshape(B, L, D)


# (B, L, D, heads, Lk, bk): hd 40 at 64-key chunks (halves of 128-key
# tiles), at 384 (three tiles) over a ragged query tile, hd 160 at 128 (two
# 64-key tiles), hd 80 at bk = Lk over a ragged key tile, hd 128 at 64-key
# chunks (its bucket on 64-key tiles)
EMULATED = [(1, 256, 80, 2, 256, 64), (2, 200, 160, 4, 768, 384),
            (1, 256, 320, 2, 256, 128), (1, 200, 160, 2, 200, 200),
            (1, 256, 256, 2, 256, 64)]


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("bf16_p", [False, True])
def test_emulated_chunks_match_tool(monkeypatch, case, bf16_p):
    """The emulation under the plan's chunks (at 64-key chunks the halves
    of 128-key tiles at hd <= 80, 64-key tiles at hd 128) against the
    tool's chunked_attention (bq = L, TPUExp2) and plain_chunked_attention, bf16:
    atol 2^-7."""
    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    B, L, D, heads, lk, bk = case
    arrays = _inputs((B, L, D), 45)[:1] + _inputs((B, lk, D), 46)[1:]
    tq, tk, tv = _torch(arrays, "bfloat16")
    want = _jax(bench_attn_variants.chunked_attention, arrays, "bfloat16",
                heads, bk=bk, bf16_p=bf16_p, q_block=L)
    plain = arms.plain_chunked_attention(tq, tk, tv, heads, bk=bk,
                                         bf16_p=bf16_p).float().numpy()
    p = arms.chunked_sm90_plan(D // heads, L, B * heads, lk, bk, bf16_p)
    got = emulate_chunked(tq, tk, tv, heads, bk, bf16_p, p).float().numpy()
    np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_emulated_tile_chunk_is_k8s_order():
    """At a chunk of the K/V tile with fp32 p the emulation is K8's online
    order: it agrees with plain_attention_streaming (the exact row max)
    within bf16 rounding, as T3 at the tile must (it is K8/K2's launch on
    the card)."""
    tq, tk, tv = _torch(_inputs((1, 384, 80), 47), "bfloat16")
    p = arms.chunked_sm90_plan(40, 384, 2, 384, 128)
    assert p["online"]
    got = emulate_chunked(tq, tk, tv, 2, 128, False, p).float()
    want = attention.plain_attention_streaming(tq, tk, tv, 2).float()
    assert (got - want).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("hd", [40, 80, 128])
def test_chunk_probe_parts_t3_and_t1(hd):
    """chip_smoke's chunk probe on the emulation (2 heads, 256 queries over
    2048 keys, ordinary logits): T3 at chunk 1024 with each p, T3 at 64
    and T1 are each P_PRECISION_MARGIN times nearer their own float64
    evaluation than each neighbour's, and an emulation of each neighbour's
    function (the chunk taken as one tile or as every key, the other p)
    fails that case's check, so a kernel that ignored its chunk or its p
    would."""
    import chip_smoke

    heads, L, lk = 2, 256, 2048
    arrays = (_inputs((1, L, heads * hd), 48)[:1]
              + _inputs((1, lk, heads * hd), 49)[1:])
    tq, tk, tv = _torch(arrays, "bfloat16")
    evals, cases = chip_smoke.chunk_probe_cases(lk, 128)

    def emulate(width, bf16_p):
        bk = width or lk
        plan = arms.chunked_sm90_plan(hd, L, heads, lk, bk, bf16_p)
        return emulate_chunked(tq, tk, tv, heads, bk, bf16_p, plan)

    outs = [emulate(*e) for e in evals]
    dist = chip_smoke.chunk_precision(outs, tq, tk, tv, heads, evals)
    margin = chip_smoke.P_PRECISION_MARGIN
    for bk, bf16_p, own, others in cases:
        assert evals[own] == (bk, bf16_p)
        assert all(margin * dist[own][own] <= dist[own][i] for i in others)
        for i in others:
            assert not all(margin * dist[i][own] <= dist[i][j]
                           for j in others), (evals[own], evals[i])


def test_entry_point_rows_on_cpu(capsys):
    """tools/sm90_plans.py --rows arms on the CPU: T1, T3 at its chunks
    where they divide L, and K8/K2 beside T7 and T9, the plain versions,
    nothing timed."""
    import json

    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny",
                            "--rows", "arms"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = {(r["tag"], r["kernel"]): r for r in record["rows"]}
    for tag in ("tiny hd 40", "tiny hd 160", "tiny 128 keys"):
        assert (tag, "T1") in rows and (tag, "K8/K2") in rows
    assert rows[("tiny 128 keys", "T3 chunk64")]["chunk_tiles"] == 1
    assert ("tiny 128 keys", "T3 chunk128") in rows
    assert not any("narrow" in k or "halves" in k for _, k in rows)
    assert all(r["ms"] is None and r["max_diff"] == 0.0
               for r in record["rows"])


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(4096, 320), (1024, 640), (2048, 1280)])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_sm90_tool_chunks_match_plain(L, D, bf16_p):
    """bf16 T3 at the TPU tool's chunks 512, 1024 and 2048 (where they
    divide L and are not L, the tool's rule) and at bk = L, and bf16 T1,
    against their plain versions at hd 40, 80 and 160 (chunk_smoke's
    tolerance: 2^-5 of the largest output magnitude)."""
    gen = _setup()
    q, k, v = (torch.randn((1, L, D), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    calls = [(arms.sublane_attention(q, k, v, 8),
              arms.plain_sublane_attention(q, k, v, 8))]
    for bk in [c for c in (512, 1024, 2048) if not (L % c or L == c)] + [L]:
        calls.append((arms.chunked_attention(q, k, v, 8, bk=bk,
                                             bf16_p=bf16_p),
                      arms.plain_chunked_attention(q, k, v, 8, bk=bk,
                                                   bf16_p=bf16_p)))
    torch.cuda.synchronize()
    for got, want in calls:
        tol = 2.0**-5 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 128])
@pytest.mark.parametrize("bf16_p", [False, True])
def test_sm90_chunk64_matches_plain(hd, bf16_p):
    """At 64-key chunks under a 128-key tile (the halves at hd 40 and 80,
    the bucket on 64-key tiles at hd 128) against the plain version, at L
    1152 and at a ragged tile (1088 keys, 1100 queries)."""
    gen = _setup()
    for lq, lk in ((1152, 1152), (1100, 1088)):
        q = torch.randn((2, lq, 4 * hd), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((2, lk, 4 * hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        want = arms.plain_chunked_attention(q, k, v, 4, bk=64,
                                            bf16_p=bf16_p).float()
        tol = 2.0**-5 * want.abs().max().item()
        got = arms.chunked_attention(q, k, v, 4, bk=64, bf16_p=bf16_p)
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 128])
def test_sm90_chunk_probe_parts_t3_and_t1(hd):
    """On the card, chip_smoke's chunk probe: bf16 T3 at chunk 1024 with
    each p, T3 at 64 (the halves at hd 40 and 80, 64-key tiles at 128) and
    T1 each P_PRECISION_MARGIN times nearer their own float64 evaluation
    than each neighbour's (2 images of 4 heads, L 2048; within every
    tolerance check these are one function, so a kernel that ignored its
    chunk or its p passes those and fails this)."""
    gen = _setup()
    import chip_smoke

    q, k, v = (torch.randn((2, 2048, 4 * hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    bkv = attention.sm90_plan(hd, 2048, 8)["bkv"]
    evals, cases = chip_smoke.chunk_probe_cases(2048, bkv)
    gots = [arms.sublane_attention(q, k, v, 4) if bk is None
            else arms.chunked_attention(q, k, v, 4, bk=bk, bf16_p=bf16_p)
            for bk, bf16_p, _, _ in cases]
    dists = chip_smoke.chunk_precision(gots, q, k, v, 4, evals)
    for (bk, bf16_p, own, others), dist in zip(cases, dists):
        assert all(chip_smoke.P_PRECISION_MARGIN * dist[own] <= dist[i]
                   for i in others), (bk, bf16_p, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("name,options", [("sublane_attention", {}),
                                          ("chunked_attention",
                                           dict(bk=64)),
                                          ("chunked_attention",
                                           dict(bk=512, bf16_p=True))])
def test_sm90_replays_bit_identical(name, options):
    """Two eager calls and one replayed from a CUDA graph give the same
    bits at the attn_arms path's L2 shape and a ragged hd-40 one (T3 at
    512 over 1024 keys there)."""
    gen = _setup()
    wrapper = getattr(arms, name)
    for shape, heads in (((3, 1024, 1280), 8), ((2, 1024, 320), 8)):
        q, k, v = (torch.randn(shape, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        first = wrapper(q, k, v, heads, **options)
        again = wrapper(q, k, v, heads, **options)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = wrapper(q, k, v, heads, **options)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, captured)


@pytest.mark.cuda
def test_sm90_refusals_launch_nothing():
    """bf16 T3 at a chunk the kernel cannot tile (192 at hd 40), bf16 T1
    and T3 at hd 36 or on a q 2 bytes off 16 raise ValueError and launch
    nothing; the sm90 entry itself returns cudaErrorInvalidValue for that
    chunk."""
    gen = _setup()
    before = (arms.sublane_launches.launches, arms.chunked_launches.launches)
    x = torch.randn((2, 1152, 320), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        arms.chunked_attention(x, x, x, 8, bk=192)
    y = torch.randn((2, 64, 4 * 36), generator=gen, device="cuda").bfloat16()
    flat = torch.randn(1 + 2 * 64 * 320, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(2, 64, 320)
    for t, heads in ((y, 4), (off, 8)):
        with pytest.raises(ValueError, match="TMA"):
            arms.sublane_attention(t, t, t, heads)
        with pytest.raises(ValueError, match="TMA"):
            arms.chunked_attention(t, t, t, heads, bk=64)
    assert (arms.sublane_launches.launches,
            arms.chunked_launches.launches) == before
    out = torch.empty_like(x)
    fn = _cuda.function("flash_attention_sm90", "dtp_chunked_attention_sm90",
                        arms._CHUNKED_SM90_ARGTYPES)
    assert fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 2, 8,
              1152, 1152, 40, 0.2, 192, 0, _cuda.stream_of(x)) == 1
