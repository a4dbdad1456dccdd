"""bf16 T7 (nomax_allheads) and T9 (pvt_attention) on the one-pass shifted
softmax of the wgmma/TMA attention kernel (csrc/flash_attention_sm90.cu
dtp_nomax_allheads_sm90, dtp_pvt_attention_sm90): s clamped at shift + 88,
p = exp2(s - shift) in fp32, the row sum of the unrounded p + 1e-30; T7
puts bf16(p) into P V with every head of a query tile in one CTA, T9 puts
p in as bf16 hi + lo (two products) on the head-major grid. The dispatch,
refusal, replay and plain-version tests cover T2 (nomax_attention), T5
(nomax_unpadded), T6 (nomax_4d) and T8 (nomax_laneslice) on the same
kernel's head-major one pass too; their emulations and probes are in
test_torch_port_nomax_sm90.py and test_torch_port_layouts_sm90.py.

On the CPU, the host logic that needs no card: the dtype dispatch between
the sm90 entries (bf16) and the FMA twins (fp32: csrc/attn_layouts.cu,
csrc/attn_arms.cu) through a patched `_cuda.function` (T5's copies of the
heads patched too), refusals of what TMA
cannot describe, the old entries' refusal of bf16 in their source (and no
bf16 kernel left in csrc/attn_arms.cuh), T7's
plan (consumer warpgroups by the waves of its all-heads grid; every query
row of every head covered once by the grid and the head loop), and torch
emulations of the kernels' tile arithmetic (T7: query tiles of 64, 128 or
192 rows, the heads in turn, key tiles of the bucket's BKV; T9: p split
into bf16 hi + lo) held against the TPU tools in interpret mode.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_arms_sm90.py): each against its
plain version at hd 40, 80 and 160, L 1100 and 2 images of 4 heads, T7
under every consumer count, replays bit-identical (eagerly and from a CUDA
graph), refusals that launch nothing, the old entries refusing bf16, the
C plan equal to its Python mirror.
"""

import ctypes
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
# two bf16 ulps at the outputs' magnitude (|o| < 2)
BF16_ATOL = 2.0**-7
# the 1024^2/4 stamp's UNet self-attentions: (B, L, D, heads), T7's
# consumer warpgroups and CTAs, T9's consumer warpgroups
STAMP = [((3, 16384, 320, 8), 3, 258, 3), ((3, 4096, 640, 8), 2, 96, 2),
         ((3, 1024, 1280, 8), 1, 48, 2)]


class _FakeCuda:
    """What the wrappers read of a contiguous CUDA tensor, on a machine
    without one."""

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

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def stride(self, d):
        return int(np.prod(self.shape[d:][1:]))


def _fake_cuda(monkeypatch):
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return call

    def split_heads(x, heads):
        b, l, d = x.shape
        return _FakeCuda((b * heads, l, d // heads), x.dtype)

    def merge_heads(x, batch):
        bh, l, hd = x.shape
        return _FakeCuda((batch, l, bh // batch * hd), x.dtype)

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _FakeCuda(t.shape, t.dtype))
    monkeypatch.setattr(arms, "split_heads", split_heads)
    monkeypatch.setattr(arms, "merge_heads", merge_heads)
    return calls


WRAPPERS = {"nomax_allheads": (arms.nomax_allheads,
                               arms.nomax_allheads_launches,
                               "attn_layouts"),
            "pvt_attention": (arms.pvt_attention, arms.pvt_launches,
                              "attn_arms"),
            "nomax_attention": (arms.nomax_attention, arms.nomax_launches,
                                "attn_arms"),
            "nomax_unpadded": (arms.nomax_unpadded,
                               arms.nomax_unpadded_launches, "attn_arms"),
            "nomax_4d": (arms.nomax_4d, arms.nomax_4d_launches,
                         "attn_layouts"),
            "nomax_laneslice": (arms.nomax_laneslice,
                                arms.nomax_laneslice_launches,
                                "attn_layouts")}
# name -> (B and H as the entry gets them for 3 images of 8 heads, the
# bf16 entry's arguments after the shift, the fp32 twin's after the shift
# and before the stream): T5 launches its (B*h, L, hd) copies as one head;
# T2's options (safe, bf16_p) are off by default
ENTRY_ARGS = {"nomax_allheads": ((3, 8), (0,), (0,)),
              "pvt_attention": ((3, 8), (), (0,)),
              "nomax_attention": ((3, 8), (0, 0), (0, 0, 0)),
              "nomax_unpadded": ((24, 1), (), (0,)),
              "nomax_4d": ((3, 8), (), (0,)),
              "nomax_laneslice": ((3, 8), (), (0,))}
# the fp32 twins' argument types
TWIN_ARGTYPES = {"nomax_attention": arms._NOMAX_ARGTYPES}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_dtype_dispatch(monkeypatch, name, dtype):
    """A bf16 CUDA call reaches dtp_<name>_sm90 of the wgmma/TMA source
    with B, H, Lq, Lk, hd, scale*log2(e) and the shift (T7: then 0, the
    plan's consumers; T2: then safe and bf16_p); an fp32 call the FMA
    twin's entry with is_bf16 0 (T2: after safe and bf16_p); T5 passes its
    split heads as B*h images of one head; each moves the counter by one,
    and the wrappers have no fallback."""
    calls = _fake_cuda(monkeypatch)
    wrapper, counter, twin = WRAPPERS[name]
    (B, H), bf16_extra, fp32_extra = ENTRY_ARGS[name]
    q = _FakeCuda((3, 1024, 1280), dtype)
    k = _FakeCuda((3, 900, 1280), dtype)
    before = counter.launches
    out = wrapper(q, k, k, 8, shift=30.0)
    assert tuple(out.shape) == (3, 1024, 1280)
    assert counter.launches == before + 1
    (source, symbol, args), = calls
    assert args[4:9] == (B, H, 1024, 900, 160)
    assert args[9] == pytest.approx(160**-0.5 * LOG2E)
    assert args[10] == 30.0
    if dtype == torch.bfloat16:
        assert (source, symbol) == ("flash_attention_sm90",
                                    f"dtp_{name}_sm90")
        assert args[11:-1] == bf16_extra
    else:
        assert (source, symbol) == (twin, f"dtp_{name}")
        assert args[11:-1] == fp32_extra  # the options, then is_bf16
    assert f'extern "C" cudaError_t dtp_{name}_sm90(' in SM90_CU.read_text()
    src = Path(arms.__file__).read_text()
    assert "try:" not in src and "except" not in src


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("D,ptr", [(4 * 36, 1 << 20), (320, (1 << 20) + 2)])
def test_bf16_refuses_what_tma_cannot_describe(monkeypatch, name, D, ptr):
    """bf16 with hd off a multiple of 8 (36) or a base off 16 bytes raises
    ValueError before any launch; the counter does not move."""
    calls = _fake_cuda(monkeypatch)
    wrapper, counter, _ = WRAPPERS[name]
    before = counter.launches
    q = _FakeCuda((2, 64, D), torch.bfloat16, ptr)
    with pytest.raises(ValueError, match="TMA"):
        wrapper(q, q, q, 4 if D % 36 == 0 else 8)
    assert calls == [] and counter.launches == before


def test_forced_consumers_out_of_range_raise(monkeypatch):
    """T7's forcing entry refuses a consumer count the bucket lacks (3
    above hd 48) before any launch; head_major passes -1 (T9's grid)."""
    calls = _fake_cuda(monkeypatch)
    q = _FakeCuda((1, 256, 640), torch.bfloat16)
    with pytest.raises(ValueError, match="consumers"):
        arms._nomax_allheads(q, q, q, 8, consumers=3)
    with pytest.raises(ValueError, match="consumers"):
        arms._nomax_allheads(q, q, q, 8, consumers=0)
    arms._nomax_allheads(q, q, q, 8, consumers=2)
    arms._nomax_allheads(q, q, q, 8, head_major=True)
    assert [c[2][11] for c in calls] == [2, -1]


@pytest.mark.parametrize("name,source", [("dtp_nomax_allheads",
                                          "attn_layouts.cu"),
                                         ("dtp_pvt_attention",
                                          "attn_arms.cu"),
                                         ("dtp_nomax_attention",
                                          "attn_arms.cu"),
                                         ("dtp_nomax_unpadded",
                                          "attn_arms.cu"),
                                         ("dtp_nomax_4d", "attn_layouts.cu"),
                                         ("dtp_nomax_laneslice",
                                          "attn_layouts.cu")])
def test_old_entries_refuse_bf16(name, source):
    """The FMA twins' entries return cudaErrorInvalidValue for bf16 and
    launch the fp32 body only; csrc/attn_arms.cuh holds no bf16 kernel:
    no mma.sync or ldmatrix, no bf16 arms_kernel, no bf16 operands."""
    text = (_cuda.CSRC / source).read_text()
    entry = text[text.index(f'extern "C" cudaError_t {name}('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16 || dtp::bad(" in entry
    assert "dispatch_f32<" in entry and "dispatch<" not in entry
    header = (_cuda.CSRC / "attn_arms.cuh").read_text()
    for gone in ("kPvt", "mma.sync", "ldmatrix", "arms_kernel(",
                 "launch_bf16", "__nv_bfloat16", "kUnpadded"):
        assert gone not in header, gone
    assert "arms_kernel_f32(" in header


def test_sm90_source_modes():
    """The one-pass modes and the all-heads grid in the source: the clamp
    and the epsilon as run-time fields (shift + 88 and 1e-30, or +inf and
    0 for T2 unclamped), T2's bf16 p (kShift | kBf16P, head-major), the hi
    + lo split into two products, the Q buffers' empty barriers."""
    text = SM90_CU.read_text()
    for frag in ("kShift = 4", "kShiftSplitP = 5",
                 "s[i] = ex2(fminf(s[i], cap) - a.shift);",
                 "const float cap = a.shift + (FIELDS ? a.clamp : 88.0f);",
                 "constexpr bool FIELDS = policy_of(LAST) == kShift && !AH;",
                 "const float x = ex2(round_bf16_int(",
                 "a.clamp = safe ? 88.0f : INFINITY;",
                 "a.eps = safe ? 1e-30f : 0.0f;",
                 "const float eps = FIELDS ? a.eps : 1e-30f;",
                 "constexpr bool SHIFT = policy_of(LAST) == kShift ||",
                 "launch_two_pass<kShift | kBf16P>(bucket",
                 "pv_split<NV, BKV>(o, pa, pl,",
                 "Wgmma<NV>::rs(o, lo[t], d, 1);",
                 "launch_two_pass<kShiftSplitP>(bucket",
                 "launch_two_pass<kShift>(bucket",
                 "launch<C::KD, C::NV, C::BKV, C::NC, kShift, true>(",
                 "mbar_arrive(q_empty(qb));",
                 "if (hi >= NQ) mbar_wait(q_empty(qb), ((hi / NQ) - 1) & 1);"):
        assert frag in text, frag


@pytest.mark.parametrize("shape,nc,ctas,nc9", STAMP, ids=str)
def test_plans_at_the_stamp_shapes(shape, nc, ctas, nc9):
    """T7 at the attn_arms path's shapes: three consumer warpgroups at L0
    (258 CTAs), two at L1 (96: one wave against two of 192), one at L2 (48
    against 24 on as many waves); T9 takes K2's bucket on its head-major
    grid."""
    B, L, D, heads = shape
    hd = D // heads
    p = arms.allheads_sm90_plan(hd, L, B)
    assert (p["consumers"], p["ctas"]) == (nc, ctas)
    assert p["smem"] <= attention.SMEM_LIMIT
    waves = lambda c: -(-arms.allheads_sm90_plan(hd, L, B, c)["ctas"]
                        // attention.SM_COUNT)
    for other in range(1, 4 if hd <= 48 else 3):
        assert (waves(nc), nc) <= (waves(other), other)
    assert attention.sm90_plan(hd, L, B * heads)["consumers"] == nc9


@pytest.mark.parametrize("hd", [8, 40, 48, 56, 80, 128, 136, 160])
def test_plan_buckets_and_memory(hd):
    """T7's (kd, nv, bkv) are K2's long-sequence bucket for hd; two Q
    buffers fit in shared memory at every consumer count; out-of-range
    counts raise."""
    kd, nv, bkv, _ = attention.SM90_BUCKETS[attention.sm90_bucket(hd)]
    most = 3 if hd <= 48 else 2
    for nc in range(1, most + 1):
        p = arms.allheads_sm90_plan(hd, 4096, 2, nc)
        assert (p["kd"], p["nv"], p["bkv"], p["consumers"]) == (kd, nv, bkv,
                                                                nc)
        assert p["smem"] <= attention.SMEM_LIMIT
    with pytest.raises(ValueError):
        arms.allheads_sm90_plan(hd, 4096, 2, most + 1)


# --- torch emulations of the kernels' tile arithmetic ---


def emulate_allheads(q, k, v, heads, rows, bkv, shift=32.0, seen=None):
    """T7's kernel on the CPU: a CTA a (query tile of `rows` rows, image),
    the heads in turn inside it; per head q scaled by scale*log2(e) and
    rounded, per key tile of bkv keys S in fp32, p = exp2(min(s, shift +
    88) - shift), the fp32 row sum of p, O += bf16(p) v in fp32; O * 1 / (l
    + 1e-30) rounded once. `seen` (B, L, heads) counts the writes."""
    B, L, D = q.shape
    hd = D // heads
    Lk = k.shape[1]
    out = torch.empty_like(q)
    for b in range(B):
        for q0 in range(0, L, rows):
            for h in range(heads):
                cols = slice(h * hd, (h + 1) * hd)
                qs = (q[b, q0:q0 + rows, cols].float()
                      * (hd**-0.5 * LOG2E)).to(q.dtype).float()
                o = torch.zeros(qs.shape)
                l = torch.zeros(qs.shape[0], 1)
                for j in range(0, Lk, bkv):
                    s = qs @ k[b, j:j + bkv, cols].float().T
                    p = torch.exp2(torch.clamp_max(s, shift + 88.0) - shift)
                    l += p.sum(-1, keepdim=True)
                    o += (p.to(torch.bfloat16).float()
                          @ v[b, j:j + bkv, cols].float())
                out[b, q0:q0 + rows, cols] = (o * (1.0 / (l + 1e-30))).to(
                    q.dtype)
                if seen is not None:
                    seen[b, q0:q0 + rows, h] += 1
    return out


def emulate_pvt(q, k, v, heads, bkv, shift=32.0):
    """T9's kernel on the CPU: T7's softmax per (head, key tile), P V as
    hi v + lo v with hi = bf16(p) and lo = bf16(p - hi), both in fp32."""
    B, L, D = q.shape
    hd = D // heads
    qs, kh, vh = arms._heads(q, k, v, heads)
    qs, kh, vh = qs.float(), kh.float(), vh.float()
    o = torch.zeros(qs.shape)
    l = torch.zeros(qs.shape[:-1] + (1,))
    for j in range(0, kh.shape[2], bkv):
        s = qs @ kh[:, :, j:j + bkv].transpose(-1, -2)
        p = torch.exp2(torch.clamp_max(s, shift + 88.0) - shift)
        l += p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        o += hi @ vh[:, :, j:j + bkv] + lo @ vh[:, :, j:j + bkv]
    out = (o * (1.0 / (l + 1e-30))).to(q.dtype)
    return out.transpose(1, 2).reshape(B, L, D)


def _inputs(shape, seed, scale=1.0):
    b, l, d = shape
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, l, d)) * s).astype(np.float32)
            for s in (scale, scale, 1.0)]


# (B, L, D, heads): hd 40 with ragged query and key tiles, hd 80 over
# two key tiles, hd 160 over the 64-key tiles of its bucket
EMULATED = [(2, 200, 160, 4), (1, 130, 160, 2), (1, 100, 320, 2)]


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("native_exp2", [False, True])
def test_emulated_allheads_matches_tool(monkeypatch, case, native_exp2):
    """T7's emulation under each consumer count its bucket offers (query
    tiles of 64, 128, 192 rows) against the tool's nomax_allheads (bq = L)
    with and without the native exp2 of bf16 (TPUExp2; T7 takes exp2 of
    fp32 logits, so both agree) and against plain_nomax_allheads, bf16:
    atol 2^-7. Every query row of every head is written exactly once."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    if native_exp2:
        monkeypatch.setattr(bench_attn_variants, "jnp", TPUExp2())
    B, L, D, heads = case
    hd = D // heads
    arrays = _inputs((B, L, D), 31)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_attn_variants.nomax_allheads(
            *(jnp.asarray(a, jnp.bfloat16) for a in arrays), heads,
            q_block=L), np.float32)
    plain = arms.plain_nomax_allheads(tq, tk, tv, heads).float().numpy()
    for nc in range(1, 4 if hd <= 48 else 3):
        p = arms.allheads_sm90_plan(hd, L, B, nc)
        seen = torch.zeros((B, L, heads), dtype=torch.int32)
        got = emulate_allheads(tq, tk, tv, heads, 64 * nc, p["bkv"],
                               seen=seen).float().numpy()
        assert torch.equal(seen, torch.ones_like(seen))
        assert p["ctas"] == B * -(-L // (64 * nc))
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
        np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("native_exp2", [False, True])
def test_emulated_pvt_matches_tool(monkeypatch, case, native_exp2):
    """T9's emulation (the bucket's key tiles, p as bf16 hi + lo) against
    the tool's pvt_attention (bq = L) with and without TPUExp2 and against
    plain_pvt_attention, bf16: atol 2^-7, at ordinary logits and at the
    clamp corner (q and k 8x: raw logits far above 83)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_round4

    if native_exp2:
        monkeypatch.setattr(bench_attn_round4, "jnp", TPUExp2())
    B, L, D, heads = case
    hd = D // heads
    bkv = attention.sm90_plan(hd, L, B * heads)["bkv"]
    for scale in (1.0, 8.0):
        arrays = _inputs((B, L, D), 32, scale)
        tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrays)
        got = emulate_pvt(tq, tk, tv, heads, bkv).float().numpy()
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(bench_attn_round4.pvt_attention(
                *(jnp.asarray(a, jnp.bfloat16) for a in arrays), heads,
                q_block=L), np.float32)
        plain = arms.plain_pvt_attention(tq, tk, tv, heads).float().numpy()
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
        np.testing.assert_allclose(got, plain, atol=BF16_ATOL, rtol=0)


def test_emulated_pvt_keeps_p_in_fp32():
    """Over the whole output, T9's emulation (p as hi + lo) is nearer in
    mean |diff| to a float64 evaluation with unrounded p than to one with
    bf16 p, and nearer to it than T5's (bf16 p) is."""
    heads = 2
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _inputs((1, 256, 80), 5))
    qs = arms._heads(tq, tk, tv, heads)[0].double()
    kh, vh = (attention._split_heads(t, heads).double() for t in (tk, tv))
    s = torch.clamp_max(qs @ kh.transpose(-1, -2), 32.0 + 88.0) - 32.0
    p = torch.exp2(s)
    l = p.sum(-1, keepdim=True) + 1e-30
    exact = attention._merge_heads((p @ vh) / l)
    rounded = attention._merge_heads(
        (p.to(torch.bfloat16).double() @ vh) / l)
    dist = lambda a, b: (a.double() - b).abs().mean().item()
    t9 = emulate_pvt(tq, tk, tv, heads, 128)
    t5 = arms.nomax_unpadded(tq, tk, tv, heads)
    assert dist(t9, exact) < dist(t9, rounded)
    assert dist(t9, exact) < dist(t5, exact)


@pytest.mark.parametrize("shape,heads", [((1, 256, 320), 8),
                                         ((2, 130, 640), 4)], ids=str)
def test_p_precision_probe_parts_t9_from_t7(shape, heads):
    """chip_smoke's P precision probe on the emulations: T9's (p as hi +
    lo) is P_PRECISION_MARGIN times nearer the bf16-rounded float64
    evaluation with unrounded p than the one with bf16(p), T7's the other
    way round, at ordinary logits and at the clamp corner (q and k 8x)."""
    import chip_smoke

    for scale in (1.0, 8.0):
        tq, tk, tv = (torch.from_numpy(a).bfloat16()
                      for a in _inputs(shape, 11, scale))
        bkv = attention.sm90_plan(shape[2] // heads)["bkv"]
        for got, own in ((emulate_pvt(tq, tk, tv, heads, bkv), 0),
                         (emulate_allheads(tq, tk, tv, heads, 64, bkv), 1)):
            dist = chip_smoke.p_precision(got, tq, tk, tv, heads)
            assert chip_smoke.P_PRECISION_MARGIN * dist[own] <= dist[1 - own]


def test_emulated_underflow_gives_zeros():
    """Every logit far below shift - 126: p is 0 everywhere, O / (0 +
    1e-30) is 0 and not NaN, in both emulations."""
    q = torch.full((1, 70, 160), 60.0).bfloat16()
    v = torch.randn((1, 70, 160)).bfloat16()
    for got in (emulate_allheads(q, -q, v, 4, 64, 128),
                emulate_pvt(q, -q, v, 4, 128)):
        assert torch.equal(got, torch.zeros_like(got))


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_sm90_matches_plain(name, hd):
    """bf16 T7 and T9 against their plain versions at L 1100 (a ragged last
    tile), 2 images of 4 heads, and with fewer keys than queries
    (chip_smoke's tolerance: 2^-5 of the largest output magnitude)."""
    gen = _setup()
    import chip_smoke

    for lk in (1100, 1000):
        key = ((2, 1100, 4 * hd), (2, lk, 4 * hd), 4)
        r = chip_smoke.compare(name, key, torch.bfloat16, gen)
        assert r["err_over_tol"] <= 1.0, (key, r)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
def test_sm90_pvt_keeps_p_in_fp32(hd):
    """On the card, bf16 T9's output is P_PRECISION_MARGIN times nearer
    the float64 evaluation with unrounded p than the one with bf16(p) (a
    kernel without the lo product computes T7's function and passes every
    tolerance check), and T7's the other way round; T7 on T9's head-major
    grid as T7 (L 1100, 2 images of 4 heads)."""
    gen = _setup()
    import chip_smoke

    q, k, v = (torch.randn((2, 1100, 4 * hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    for got, own in ((arms.pvt_attention(q, k, v, 4), 0),
                     (arms.nomax_allheads(q, k, v, 4), 1),
                     (arms._nomax_allheads(q, k, v, 4, head_major=True), 1)):
        dist = chip_smoke.p_precision(got, q, k, v, 4)
        assert chip_smoke.P_PRECISION_MARGIN * dist[own] <= dist[1 - own], (
            own, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [40, 80, 160])
def test_sm90_allheads_every_consumer_count(hd):
    """T7 under every consumer count, and on T9's head-major grid, against
    its plain version (one grid of whole tiles, one ragged), and each
    launch's bits equal on replay."""
    gen = _setup()
    for L in (1024, 1100):
        q, k, v = (torch.randn((2, L, 4 * hd), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        want = arms.plain_nomax_allheads(q, k, v, 4).float()
        tol = 2.0**-5 * want.abs().max().item()
        for opt in ([dict(consumers=nc) for nc in range(1, 4 if hd <= 48
                                                        else 3)]
                    + [dict(head_major=True)]):
            got = arms._nomax_allheads(q, k, v, 4, **opt)
            again = arms._nomax_allheads(q, k, v, 4, **opt)
            torch.cuda.synchronize()
            assert torch.equal(got, again), opt
            assert (got.float() - want).abs().max().item() <= tol, opt


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_sm90_replays_bit_identical(name):
    """Two eager calls and one replayed from a CUDA graph give the same
    bits at the attn_arms path's L2 shape and a ragged hd-40 one."""
    gen = _setup()
    wrapper = WRAPPERS[name][0]
    for shape, heads in (((3, 1024, 1280), 8), ((2, 1100, 320), 8)):
        q, k, v = (torch.randn(shape, generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        first, again = wrapper(q, k, v, heads), wrapper(q, k, v, heads)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = wrapper(q, k, v, heads)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, captured)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_sm90_refusals_launch_nothing(name):
    """bf16 at hd 36 and on a q 2 bytes off 16 raises ValueError and
    launches nothing (T5 before its copies of the heads); the old entry
    returns cudaErrorInvalidValue for bf16; fp32 at hd 36 runs the twin
    against its plain version."""
    gen = _setup()
    wrapper, counter, twin = WRAPPERS[name]
    before = counter.launches
    x = torch.randn((2, 64, 4 * 36), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="TMA"):
        wrapper(x, x, x, 4)
    flat = torch.randn(1 + 2 * 64 * 320, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(2, 64, 320)
    with pytest.raises(ValueError, match="TMA"):
        wrapper(off, off, off, 8)
    assert counter.launches == before
    y = torch.randn((2, 64, 320), generator=gen, device="cuda").bfloat16()
    out = torch.empty_like(y)
    fn = _cuda.function(twin, f"dtp_{name}",
                        TWIN_ARGTYPES.get(name, arms._SHIFT_ARGTYPES))
    code = fn(y.data_ptr(), y.data_ptr(), y.data_ptr(), out.data_ptr(), 2,
              8, 64, 64, 40, 0.1, 32.0, *ENTRY_ARGS[name][2][:-1], 1,
              _cuda.stream_of(y))
    assert code == 1  # cudaErrorInvalidValue
    xf = x.float()
    got = wrapper(xf, xf, xf, 4)
    want = getattr(arms, f"plain_{name}")(xf, xf, xf, 4)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_sm90_c_plan_equals_python_mirror():
    """dtp_nomax_allheads_sm90_plan against allheads_sm90_plan for every hd
    a multiple of 8 up to 160, short and long sequences, 1-3 images, the
    plan's and every forced consumer count."""
    _setup()
    fn = _cuda.function("flash_attention_sm90",
                        "dtp_nomax_allheads_sm90_plan",
                        (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    out = (ctypes.c_int * 6)()
    for hd in range(8, 161, 8):
        for lq in (1, 65, 1024, 4096, 16384):
            for B in (1, 2, 3):
                for nc in range(0, 4 if hd <= 48 else 3):
                    assert fn(hd, lq, B, nc, ctypes.addressof(out)) == 0
                    p = arms.allheads_sm90_plan(hd, lq, B, nc or None)
                    assert list(out) == [p["kd"], p["nv"], p["bkv"],
                                         p["consumers"], p["ctas"],
                                         p["smem"]], (hd, lq, B, nc)
    assert fn(168, 1024, 1, 0, ctypes.addressof(out)) == -1
    assert fn(80, 1024, 1, 3, ctypes.addressof(out)) == -1
