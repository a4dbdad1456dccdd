"""bf16 T4 (slotted_kernel_call) on K13's two-pass sm90 kernel
(csrc/flash_attention_sm90.cu dtp_slotted_attention_sm90): the row-max
softmax over heads already split into (B*h, L, P) slots, every lane read,
H = 1 and hd = P, with exp2 of bf16 logits or of fp32 logits.

On the CPU, the host logic that needs no card: the dtype dispatch between
the sm90 entry (bf16) and the FMA twin (fp32, csrc/attn_layouts.cu) through
a patched `_cuda.function`, refusals of what TMA cannot describe, the
bucket P selects and the source's two-pass buckets, and a torch emulation
of the kernel's order (pass 1 the exact row max over every key tile, pass 2
per tile p, the fp32 row sum and bf16(p) V) in both softmax flavours, held
against the TPU tool's slotted_kernel_call in interpret mode at P 128 and
160 with Lq != Lk, and against plain_slotted_kernel_call.

Marked `cuda` (skipped without a card; on the card: python -m pytest -m
cuda --noconftest tests/test_torch_port_slotted_arm_sm90.py): the kernel
against its plain version at the slotted stamp's shapes and ragged ones (Lq
!= Lk, P 64, 128 and 160), replays bit-identical, agreement with K13 on the
same data, each softmax flavour against its own emulation closer than the
flavours are to each other, refusals that launch nothing, the old entry
refusing bf16.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import attention
from diffusiontexturepainting_torch.ops import attention_variants as arms

torch.set_num_threads(2)

# The JAX reference (the TPU tool) is imported by the CPU test that uses
# it: the card's machine, which runs the `cuda` tests, has no JAX.

SM90_CU = _cuda.CSRC / "flash_attention_sm90.cu"
OLD_CU = _cuda.CSRC / "attn_layouts.cu"
# two bf16 ulps at the outputs' magnitude (|o| < 2)
BF16_ATOL = 2.0**-7


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


def _fake_cuda(monkeypatch):
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return call

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _FakeCuda(t.shape, t.dtype))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("exp2_bf16", [True, False])
def test_slotted_dtype_dispatch(monkeypatch, dtype, exp2_bf16):
    """A bf16 CUDA call reaches dtp_slotted_attention_sm90 of K13's source
    with Lq, Lk, P, scale*log2(e) and the flavour; an fp32 call the FMA
    twin's entry with is_bf16 0; each moves the counter by one. The old
    entry refuses bf16, and the wrapper has no fallback."""
    calls = _fake_cuda(monkeypatch)
    q = _FakeCuda((24, 1024, 128), dtype)
    k = _FakeCuda((24, 900, 128), dtype)
    before = arms.slotted_launches.launches
    out = arms.slotted_kernel_call(q, k, k, 0.125, exp2_bf16=exp2_bf16)
    assert tuple(out.shape) == (24, 1024, 128)
    assert arms.slotted_launches.launches == before + 1
    args = calls[0][2]
    assert args[4:8] == (24, 1024, 900, 128)
    assert args[8] == pytest.approx(0.125 * 1.4426950408889634)
    assert args[9] == int(exp2_bf16)
    if dtype == torch.bfloat16:
        assert calls[0][:2] == ("flash_attention_sm90",
                                "dtp_slotted_attention_sm90")
        assert len(args) == 11
    else:
        assert calls[0][:2] == ("attn_layouts", "dtp_slotted_attention")
        assert args[10] == 0  # is_bf16
    text = SM90_CU.read_text()
    assert 'extern "C" cudaError_t dtp_slotted_attention_sm90(' in text
    old = OLD_CU.read_text()
    entry = old[old.index('extern "C" cudaError_t dtp_slotted_attention('):]
    assert "if (is_bf16 ||" in entry
    assert "dispatch<dtp::kRowmax" not in old
    src = Path(arms.__file__).read_text()
    assert "try:" not in src and "except" not in src


@pytest.mark.parametrize("P,ptr", [(36, 1 << 20), (128, (1 << 20) + 2)])
def test_slotted_refuses_what_tma_cannot_describe(monkeypatch, P, ptr):
    """bf16 with P off a multiple of 8, or a base off 16 bytes, raises
    ValueError before any launch; the counter does not move."""
    calls = _fake_cuda(monkeypatch)
    before = arms.slotted_launches.launches
    q = _FakeCuda((4, 64, P), torch.bfloat16, ptr)
    with pytest.raises(ValueError, match="TMA"):
        arms.slotted_kernel_call(q, q, q, 0.1)
    assert calls == [] and arms.slotted_launches.launches == before


@pytest.mark.parametrize("P,kd", [(40, 48), (64, 80), (80, 80), (128, 128),
                                  (152, 160), (160, 160)])
def test_slotted_bucket_from_P(P, kd):
    """T4 reads every lane: its bucket is K13's for hd = P (128 -> 128,
    160 -> 160, K2's two warpgroups on 64-key tiles), one output slice; the
    source takes two passes up to the 160 bucket, in both flavours."""
    p = attention.sm90_plan(P, 4096, 24)
    assert p["kd"] == kd and p["nv"] >= P and p["slices"] == 1
    if P > 48:
        assert p["consumers"] == 2
    text = SM90_CU.read_text()
    for frag in ("(two_pass && a.hd > 160)", "(two_pass && bucket > 4)",
                 "kFixedMaxF32 = 3", "launch_two_pass<kFixedMaxF32>",
                 "launch_two_pass<kFixedMax>(",
                 "default: return launch<160, 160, 64, 2, LAST>",
                 "slot < hd || slot > 128"):
        assert frag in text, frag


def emulate_slotted(qh, kh, vh, scale, exp2_bf16):
    """The kernel's order on the CPU: q scaled by scale*log2(e) and rounded;
    pass 1 the exact row max of S = q k^T over every key tile of the
    bucket; pass 2 the same S per tile, p = bf16(exp2(bf16(s - m))) or
    p = exp2(s - m) in fp32, the row sum of those p in fp32 tile by tile,
    O += bf16(p) v in fp32; O / l rounded once."""
    BH, Lq, P = qh.shape
    bkv = attention.sm90_plan(P, Lq, BH)["bkv"]
    qs = (qh.float() * (scale * 1.4426950408889634)).to(qh.dtype).float()
    kf, vf = kh.float(), vh.float()
    tiles = range(0, kh.shape[1], bkv)
    m = torch.cat([qs @ kf[:, j:j + bkv].transpose(1, 2) for j in tiles],
                  dim=-1).amax(-1, keepdim=True)
    o = torch.zeros((BH, Lq, P))
    l = torch.zeros((BH, Lq, 1))
    for j in tiles:
        d = qs @ kf[:, j:j + bkv].transpose(1, 2) - m
        if exp2_bf16:
            p = torch.exp2(d.to(torch.bfloat16).float()).to(torch.bfloat16)
        else:
            p = torch.exp2(d)
        l += p.float().sum(-1, keepdim=True)
        o += p.to(torch.bfloat16).float() @ vf[:, j:j + bkv]
    return (o / l).to(qh.dtype)


def _slots(rng, BH, L, P, hd):
    x = np.zeros((BH, L, P), np.float32)
    x[..., :hd] = rng.standard_normal((BH, L, hd))
    return x


# (BH, Lq, Lk, P, real lanes hd): the tool's 128-lane slots at hd 40 and
# 80, the 160-lane tile at hd 150, keys off the 64- and 128-key tiles
EMULATED = [(2, 128, 200, 128, 40), (3, 64, 136, 128, 80),
            (2, 64, 100, 160, 150), (1, 128, 64, 160, 160)]


@pytest.mark.parametrize("case", EMULATED, ids=str)
@pytest.mark.parametrize("exp2_bf16", [True, False])
def test_emulated_passes_match_tool(monkeypatch, case, exp2_bf16):
    """Both flavours on the exact-max pass order against the tool's
    slotted_kernel_call (bq = Lq; the tool's exp2 of bf16 made native by
    TPUExp2, as the old arm's test does) and against
    plain_slotted_kernel_call, bf16: atol 2^-7 (a bf16 p may move by one
    ulp with the order in which s is summed)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from diffusiontexturepainting_tpu.ops import flash_attention as j_fa
    from tests.test_torch_port_attention_variants import TPUExp2
    from tools import bench_attn_variants

    monkeypatch.setattr(j_fa, "jnp", TPUExp2())
    BH, Lq, Lk, P, hd = case
    rng = np.random.default_rng(21)
    q, k, v = (_slots(rng, BH, L, P, hd) for L in (Lq, Lk, Lk))
    scale = hd**-0.5
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = emulate_slotted(tq, tk, tv, scale, exp2_bf16).float().numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_attn_variants.slotted_kernel_call(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale,
            bq=Lq, exp2_bf16=exp2_bf16), np.float32)
    plain = arms.plain_slotted_kernel_call(tq, tk, tv, scale,
                                           exp2_bf16=exp2_bf16)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=BF16_ATOL,
                               rtol=0)
    assert not got[..., hd:].any()


# --- on the card ---


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


# chip_smoke's T4 keys: ((BH, Lq, P), (BH, Lk, P), heads, hd, exp2_bf16):
# the slotted 512^2/4 stamp's K13 shapes, then Lq != Lk and P 64, 128, 160
CARD_KEYS = [((24, 4096, 128), (24, 4096, 128), 8, 40, True),
             ((24, 1024, 128), (24, 1024, 128), 8, 80, True),
             ((24, 1024, 128), (24, 1024, 128), 8, 80, False),
             ((8, 1100, 128), (8, 900, 128), 4, 40, False),
             ((8, 300, 64), (8, 777, 64), 4, 64, True),
             ((4, 1100, 160), (4, 1100, 160), 2, 150, True),
             ((4, 300, 160), (4, 777, 160), 2, 160, False),
             ((6, 65, 80), (6, 1, 80), 3, 80, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("key", CARD_KEYS, ids=str)
def test_sm90_slotted_matches_plain(key):
    """bf16 T4 against plain_slotted_kernel_call (chip_smoke's tolerance:
    2^-5 of the largest output magnitude), pad lanes zero."""
    gen = _setup()
    import chip_smoke

    r = chip_smoke.compare("slotted_kernel_call", key, torch.bfloat16, gen)
    assert r["err_over_tol"] <= 1.0, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 1024, 1024, 128, 80),
                                   (4, 300, 777, 160, 150),
                                   (8, 200, 130, 64, 64)], ids=str)
def test_sm90_slotted_replays_and_matches_k13(shape):
    """Both flavours are bit-identical on replay; at 128 lanes and
    self-attention, T4 with exp2_bf16 is K13's function on the same data
    in the (B, L, h*128) layout (within 2^-5 of the peak)."""
    gen = _setup()
    BH, Lq, Lk, P, hd = shape
    heads = 8 if BH % 8 == 0 else 1

    def slots(L):
        x = torch.zeros((BH, L, P), device="cuda").bfloat16()
        x[..., :hd] = torch.randn((BH, L, hd), generator=gen,
                                  device="cuda").bfloat16()
        return x
    q, k, v = slots(Lq), slots(Lk), slots(Lk)
    for exp2_bf16 in (True, False):
        first = arms.slotted_kernel_call(q, k, v, hd**-0.5,
                                         exp2_bf16=exp2_bf16)
        again = arms.slotted_kernel_call(q, k, v, hd**-0.5,
                                         exp2_bf16=exp2_bf16)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        if exp2_bf16 and P == attention.SLOT and Lq == Lk:
            merged = lambda t: arms.merge_heads(t, BH // heads)
            k13 = attention.flash_attention_slotted(
                merged(q), merged(k), merged(v), heads, hd)
            want = merged(first).float()
            tol = 2.0**-5 * want.abs().max().item()
            assert (k13.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 300, 777, 128, 80),
                                   (4, 300, 777, 160, 150),
                                   (8, 256, 512, 64, 64)], ids=str)
def test_sm90_slotted_flavours_are_told_apart(shape):
    """Each softmax flavour against emulate_slotted of that flavour on the
    CPU: the two emulated flavours differ (a bf16 ulp in many elements),
    and each kernel's mean |error| against its own flavour must stay below
    1/16 of the flavours' mean gap (the emulation differs from the kernel
    only in fp32 summation order and exp2's last bits, which rarely move a
    bf16 rounding), while the kernel's two flavours differ by more than
    half that gap: a dispatch that ignored exp2_bf16 fails."""
    gen = _setup()
    BH, Lq, Lk, P, hd = shape

    def slots(L):
        x = torch.zeros((BH, L, P), device="cuda").bfloat16()
        x[..., :hd] = torch.randn((BH, L, hd), generator=gen,
                                  device="cuda").bfloat16()
        return x
    q, k, v = slots(Lq), slots(Lk), slots(Lk)
    scale = hd**-0.5
    got = {f: arms.slotted_kernel_call(q, k, v, scale, exp2_bf16=f).cpu()
           .float() for f in (True, False)}
    want = {f: emulate_slotted(q.cpu(), k.cpu(), v.cpu(), scale, f).float()
            for f in (True, False)}
    gap = (want[True] - want[False]).abs().mean().item()
    assert gap > 0
    for f in (True, False):
        assert (got[f] - want[f]).abs().mean().item() <= gap / 16, f
        assert (got[f] - want[f]).abs().max().item() <= BF16_ATOL, f
    assert (got[True] - got[False]).abs().mean().item() > gap / 2


@pytest.mark.cuda
def test_sm90_slotted_refuses_what_tma_cannot_describe():
    """bf16 T4 at P 36 and on a q 2 bytes off 16 raises ValueError and
    launches nothing; the old entry returns cudaErrorInvalidValue for
    bf16; fp32 at P 36 runs the twin."""
    gen = _setup()
    counter = arms.slotted_launches
    before = counter.launches
    x = torch.randn((2, 64, 36), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="TMA"):
        arms.slotted_kernel_call(x, x, x, 0.1)
    flat = torch.randn(1 + 2 * 64 * 128, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(2, 64, 128)
    with pytest.raises(ValueError, match="TMA"):
        arms.slotted_kernel_call(off, off, off, 0.1)
    assert counter.launches == before
    y = torch.randn((2, 64, 128), generator=gen, device="cuda").bfloat16()
    out = torch.empty_like(y)
    fn = _cuda.function("attn_layouts", "dtp_slotted_attention",
                        arms._SLOTTED_ARGTYPES)
    code = fn(y.data_ptr(), y.data_ptr(), y.data_ptr(), out.data_ptr(), 2,
              64, 64, 128, 0.1, 1, 1, _cuda.stream_of(y))
    assert code == 1  # cudaErrorInvalidValue
    xf = x.float()
    got = arms.slotted_kernel_call(xf, xf, xf, 0.1, exp2_bf16=False)
    want = arms.plain_slotted_kernel_call(xf, xf, xf, 0.1, exp2_bf16=False)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
