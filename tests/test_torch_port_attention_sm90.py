"""The host logic of the bf16 K2/K8/K13 kernel (csrc/flash_attention_sm90.cu),
which needs no card: the head-dim bucket and slice plan with its grid-fill
rule, the check that TMA can describe an operand, and the dtype dispatch
between the wgmma kernel (bf16) and the FMA twin (fp32,
csrc/flash_attention.cu).

The kernel itself is held against its plain versions on the card
(test_torch_port_cuda.py, chip_smoke.py); the plain versions against the
JAX kernels here (test_torch_port_attention.py).
"""

import re
from pathlib import Path

import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.ops import attention as t_attn

SM90_CU = _cuda.CSRC / "flash_attention_sm90.cu"
OLD_CU = _cuda.CSRC / "flash_attention.cu"


@pytest.mark.parametrize("lo,hi", [(1, 48), (49, 80), (81, 128),
                                   (129, 160), (161, 256), (257, 512)])
@pytest.mark.parametrize("lq,bh", [(None, None), (16384, 24), (1024, 24),
                                   (1024, 1), (1, 1)])
def test_sm90_plan_covers_every_head_dim(lo, hi, lq, bh):
    """Each hd of a bucket, for long and short grids: Q K^T over whole k16
    steps at least hd deep, P V slices of whole n8 tiles that cover hd and
    no more slices than needed, shared memory within the H100's 232,448
    bytes a block; the buckets change exactly at their bounds."""
    plans = {hd: t_attn.sm90_plan(hd, lq, bh) for hd in range(lo, hi + 1)}
    for hd, p in plans.items():
        assert p["kd"] >= hd and p["kd"] % 16 == 0, (hd, p)
        assert p["nv"] % 8 == 0 and p["nv"] <= p["kd"], (hd, p)
        assert (p["slices"] - 1) * p["nv"] < hd <= p["slices"] * p["nv"]
        assert p["bkv"] % 16 == 0 and p["consumers"] in (1, 2, 3)
        assert p["smem"] <= t_attn.SMEM_LIMIT, (hd, p)
        assert t_attn.SM90_BUCKETS[p["bucket"]] == (
            p["kd"], p["nv"], p["bkv"], p["consumers"])
    assert len({p["bucket"] for p in plans.values()}) == 1
    assert plans[hi]["kd"] == hi


@pytest.mark.parametrize("hd,lq,bh,bucket", [
    # K2 at 256^2 (UNet level 0, the VAE mid-blocks) and 1024^2 (levels 1
    # and 2), K8 at 1024^2 (level 0, the VAE mid-blocks)
    (40, 1024, 24, 1), (512, 1024, 2, 7), (512, 1024, 1, 7),
    (80, 4096, 24, 2), (160, 1024, 24, 4),
    (40, 16384, 24, 0), (512, 16384, 2, 6), (512, 16384, 1, 6)])
def test_sm90_plan_of_the_served_shapes(hd, lq, bh, bucket):
    """Short grids take the buckets with more, smaller blocks: two
    consumer warpgroups at hd 40 and 1024 tokens (192 CTAs, not 144),
    four 128-column slices at hd 512 (64-128 CTAs, not 32-64)."""
    assert t_attn.sm90_bucket(hd, lq, bh) == bucket
    p = t_attn.sm90_plan(hd, lq, bh)
    ctas = -(-lq // (64 * p["consumers"])) * bh * p["slices"]
    assert ctas >= t_attn.SM_COUNT // 4


def test_sm90_plan_matches_the_source():
    """SM90_BUCKETS mirrors the source's kBuckets, in order; sm90_bucket's
    head-dim bounds and grid thresholds are the source plan()'s; each
    case of run()'s dispatch launches its bucket's instantiation."""
    text = SM90_CU.read_text()
    table = text[text.index("constexpr int kBuckets[][4] = {"):]
    table = table[:table.index("};")]
    rows = [tuple(map(int, r)) for r in
            re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\}", table)]
    assert tuple(rows) == t_attn.SM90_BUCKETS
    body = text[text.index("int plan(int hd, int lq, int bh) {"):]
    body = body[:body.index("\n}\n")]
    bounds = [(int(b), int(i)) for b, i in
              re.findall(r"if \(hd <= (\d+)\) return (\d+);", body)]
    for bound, i in bounds:
        assert t_attn.sm90_bucket(bound) == i
        assert t_attn.sm90_bucket(bound + 1) != i
    assert "(lq + 191) / 192) * bh < 2 * kSMs ? 1 : 0" in body
    assert "(lq + 63) / 64) * bh * 2 < kSMs ? 7 : 6" in body
    run = text[text.index("cudaError_t run(const void* q"):]
    run = run[:run.index("\n}\n")]
    single = run[run.rindex("switch (bucket) {"):]
    cases = re.findall(r"(?:case (\d+)|default):\s*return launch<(\d+), "
                       r"(\d+), (\d+), (\d+), false>", single)
    assert len(cases) == len(t_attn.SM90_BUCKETS)
    for i, (case, *args) in enumerate(cases):
        assert case in (str(i), "")
        assert tuple(map(int, args)) == t_attn.SM90_BUCKETS[i]
    assert f"kStages = {t_attn.SM90_STAGES};" in text
    assert f"kSMs = {t_attn.SM_COUNT};" in text


# the served shapes (batch, length, width, heads): K8 at UNet level 0 and
# the VAE mid-block of a 1024^2 stamp; K13's slotted widths of 512^2
@pytest.mark.parametrize("b,l,d,heads", [(3, 16384, 320, 8),
                                         (1, 16384, 512, 1),
                                         (2, 16384, 512, 1),
                                         (2, 1100, 640, 4)])
def test_tma_accepts_the_streaming_shapes(b, l, d, heads):
    x = torch.empty((b, l, d), dtype=torch.bfloat16)
    assert t_attn.tma_describable(x, d // heads)


@pytest.mark.parametrize("b,l,heads", [(3, 4096, 8), (3, 1024, 8),
                                       (1, 64, 2)])
def test_tma_accepts_slotted_views_of_one_projection(b, l, heads):
    """q, k, v as chunks of one fused (B, L, 3*H*128) projection, and a
    contiguous slotted tensor."""
    d = heads * t_attn.SLOT
    qkv = torch.empty((b, l, 3 * d), dtype=torch.bfloat16)
    for t in qkv.chunk(3, dim=-1):
        assert t.stride(1) == 3 * d
        assert t_attn.tma_describable(t, t_attn.SLOT)
    assert t_attn.tma_describable(torch.empty((b, l, d),
                                              dtype=torch.bfloat16),
                                  t_attn.SLOT)


def test_tma_rejects_unaligned_bases_and_strides():
    """A base 2 bytes off 16, a row stride of 6152 bytes, a head stride of
    72 bytes (hd 36 read in place), non-contiguous lanes: all refused."""
    flat = torch.empty(1 + 64 * 1024, dtype=torch.bfloat16)
    off = flat[1:].view(1, 64, 1024)
    assert flat[:-1].view(1, 64, 1024).data_ptr() % 16 == 0
    assert not t_attn.tma_describable(off, t_attn.SLOT)
    qkv = torch.empty((2, 64, 3 * 1024 + 4), dtype=torch.bfloat16)
    q = qkv[..., :1024]
    assert q.data_ptr() % 16 == 0 and q.stride(1) * 2 % 16 == 8
    assert not t_attn.tma_describable(q, t_attn.SLOT)
    x = torch.empty((2, 64, 4 * 36), dtype=torch.bfloat16)
    assert not t_attn.tma_describable(x, 36)
    assert t_attn.tma_describable(torch.empty((2, 64, 4 * 40),
                                              dtype=torch.bfloat16), 40)
    lanes = torch.empty((2, 64, 2048), dtype=torch.bfloat16)[..., ::2]
    assert not t_attn.tma_describable(lanes, t_attn.SLOT)


def test_tma_ignores_strides_of_unit_dimensions():
    """One image or one row: that stride is never stepped."""
    x = torch.empty((1, 1, 3 * 1024 + 4), dtype=torch.bfloat16)[..., :1024]
    assert t_attn.tma_describable(x, t_attn.SLOT)
    y = torch.empty((2, 64, 3 * 1024 + 4), dtype=torch.bfloat16)[:1, :, :1024]
    assert not t_attn.tma_describable(y, t_attn.SLOT)


@pytest.mark.parametrize("kind,symbol", [
    ("resident", "dtp_flash_attention"),
    ("streaming", "dtp_flash_attention_streaming"),
    ("slotted", "dtp_flash_attention_slotted")])
def test_bf16_goes_to_the_wgmma_kernel_and_fp32_to_the_fma_twin(kind,
                                                                symbol):
    """bf16 CUDA calls of K2, K8 and K13 name the sm90 entry of the new
    source, fp32 the old entry; the new source is built with the others
    and defines the three entries; the old entries refuse bf16 (no second
    bf16 body)."""
    assert t_attn.kernel_entry(kind, torch.bfloat16) == (
        "flash_attention_sm90", symbol + "_sm90")
    assert t_attn.kernel_entry(kind, torch.float32) == ("flash_attention",
                                                        symbol)
    assert "flash_attention_sm90" in _cuda.SOURCES
    assert f'extern "C" cudaError_t {symbol}_sm90(' in SM90_CU.read_text()
    old = OLD_CU.read_text()
    entry = old[old.index(f'extern "C" cudaError_t {symbol}('):]
    entry = entry[:entry.index("\n}\n")]
    assert "if (is_bf16) return cudaErrorInvalidValue;" in entry
    assert "__nv_bfloat16" not in entry
    assert "__nv_bfloat16" not in old and "wmma" not in old


def test_wrappers_have_no_fallback():
    """A CUDA call launches its dtype's kernel or raises: no `try` around a
    launch in the attention wrappers."""
    src = Path(t_attn.__file__).read_text()
    assert "try:" not in src and "except" not in src


def test_plans_entry_point_runs_on_cpu(capsys):
    """tools/sm90_plans.py on the CPU: the plain versions, the plan's
    bucket and tile a shape (K2, K9, K1/K5, K14), nothing timed; without
    --device cpu and without a card it refuses."""
    import json

    from diffusiontexturepainting_torch.tools import sm90_plans

    assert sm90_plans.main(["--device", "cpu", "--shapes", "tiny"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["device"] == "cpu"
    kernels = [r["kernel"] for r in record["rows"]]
    assert kernels == ["K2", "K2", "K9", "K1/K5", "K1/K5", "K14"]
    assert all(r["plan"] and r["ms"] is None and r["max_diff"] == 0.0
               for r in record["rows"])
    if not torch.cuda.is_available():
        assert sm90_plans.main([]) == 1
