"""The host logic of the bf16 K8/K13 kernel (csrc/flash_attention_sm90.cu),
which needs no card: the head-dim bucket and slice plan, the check that TMA
can describe an operand, and the dtype dispatch between the wgmma kernel
(bf16) and the FMA twin (fp32, csrc/flash_attention.cu).

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
                                   (129, 256), (257, 512)])
def test_sm90_plan_covers_every_head_dim(lo, hi):
    """Each hd of a bucket: Q K^T over whole k16 steps at least hd deep, P V
    slices of whole n8 tiles that cover hd and no more slices than needed,
    shared memory within the H100's 232,448 bytes a block; the buckets
    change exactly at their bounds."""
    plans = {hd: t_attn.sm90_plan(hd) for hd in range(lo, hi + 1)}
    for hd, p in plans.items():
        assert p["kd"] >= hd and p["kd"] % 16 == 0, (hd, p)
        assert p["nv"] % 8 == 0 and p["nv"] <= p["kd"], (hd, p)
        assert (p["slices"] - 1) * p["nv"] < hd <= p["slices"] * p["nv"]
        assert p["bkv"] % 16 == 0 and p["consumers"] in (1, 2, 3)
        assert p["smem"] <= t_attn.SMEM_LIMIT, (hd, p)
    assert len({tuple(sorted(p.items())) for p in plans.values()}) == 1
    assert plans[hi]["kd"] == hi


def test_sm90_plan_matches_the_source():
    """sm90_plan mirrors the source's plan(): the same bucket bounds and
    template arguments, in the same order."""
    text = SM90_CU.read_text()
    body = text[text.index("Bucket plan(int hd) {"):]
    body = body[:body.index("\n}\n")]
    rows = re.findall(r"(?:if \(hd <= (\d+)\) )?return bucket_of<(\d+), "
                      r"(\d+), (\d+), (\d+)>\(hd\);", body)
    assert len(rows) == 5
    for bound, kd, nv, bkv, nc in rows:
        hd = int(bound or 512)
        p = t_attn.sm90_plan(hd)
        assert (p["kd"], p["nv"], p["bkv"], p["consumers"]) == (
            int(kd), int(nv), int(bkv), int(nc)), (hd, p)
    assert f"kStages = {t_attn.SM90_STAGES};" in text


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


@pytest.mark.parametrize("kind", ["streaming", "slotted"])
def test_bf16_goes_to_the_wgmma_kernel_and_fp32_to_the_fma_twin(kind):
    """bf16 CUDA calls name the sm90 entry of the new source, fp32 the old
    entry; the new source is built with the others and defines both
    entries; the old entries refuse bf16 (no second bf16 body)."""
    symbol = f"dtp_flash_attention_{kind}"
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


def test_wrappers_have_no_fallback():
    """A CUDA call launches its dtype's kernel or raises: no `try` around a
    launch in the attention wrappers."""
    src = Path(t_attn.__file__).read_text()
    assert "try:" not in src and "except" not in src
