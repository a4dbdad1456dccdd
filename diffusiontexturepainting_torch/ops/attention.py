"""Attention compute paths: (B, L, heads*hd) projections in and out.

Port of diffusiontexturepainting_tpu/ops/attention.py and
ops/flash_attention.py. `attention` keeps the JAX package's dispatch rule
(`attention_route`): self-attention with Lq == Lk >= 1024 and head dim
<= 512 goes to a fused kernel, the resident one (K2, replacing
flash_attention / _attn_kernel) where its K/V panel and score block fit the
TPU kernel's 11 MiB budget, else the streaming one (K8, replacing
flash_attention_streaming / _stream_kernel: the 16384 tokens of the 1024^2
point); all other attention (the 14-token cross-attention, CLIP's 50
tokens, the UNet's shorter levels) is plain matmul -> fp32 softmax ->
matmul, as the JAX package's xla_attention. The budget is the TPU's; it is
kept so that each counter here maps to exactly one TPU kernel.

`flash_attention_slotted` (K13, replacing flash_attention_slotted) reads
and writes the head-slotted (B, L, heads*128) layout that models/layers.py
Attention's slotted leg produces.

Kernels live in csrc/flash_attention.cu (K2, K8 and K13 in fp32: an FMA
twin) and csrc/flash_attention_sm90.cu (K2, K8 and K13 in bf16: wgmma fed
by TMA), the dtype choosing the source (`kernel_entry`). A wrapper takes
its plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. Inside the trainer's scope
(conv3x3.conv_impl("plain")) `attention` is plain_attention. Every fused kernel rounds where the TPU
kernels round: q pre-scaled by scale*log2(e) and rounded to its dtype
before Q K^T, a base-2 softmax, probabilities rounded to v's dtype, the
division after P V. K2 and K8 so compute one function, as in the JAX
package (K2's plain version is K8's); the TPU's K2 took a static shift
where both take the exact row max, which equals it within the nomax
domain. K13 also takes exp2 of bf16 logits. plain_attention, the "plain"
route, scales the fp32 scores instead, as the JAX xla_attention does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .conv3x3 import current_impl

FLASH_MIN_Q_LEN = 1024
MAX_FLASH_HEAD_DIM = 512
# VMEM budget of the TPU's resident kernels (K2, K13)
RESIDENT_BUDGET = 11 * 1024 * 1024
SLOT = 128  # lanes of one head in the slotted layout
_LOG2E = 1.4426950408889634

flash_launches = _cuda.LaunchCounter("flash_attention")
flash_streaming_launches = _cuda.LaunchCounter("flash_attention_streaming")
flash_slotted_launches = _cuda.LaunchCounter("flash_attention_slotted")

_STREAM_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# K2's bf16 entry takes a bucket index last (-1: the plan's)
_RESIDENT_SM90_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                           + (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p))
_SLOT_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                  + (ctypes.c_longlong,) * 4
                  + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))

# The bf16 bodies of K2, K8 and K13 (csrc/flash_attention_sm90.cu) and the
# shared memory a block may use on the H100.
SM90_SOURCE = "flash_attention_sm90"
SM90_STAGES = 2
SMEM_LIMIT = 232448
SM_COUNT = 132  # H100 SXM
# (kd, nv, bkv, consumers) of each instantiation of the bf16 kernel, in the
# order of the source's kBuckets
SM90_BUCKETS = ((48, 48, 128, 3), (48, 48, 128, 2), (80, 80, 128, 2),
                (128, 128, 128, 2), (160, 160, 64, 2), (256, 256, 32, 1),
                (512, 256, 32, 1), (512, 128, 32, 1))
_ENTRY_SYMBOLS = {"resident": "dtp_flash_attention",
                  "streaming": "dtp_flash_attention_streaming",
                  "slotted": "dtp_flash_attention_slotted"}

def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


# --- routing (the JAX package's ops/attention.py:74-111) ---


def uses_flash(lq: int, lk: int, head_dim: int) -> bool:
    """Whether a fused kernel takes the call (ops/attention.py:95-101)."""
    return (lq >= FLASH_MIN_Q_LEN and lq == lk
            and head_dim <= MAX_FLASH_HEAD_DIM)


def resident_fits(lk: int, head_dim: int, dtype) -> bool:
    """The resident kernel's K/V panel (head dim padded to 128 lanes) plus
    its (q_block, Lk) fp32 score block within the budget."""
    hd_pad = (head_dim + 127) // 128 * 128
    itemsize = dtype.itemsize
    qb = 512 if hd_pad <= 128 else 128
    if itemsize > 2:
        qb = min(qb, 256)
    kv_bytes = 2 * lk * hd_pad * itemsize
    score_bytes = qb * lk * 4
    return kv_bytes + score_bytes <= RESIDENT_BUDGET


def attention_route(lq: int, lk: int, head_dim: int, dtype) -> str:
    """'flash' (K2), 'streaming' (K8) or 'plain' for one attention call."""
    if not uses_flash(lq, lk, head_dim):
        return "plain"
    return "flash" if resident_fits(lk, head_dim, dtype) else "streaming"


def slotted_self_attention_fits(lq: int, lk: int, head_dim: int,
                                q_block: int = 512) -> bool:
    """Whether the slotted kernel takes a self-attention: the JAX rule
    (one head slot's (Lk, 128) bf16 K/V panel plus a (q_block, Lk) fp32
    score block within the budget, lengths in whole 128-row blocks)."""
    if head_dim > SLOT or lq % 128 or lk % 128:
        return False
    bq = min(q_block, lq)
    if lq % bq:
        return False
    return 2 * lk * SLOT * 2 + bq * lk * 4 <= RESIDENT_BUDGET


# --- the bf16 kernel's host plan (csrc/flash_attention_sm90.cu plan) ---


def kernel_entry(kind: str, dtype) -> tuple[str, str]:
    """(source, C symbol) a CUDA call of K2 (`kind` "resident"), K8
    ("streaming") or K13 ("slotted") launches: bf16 the wgmma/TMA kernel,
    fp32 the FMA twin."""
    symbol = _ENTRY_SYMBOLS[kind]
    if dtype == torch.bfloat16:
        return SM90_SOURCE, symbol + "_sm90"
    return "flash_attention", symbol


def sm90_bucket(hd: int, lq: int | None = None, bh: int | None = None) -> int:
    """The index into SM90_BUCKETS the bf16 kernel launches for head dim
    hd, lq query rows and bh (image, head) pairs (None: a long sequence):
    hd rounded up into {48, 80, 128, 160, 256, 512}; where the default
    bucket's grid would leave the card short of work (1024 tokens at
    hd <= 48 or hd > 256), the bucket with more, smaller blocks."""
    short = lq is not None and bh is not None
    if hd <= 48:
        return 1 if short and -(-lq // 192) * bh < 2 * SM_COUNT else 0
    for i, kd in ((2, 80), (3, 128), (4, 160), (5, 256)):
        if hd <= kd:
            return i
    return 7 if short and -(-lq // 64) * bh * 2 < SM_COUNT else 6


def sm90_plan(hd: int, lq: int | None = None, bh: int | None = None,
              bucket: int | None = None) -> dict:
    """The bucket the bf16 kernel launches (`bucket`, else sm90_bucket's):
    Q K^T over kd columns (kd/16 k16 steps), P V over nv columns an output
    slice (`slices` of them cover hd), bkv keys a K/V tile, `consumers`
    warpgroups of 64 query rows, and its dynamic shared memory: Q, K and V
    in whole 64-column swizzle atoms, K/V in SM90_STAGES stages, the
    mbarriers and 1024 bytes of alignment."""
    if bucket is None:
        bucket = sm90_bucket(hd, lq, bh)
    kd, nv, bkv, consumers = SM90_BUCKETS[bucket]
    k_atoms, v_atoms = -(-kd // 64), -(-nv // 64)
    smem = (64 * consumers * 128 * k_atoms
            + SM90_STAGES * bkv * 128 * (k_atoms + v_atoms)
            + 8 * (1 + 3 * SM90_STAGES) + 1024)
    return dict(bucket=bucket, kd=kd, nv=nv, bkv=bkv, consumers=consumers,
                slices=-(-hd // nv), smem=smem)


def tma_describable(t, head_stride: int) -> bool:
    """Whether TMA can read `t` (B, L, ...) as (lanes, heads head_stride
    elements apart, L rows, B images): a 16-byte-aligned base, contiguous
    lanes, and head, row and image strides in whole 16 bytes (a stride over
    a dimension of one is never stepped)."""
    item = t.element_size()
    strides = [head_stride] + [t.stride(d) for d in (1, 0) if t.shape[d] > 1]
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st > 0 and st * item % 16 == 0 for st in strides))


def _check_tma(name, head_stride, *tensors):
    if not all(tma_describable(t, head_stride) for t in tensors):
        raise ValueError(f"{name}: TMA needs 16-byte-aligned bases and "
                         "head, row and image strides in whole 16 bytes "
                         f"(heads {head_stride} elements apart)")


# --- plain versions ---


def plain_attention(q, k, v, num_heads: int, scale: float | None = None):
    """(B, Lq, D) x (B, Lk, D) -> (B, Lq, D): scores in fp32, softmax in
    fp32, probabilities rounded to the input dtype for the second matmul."""
    head_dim = q.shape[-1] // num_heads
    if scale is None:
        scale = head_dim**-0.5
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    probs = torch.softmax(scores * scale, dim=-1)
    out = torch.matmul(probs.to(q.dtype), vh)
    return _merge_heads(out)


def _prescaled(qh, scale):
    """q * scale * log2(e), rounded to q's dtype: base-2 logits follow
    from Q K^T directly."""
    return (qh.float() * (scale * _LOG2E)).to(qh.dtype)


def _softmax_pv(qs, kh, vh, exp2_bf16: bool, block_bytes: int):
    """(B, H, Lq, hd) pre-scaled q against (B, H, Lk, hd) k, v -> fp32
    (B, H, Lq, hd), in query blocks of at most `block_bytes` of fp32
    scores. Row-max softmax in base 2; probabilities rounded to v's dtype
    (to bf16 first with exp2_bf16) for P V, the row sum in fp32 and the
    division after P V, as the TPU kernels order them."""
    B, H, Lq, _ = qs.shape
    Lk = kh.shape[2]
    kt, vf = kh.float().transpose(-1, -2), vh.float()
    rows = max(1, block_bytes // (4 * B * H * Lk))
    out = torch.empty(qs.shape, dtype=torch.float32, device=qs.device)
    for i in range(0, Lq, rows):
        s = torch.matmul(qs[:, :, i:i + rows].float(), kt)
        d = s - s.amax(-1, keepdim=True)
        e = torch.exp2(d.to(torch.bfloat16)) if exp2_bf16 else torch.exp2(d)
        l = e.float().sum(-1, keepdim=True)
        o = torch.matmul(e.to(vh.dtype).float(), vf)
        out[:, :, i:i + rows] = o / l
    return out


def plain_attention_streaming(q, k, v, num_heads: int,
                              scale: float | None = None,
                              block_bytes: int = 1 << 30):
    """K8's function, (B, Lq, D) x (B, Lk, D) -> (B, Lq, D), in query
    blocks so that no call materializes more than `block_bytes` of fp32
    scores (a 16384-token level-0 call would need 24 GiB at once)."""
    hd = q.shape[-1] // num_heads
    if scale is None:
        scale = hd**-0.5
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    out = _softmax_pv(_prescaled(qh, scale), kh, vh, False, block_bytes)
    return _merge_heads(out.to(q.dtype))


def _unslot(x, num_heads, head_dim):
    b, l, _ = x.shape
    return x.reshape(b, l, num_heads, SLOT)[..., :head_dim].transpose(1, 2)


def plain_attention_slotted(q, k, v, num_heads: int, head_dim: int,
                            scale: float | None = None,
                            block_bytes: int = 1 << 30):
    """K13's function over head-slotted (B, L, num_heads*128) tensors,
    each head's head_dim features first in its 128-lane slot: exp2 on bf16
    logits against the row max, bf16 probabilities. Returns the same
    layout with zero pad lanes."""
    if scale is None:
        scale = head_dim**-0.5
    qh, kh, vh = (_unslot(t, num_heads, head_dim) for t in (q, k, v))
    o = _softmax_pv(_prescaled(qh, scale), kh, vh, True, block_bytes)
    b, l = q.shape[:2]
    out = torch.zeros((b, l, num_heads, SLOT), dtype=q.dtype,
                      device=q.device)
    out[..., :head_dim] = o.transpose(1, 2).to(q.dtype)
    return out.reshape(b, l, num_heads * SLOT)


# --- kernels ---


def _check_qkv(name, q, k, v, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError(f"{name}: q, k, v must share bf16 or fp32 and one "
                        "device")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (B, L, D)")
    B, _, D = q.shape
    Lk = k.shape[1]
    if (D % num_heads or D // num_heads > MAX_FLASH_HEAD_DIM
            or k.shape != (B, Lk, D) or v.shape != k.shape):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"{num_heads} heads")


def flash_attention(q, k, v, num_heads: int, scale: float | None = None,
                    bucket: int | None = None):
    """Resident fused attention, (B, Lq, D) x (B, Lk, D) -> (B, Lq, D),
    K8's function (q pre-scaled and rounded): kernel K2 on CUDA, reading
    and writing the projections in place (bf16: csrc/flash_attention_sm90.cu,
    which needs hd a multiple of 8 and 16-byte-aligned bases, else
    ValueError; `bucket` overrides its plan's SM90_BUCKETS index, for
    probes; fp32: csrc/flash_attention.cu); plain_attention_streaming on
    CPU."""
    if q.device.type == "cpu":
        return plain_attention_streaming(q, k, v, num_heads, scale)
    return _launch_projections("resident", flash_launches, q, k, v,
                               num_heads, scale, bucket)


def flash_attention_streaming(q, k, v, num_heads: int,
                              scale: float | None = None):
    """Streaming fused attention for long sequences, (B, Lq, D) x
    (B, Lk, D) -> (B, Lq, D): kernel K8 on CUDA, reading and writing the
    projections in place (bf16: csrc/flash_attention_sm90.cu, which needs
    hd a multiple of 8 and 16-byte-aligned bases, else ValueError; fp32:
    csrc/flash_attention.cu); plain_attention_streaming on CPU."""
    if q.device.type == "cpu":
        return plain_attention_streaming(q, k, v, num_heads, scale)
    return _launch_projections("streaming", flash_streaming_launches, q, k,
                               v, num_heads, scale)


def _launch_projections(kind, counter, q, k, v, num_heads, scale,
                        bucket=None):
    """K2 ("resident") or K8 ("streaming") on contiguous CUDA projections."""
    name = {"resident": "flash_attention",
            "streaming": "flash_attention_streaming"}[kind]
    _check_qkv(name, q, k, v, num_heads)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    B, Lq, D = q.shape
    hd = D // num_heads
    if scale is None:
        scale = hd**-0.5
    source, symbol = kernel_entry(kind, q.dtype)
    args = [B, num_heads, Lq, k.shape[1], hd, float(scale * _LOG2E),
            int(q.dtype == torch.bfloat16)]
    argtypes = _STREAM_ARGTYPES
    if source == SM90_SOURCE:
        _check_tma(name, hd, q, k, v)
        if kind == "resident":
            args.append(-1 if bucket is None else bucket)
            argtypes = _RESIDENT_SM90_ARGTYPES
    out = torch.empty_like(q)
    fn = _cuda.function(source, symbol, argtypes)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              *args, _cuda.stream_of(q))
    _cuda.check(source, symbol, code)
    counter.record((tuple(q.shape), tuple(k.shape), num_heads), q.dtype)
    return out


def flash_attention_slotted(q, k, v, num_heads: int, head_dim: int,
                            scale: float | None = None):
    """Self-attention over head-slotted (B, L, num_heads*128) tensors,
    which may be views of one fused projection (rows any stride apart; k
    and v with equal strides). Returns (B, L, num_heads*128) with zero pad
    lanes. `head_dim` is the real head dim (the scale's and the lanes
    read). Kernel K13 on CUDA (bf16: csrc/flash_attention_sm90.cu, which
    needs 16-byte-aligned bases and row and image strides in whole 16
    bytes, else ValueError; fp32: csrc/flash_attention.cu),
    plain_attention_slotted on CPU."""
    if q.device.type == "cpu":
        return plain_attention_slotted(q, k, v, num_heads, head_dim, scale)
    name = "flash_attention_slotted"
    _check_qkv(name, q, k, v, num_heads)
    B, L, D = q.shape
    if D != num_heads * SLOT or not 0 < head_dim <= SLOT or k.shape[1] != L:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not {num_heads} "
                         f"slots of {SLOT} lanes for head dim {head_dim}, "
                         f"or k {tuple(k.shape)} is not self-attention")
    if (any(t.stride(-1) != 1 for t in (q, k, v))
            or k.stride() != v.stride()):
        raise ValueError(f"{name}: lanes must be contiguous and k, v share "
                         "strides")
    if scale is None:
        scale = head_dim**-0.5
    source, symbol = kernel_entry("slotted", q.dtype)
    if source == SM90_SOURCE:
        _check_tma(name, SLOT, q, k, v)
    out = torch.empty((B, L, D), dtype=q.dtype, device=q.device)
    fn = _cuda.function(source, symbol, _SLOT_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              num_heads, L, head_dim, SLOT, q.stride(1), q.stride(0),
              k.stride(1), k.stride(0), float(scale * _LOG2E),
              int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    _cuda.check(source, symbol, code)
    flash_slotted_launches.record((tuple(q.shape), num_heads, head_dim),
                                  q.dtype)
    return out


def attention(q, k, v, num_heads: int, scale: float | None = None):
    """Dispatching attention entry point used by all models. Inside the
    trainer's scope (ops/conv3x3.py conv_impl("plain"), the JAX package's
    conv_impl("xla"), which turns its flash route off) every call is
    plain_attention, the JAX xla_attention, on any device."""
    if current_impl() == "plain":
        return plain_attention(q, k, v, num_heads, scale)
    route = attention_route(q.shape[1], k.shape[1], q.shape[-1] // num_heads,
                            q.dtype)
    if route == "flash":
        return flash_attention(q, k, v, num_heads, scale)
    if route == "streaming":
        return flash_attention_streaming(q, k, v, num_heads, scale)
    return plain_attention(q, k, v, num_heads, scale)
