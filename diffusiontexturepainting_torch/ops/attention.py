"""Attention compute paths: (B, L, heads*hd) projections in and out.

Port of diffusiontexturepainting_tpu/ops/attention.py and
ops/flash_attention.py. `attention` keeps the JAX package's dispatch rule:
self-attention with Lq == Lk >= 1024 and head dim <= 512 goes to the fused
kernel (K2, csrc/flash_attention.cu, replacing flash_attention /
_attn_kernel); all other attention (the 14-token cross-attention, CLIP's 50
tokens, the UNet's shorter levels) is plain matmul -> fp32 softmax ->
matmul, as the JAX package's xla_attention.

The TPU kernel used a static-shift softmax; this port computes the exact
row-max softmax in both its kernel and its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

FLASH_MIN_Q_LEN = 1024
MAX_FLASH_HEAD_DIM = 512

flash_launches = _cuda.LaunchCounter("flash_attention")

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
             + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


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


def flash_attention(q, k, v, num_heads: int, scale: float | None = None):
    """Fused attention, (B, Lq, D) x (B, Lk, D) -> (B, Lq, D): kernel K2 on
    CUDA, plain_attention on CPU."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, num_heads, scale)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors must be on CPU or CUDA, "
                         f"got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise TypeError("flash_attention: q, k, v must share bf16 or fp32 "
                        "and one device")
    if (D % num_heads or hd > MAX_FLASH_HEAD_DIM or k.shape != (B, Lk, D)
            or v.shape != k.shape):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"{num_heads} heads")
    if scale is None:
        scale = hd**-0.5

    def heads(t, L):
        return _split_heads(t, num_heads).reshape(B * num_heads, L, hd) \
            .contiguous()

    qh, kh, vh = heads(q, Lq), heads(k, Lk), heads(v, Lk)
    out = torch.empty_like(qh)
    fn = _cuda.function("flash_attention", "dtp_flash_attention", _ARGTYPES)
    code = fn(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
              B * num_heads, Lq, Lk, hd, float(scale),
              int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    _cuda.check("flash_attention", "dtp_flash_attention", code)
    flash_launches.record((tuple(q.shape), tuple(k.shape), num_heads))
    return _merge_heads(out.reshape(B, num_heads, Lq, hd))


def uses_flash(lq: int, lk: int, head_dim: int) -> bool:
    """The JAX package's dispatch rule (ops/attention.py:95-101)."""
    return (lq >= FLASH_MIN_Q_LEN and lq == lk
            and head_dim <= MAX_FLASH_HEAD_DIM)


def attention(q, k, v, num_heads: int, scale: float | None = None):
    """Dispatching attention entry point used by all models."""
    if uses_flash(q.shape[1], k.shape[1], q.shape[-1] // num_heads):
        return flash_attention(q, k, v, num_heads, scale)
    return plain_attention(q, k, v, num_heads, scale)
