"""The UNet transformer's GEGLU feed-forward with its residual, one kernel.

Port of diffusiontexturepainting_tpu/ops/ff_geglu.py. Kernel K3 (replaces
_ff_geglu_pallas / _ff_kernel): in bf16 two warp-specialised wgmma/TMA
GEMMs with the GEGLU and the residual in their epilogues
(csrc/ff_geglu_sm90.cu; operands TMA cannot describe raise ValueError), in
fp32 csrc/ff_geglu.cu's FMA twin; a wrapper takes the plain version only
for a tensor on the CPU, and for a CUDA tensor it launches the kernel or
raises.

    out = residual + net_2(value * gelu(gate)),  [value | gate] = net_0(x)

The weights are the modules' own nn.Linear weights, (out, in): w0
(2*inner, C) with the value rows first, w2 (C, inner). GELU is the erf
form, as the module GEGLU and the JAX package's _reference compute it (the
Pallas kernel's default tanh form is a TPU speed trade).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _cuda

ff_geglu_launches = _cuda.LaunchCounter("ff_geglu")

_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,))
_SM90_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
                  + (ctypes.c_void_p,))
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# bf16 K3 (csrc/ff_geglu_sm90.cu) and what its plan reads of the H100
SM90_SOURCE = "ff_geglu_sm90"
SM_COUNT = 132
FF_BK, FF_BN, FF_IT = 64, 128, 64


def ff_geglu_plain(x, w0, b0, w2, b2, residual):
    """(N, C) tokens; port of ff_geglu._reference: the first projection and
    the gate in fp32, h rounded to x's dtype, the second projection
    accumulated in fp32, + b2 + residual in fp32, one rounding."""
    inner = w2.shape[1]
    h = x.float() @ w0.float().t() + b0.float()
    h = (h[:, :inner] * F.gelu(h[:, inner:])).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float()
    return (y + residual.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def ff_sm90_plan(N: int, C: int, inner: int, consumers: int | None = None,
                 splits: int | None = None) -> dict:
    """The two GEMMs bf16 K3 launches for (N, C) tokens and `inner`:
    `gate` (x w0^T and the GEGLU: CTAs of 64 * consumers tokens by 64
    inner columns, i_tiles x m_tiles of them) and `down` (h w2^T and the
    residual: 64 * consumers tokens by 128 channels, n_tiles x m_tiles x
    splits, K in `chunks` steps of 64, `per_split` a split). `gate` takes
    two consumer warpgroups where that grid gives every SM two CTAs,
    `down` where it fills the SMs once, else one (or as forced); `down`
    then splits its steps over as many CTAs as fill the SMs once (or as
    forced). Each CTA's ring: `stages` stages of A and B,
    `smem` bytes, two CTAs an SM. `work_floats`: the one buffer beside the
    output: h in bf16 (`h_floats`, whole 16 bytes), then the split tiles
    and counters. Cached: the dict is shared, read it only."""
    def m_tiles(nc):
        return -(-N // (64 * nc))

    def ring(nc):
        stages = 3 if nc == 2 else 4
        return stages, stages * (64 * nc * 128 + FF_BN * 128) + 16 * stages \
            + 16 + 1024

    i_tiles, n_tiles = -(-inner // FF_IT), -(-C // FF_BN)
    nc1 = consumers or (2 if m_tiles(2) * i_tiles >= 2 * SM_COUNT else 1)
    nc2 = consumers or (2 if m_tiles(2) * n_tiles >= SM_COUNT else 1)
    chunks = -(-inner // FF_BK)
    tiles = m_tiles(nc2) * n_tiles
    s = splits if splits else (1 if tiles >= SM_COUNT else SM_COUNT // tiles)
    s = min(s, chunks)
    per = -(-chunks // s)
    n_splits = -(-chunks // per)
    h_floats = (N * inner + 7) // 8 * 4
    stages1, smem1 = ring(nc1)
    stages2, smem2 = ring(nc2)
    return dict(
        gate=dict(consumers=nc1, m_tiles=m_tiles(nc1), i_tiles=i_tiles,
                  chunks=-(-C // FF_BK), stages=stages1, smem=smem1),
        down=dict(consumers=nc2, m_tiles=m_tiles(nc2), n_tiles=n_tiles,
                  chunks=chunks, splits=n_splits, per_split=per,
                  stages=stages2, smem=smem2),
        h_floats=h_floats,
        work_floats=h_floats + (tiles * n_splits * 64 * nc2 * FF_BN + tiles
                                if n_splits > 1 else 0))


def ff_tma_describable(x, w0, w2, residual) -> bool:
    """Whether bf16 K3 can take the operands: C and inner multiples of 8
    (rows of whole 16 bytes for TMA and the 16-byte epilogue rows) and
    16-byte-aligned bases of x, w0, w2 and the residual."""
    return (x.shape[1] % 8 == 0 and w2.shape[1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w0, w2, residual)))


def ff_geglu(x, w0, b0, w2, b2, residual):
    """residual + net_2(geglu(net_0(x))) over (N, C) tokens (kernel K3 on
    CUDA, ff_geglu_plain on CPU). w0 (2*inner, C), b0 (2*inner,),
    w2 (C, inner), b2 (C,), residual (N, C)."""
    return _ff_geglu(x, w0, b0, w2, b2, residual)


def _ff_geglu(x, w0, b0, w2, b2, residual, consumers=None, splits=None):
    """ff_geglu; in bf16 `consumers` 1 or 2 and `splits` force the sm90
    kernel's tiles and the second GEMM's split of K (the tests and
    tools/sm90_plans.py call this entry with them)."""
    if x.device.type == "cpu":
        return ff_geglu_plain(x, w0, b0, w2, b2, residual)
    if x.device.type != "cuda":
        raise ValueError(f"ff_geglu: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    N, C = x.shape
    inner = w2.shape[1]
    ops = (x, w0, b0, w2, b2, residual)
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError("ff_geglu: all operands must share bf16 or fp32, got "
                        f"{[t.dtype for t in ops]}")
    if (w0.shape != (2 * inner, C) or b0.shape != (2 * inner,)
            or w2.shape != (C, inner) or b2.shape != (C,)
            or residual.shape != (N, C)):
        raise ValueError(f"ff_geglu: bad shapes {[tuple(t.shape) for t in ops]}")
    for t in ops:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ff_geglu: operands must be contiguous on "
                             f"{x.device}")
    if x.dtype == torch.bfloat16:
        if not ff_tma_describable(x, w0, w2, residual):
            raise ValueError("ff_geglu: TMA needs C and inner multiples of 8 "
                             "and 16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, w2 {tuple(w2.shape)}")
        plan = ff_sm90_plan(N, C, inner, consumers, splits)
        out = torch.empty_like(x)
        # one allocation: h, then any split tiles and counters
        work = torch.empty(plan["work_floats"], dtype=torch.float32,
                           device=x.device)
        symbol = "dtp_ff_geglu_sm90"
        fn = _cuda.function(SM90_SOURCE, symbol, _SM90_ARGTYPES)
        code = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), residual.data_ptr(), out.data_ptr(),
                  work.data_ptr(), N, C, inner, consumers or 0, splits or 0,
                  _cuda.stream_of(x))
        _cuda.check(SM90_SOURCE, symbol, code)
        ff_geglu_launches.record((N, C, inner), x.dtype)
        return out
    # fp32: the FMA twin, its inner chunks' fp32 partials added in order
    ic = _cuda.function("ff_geglu", "dtp_ff_geglu_chunk",
                        (ctypes.c_int,) * 3)(N, inner, 0)
    chunks = -(-inner // ic)
    ws = torch.empty(chunks * N * C, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _cuda.function("ff_geglu", "dtp_ff_geglu", _ARGTYPES)
    code = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
              b2.data_ptr(), residual.data_ptr(), out.data_ptr(),
              ws.data_ptr(), N, C, inner, ic, 0, _cuda.stream_of(x))
    _cuda.check("ff_geglu", "dtp_ff_geglu", code)
    ff_geglu_launches.record((N, C, inner), x.dtype)
    return out
