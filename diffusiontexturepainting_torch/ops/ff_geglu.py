"""The UNet transformer's GEGLU feed-forward with its residual, one kernel.

Port of diffusiontexturepainting_tpu/ops/ff_geglu.py. Kernel K3
(csrc/ff_geglu.cu, replaces _ff_geglu_pallas / _ff_kernel); a wrapper takes
the plain version only for a tensor on the CPU, and for a CUDA tensor it
launches the kernel or raises.

    out = residual + net_2(value * gelu(gate)),  [value | gate] = net_0(x)

The weights are the modules' own nn.Linear weights, (out, in): w0
(2*inner, C) with the value rows first, w2 (C, inner). GELU is the erf
form, as the module GEGLU and the JAX package's _reference compute it (the
Pallas kernel's default tanh form is a TPU speed trade).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda

ff_geglu_launches = _cuda.LaunchCounter("ff_geglu")

_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,))
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def ff_geglu_plain(x, w0, b0, w2, b2, residual):
    """(N, C) tokens; port of ff_geglu._reference: the first projection and
    the gate in fp32, h rounded to x's dtype, the second projection
    accumulated in fp32, + b2 + residual in fp32, one rounding."""
    inner = w2.shape[1]
    h = x.float() @ w0.float().t() + b0.float()
    h = (h[:, :inner] * F.gelu(h[:, inner:])).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float()
    return (y + residual.float()).to(x.dtype)


def ff_geglu(x, w0, b0, w2, b2, residual):
    """residual + net_2(geglu(net_0(x))) over (N, C) tokens (kernel K3 on
    CUDA, ff_geglu_plain on CPU). w0 (2*inner, C), b0 (2*inner,),
    w2 (C, inner), b2 (C,), residual (N, C)."""
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
    bf16 = int(x.dtype == torch.bfloat16)
    ic = _cuda.function("ff_geglu", "dtp_ff_geglu_chunk",
                        (ctypes.c_int,) * 3)(N, inner, bf16)
    splits = -(-inner // ic)
    ws = torch.empty(splits * N * C, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _cuda.function("ff_geglu", "dtp_ff_geglu", _ARGTYPES)
    code = fn(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w2.data_ptr(),
              b2.data_ptr(), residual.data_ptr(), out.data_ptr(),
              ws.data_ptr(), N, C, inner, ic, bf16, _cuda.stream_of(x))
    _cuda.check("ff_geglu", "dtp_ff_geglu", code)
    ff_geglu_launches.record((N, C, inner))
    return out
