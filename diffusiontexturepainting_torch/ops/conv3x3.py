"""3x3 stride-1 SAME convolution and the fused x2-upsample convolution, NHWC.

Port of diffusiontexturepainting_tpu/ops/conv3x3.py. Each op has a kernel
written for Hopper (csrc/conv3x3.cu) and a plain PyTorch version beside it:
a wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

  conv3x3             kernel K7 (replaces _conv3x3_pallas / _conv_kernel)
  upsample2x_conv3x3  kernel K4 (replaces _upconv_pallas /
                      _upconv_kernel_padded)

Weights are HWIO (3, 3, Cin, Cout), as in the JAX package; the bias has the
activations' dtype and is added in fp32. The upsample kernel takes the
weights folded into 16 2x2 taps (fold_upsample_weights), which a module
does once at parameter load.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda

conv3x3_launches = _cuda.LaunchCounter("conv3x3")
upsample_launches = _cuda.LaunchCounter("upsample2x_conv3x3")

_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
             + (ctypes.c_void_p,))
_SPLIT_ARGTYPES = (ctypes.c_int,) * 6
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def conv3x3_plain(x, w, b):
    """(B,H,W,Cin) x (3,3,Cin,Cout) -> (B,H,W,Cout) in x's dtype; the bias
    is added in fp32 (as the JAX package's _lax_conv3x3)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    y = (y.permute(0, 2, 3, 1).float() + b.float()).to(x.dtype)
    return y.contiguous()


def fold_upsample_weights(w):
    """(3,3,Cin,Cout) -> (16,Cin,Cout) folded 2x2 taps, index
    [((ry*2+rx)*2+ai)*2+bi]; summed in fp32, rounded once to w's dtype.

    conv3x3(nearest_x2(x)) at output parity (ry, rx) reads source rows
    y + floor((ry+di-1)/2), which takes two values per parity, so the taps
    landing on one source pixel fold by summing their weights: parity 0 ->
    {w0 | w1+w2}, parity 1 -> {w0+w1 | w2}; columns alike."""
    sel = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}
    wf = w.float()
    planes = []
    for ry in (0, 1):
        for rx in (0, 1):
            for ais in sel[ry]:
                for bjs in sel[rx]:
                    planes.append(sum(wf[di, dj] for di in ais for dj in bjs))
    return torch.stack(planes).to(w.dtype).contiguous()


def upsample2x_conv3x3_plain(x, w, b):
    """Nearest x2 upsample, then conv3x3_plain: (B,H,W,Cin) -> (B,2H,2W,Cout)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv3x3_plain(up, w, b)


def _check(name, x, w, b, taps):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError(f"{name}: x, w and b must share bf16 or fp32, got "
                        f"{x.dtype}, {w.dtype} and {b.dtype}")
    if x.dim() != 4 or w.shape[-2] != x.shape[-1] or w.shape[:-2] != taps \
            or b.shape != (w.shape[-1],):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    for t in (x, w, b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{x.device}")


def _launch(symbol, x, w, b, out):
    """Launch one conv entry point of csrc/conv3x3.cu on x's stream, with
    the fp32 split-K workspace the kernel asks for."""
    B, H, W, cin = x.shape
    cout = out.shape[-1]
    bf16 = int(x.dtype == torch.bfloat16)
    splits = _cuda.function("conv3x3", f"{symbol}_splits", _SPLIT_ARGTYPES)(
        B, H, W, cin, cout, bf16)
    partial = (torch.empty(splits * out.numel(), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _cuda.function("conv3x3", symbol, _ARGTYPES)
    code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
              None if partial is None else partial.data_ptr(), B, H, W, cin,
              cout, splits, bf16, _cuda.stream_of(x))
    _cuda.check("conv3x3", symbol, code)


def conv3x3(x, w, b):
    """3x3 stride-1 SAME conv, NHWC, fp32 accumulation, bias added in fp32,
    one rounding to x's dtype (kernel K7 on CUDA, conv3x3_plain on CPU)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b)
    _check("conv3x3", x, w, b, (3, 3))
    B, H, W, _ = x.shape
    out = torch.empty((B, H, W, w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    _launch("dtp_conv3x3", x, w, b, out)
    conv3x3_launches.record((tuple(x.shape), tuple(w.shape)))
    return out


def upsample2x_conv3x3(x, w, b, taps):
    """conv3x3(nearest_x2(x)), NHWC: (B,H,W,Cin) -> (B,2H,2W,Cout).

    w: (3,3,Cin,Cout), read by the plain repeat + conv on CPU; taps: the
    same weights through fold_upsample_weights, read by kernel K4 on
    CUDA."""
    if x.device.type == "cpu":
        return upsample2x_conv3x3_plain(x, w, b)
    _check("upsample2x_conv3x3", x, taps, b, (16,))
    B, H, W, cin = x.shape
    cout = taps.shape[-1]
    out = torch.empty((B, 2 * H, 2 * W, cout), dtype=x.dtype,
                      device=x.device)
    _launch("dtp_upsample2x_conv3x3", x, taps, b, out)
    upsample_launches.record((tuple(x.shape), (3, 3, cin, cout)))
    return out
