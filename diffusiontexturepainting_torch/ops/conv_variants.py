"""The conv family's A/B arms, NHWC: the software-pipelined GroupNorm-SiLU-
conv prototype and the four tap reads of a resident window.

Port of the two conv experiments among the JAX repository's tools, named
after them so each counterpart is found:

  pipelined          T12 <- tools/bench_stream_pipeline.py pipelined /
                     _pipe_kernel
  conv_window_taps   T11 <- tools/bench_conv_shift_cost.py bench / _kernel

Each follows what the tool's code computes, which its docstring does not
always say:

  * T12 zero-pads x first and applies silu(x*a + c) to the padded tensor, so
    the border of the conv's input is silu(c), not 0 as in the served
    GroupNorm convs (ops/gn_conv.py, ops/conv3x3.py gn_silu_conv3x3). The
    prototype's limits (one Cout tile, H a multiple of its row tile) are
    not part of the function: any shape is computed.
  * T11's `unshifted` reads tap (0, 0) nine times (wrong on purpose);
    `rowflat` reads flat rows di*Wp + dj + h*W + w, the conv only where
    Wp == W; `jointw` (which the tool's main() never runs) clamps its
    di = 2 slice start to 2*Wp - 2, as jax.lax.dynamic_slice clamps a slice
    that overruns its operand, so that term reads two pixels early. All
    four add (reps - 1) * acc[0, 0, 0], the tool's loop carry, to every
    output element.

fp32 T12's and fp32 T11's kernels live in csrc/conv_arms.cu, over the
staged-window step shared with csrc/conv_staged.cu (csrc/conv_staged.cuh).
bf16 T12 runs the affine mode of csrc/gn_conv_sm90.cu's K1/K5 kernel
(dtp_gn_conv_pipelined_sm90): the prologue silu(x*a + c) in fp32 on every
staged window pixel, TMA's out-of-bounds zeros included, which are T12's
zero padding of x, so the border is silu(c); the conv + b in fp32, one
rounding; a Cout off 8 zero-padded here and the real columns stored, a
Cin off 8 or a base off 16 bytes refused with ValueError (TMA's 16-byte
rows). bf16 T11 runs csrc/window_taps_sm90.cu: with flat = a window as
((H_T+2) * Wp, Cin) rows, every read is out_flat[p] = sum_tap
flat[base(tap) + p] @ w[tap] at a pitch (W for rowflat, else Wp), one
row-shifted wgmma/TMA GEMM whose A boxes TMA brings one a di and whose
taps read them at row offset dj; an N off 8 is zero-padded here and the
real columns stored, a Cin off 8 raises ValueError (TMA's 16-byte rows).
A wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. No model and no served path
calls these.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda
from . import gn_conv
from .conv3x3 import _KERNEL_DTYPES, _ptr

pipelined_launches = _cuda.LaunchCounter("pipelined")
conv_window_taps_launches = _cuda.LaunchCounter("conv_window_taps")
LAUNCHES = {c.name: c for c in (pipelined_launches,
                                conv_window_taps_launches)}

# T11's tap reads, in the kernel's numbering
VARIANTS = ("shifted", "unshifted", "rowflat", "jointw")

_PIPE_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                  + (ctypes.c_void_p,))
_PIPE_SM90_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8
                       + (ctypes.c_void_p,))
_TAPS_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9
                  + (ctypes.c_void_p,))
_TAPS_SM90_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 11
                       + (ctypes.c_void_p,))


# --- plain versions ---


def plain_pipelined(x, a, c, w, b):
    """T12's function: x (B,H,W,Cin) zero-padded by one pixel on every
    side, then y = silu(xp*a + c) in fp32 with a, c (B,Cin) fp32, rounded
    to x's dtype (the pad pixels become silu(c)); the VALID 3x3 conv of y
    with w (3,3,Cin,Cout) in fp32, + b (Cout,) or None, rounded once:
    (B,H,W,Cout). (The tool pads further on the right, to a width multiple
    of 8 that no tap reads.)"""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    y = F.silu(xp * a.float()[:, None, None, :] + c.float()[:, None, None, :])
    y = y.to(x.dtype).float()
    out = F.conv2d(y.permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype).contiguous()


def _taps_shifted(xf, w9, H_T, W):
    """The VALID 3x3 conv: tap (di, dj) reads xwin[di:di+H_T, dj:dj+W]."""
    acc = 0.0
    for k in range(9):
        di, dj = divmod(k, 3)
        acc = acc + torch.matmul(xf[:, di:di + H_T, dj:dj + W], w9[k])
    return acc


def _taps_unshifted(xf, w9, H_T, W):
    """Every tap reads xwin[:H_T, :W]."""
    slab = xf[:, :H_T, :W]
    acc = 0.0
    for k in range(9):
        acc = acc + torch.matmul(slab, w9[k])
    return acc


def _taps_rowflat(xf, w9, H_T, W):
    """Tap (di, dj) reads flat rows [di*Wp + dj, + H_T*W) of the
    ((H_T+2)*Wp, Cin) flattening; the result reshaped at pitch W."""
    nwin, _, Wp, cin = xf.shape
    flat = xf.reshape(nwin, -1, cin)
    acc = 0.0
    for k in range(9):
        di, dj = divmod(k, 3)
        o = di * Wp + dj
        acc = acc + torch.matmul(flat[:, o:o + H_T * W], w9[k])
    return acc.reshape(nwin, H_T, W, -1)


def _taps_jointw(xf, w3, H_T, W):
    """w3 (3, 3*Cin, N). Per di: rows [start, + H_T*Wp + 2) of the
    flattening, start = di*Wp clamped to 2*Wp - 2 (the slice would overrun
    the window by 2 rows at di = 2); three one-row-shifted copies
    concatenated along channels, one product; the first W columns of each
    Wp-row kept."""
    nwin, rows, Wp, cin = xf.shape
    flat = xf.reshape(nwin, -1, cin)
    size = H_T * Wp + 2
    acc = 0.0
    for di in range(3):
        start = min(di * Wp, rows * Wp - size)
        sl = flat[:, start:start + size]
        cat = torch.cat([sl[:, k:k + H_T * Wp] for k in range(3)], dim=-1)
        acc = acc + torch.matmul(cat, w3[di])
    return acc.reshape(nwin, H_T, Wp, -1)[:, :, :W]


_PLAIN_TAPS = {"shifted": _taps_shifted, "unshifted": _taps_unshifted,
               "rowflat": _taps_rowflat, "jointw": _taps_jointw}


def _check_taps(xwin, w, variant, W, reps):
    if variant not in VARIANTS:
        raise ValueError(f"conv_window_taps: variant {variant!r} not in "
                         f"{VARIANTS}")
    if xwin.dim() != 4 or xwin.shape[1] < 3 or xwin.shape[2] < W + 2 \
            or W < 1:
        raise ValueError(f"conv_window_taps: xwin (nwin, H_T+2, Wp >= W+2, "
                         f"Cin), got {tuple(xwin.shape)} with W={W}")
    cin = xwin.shape[3]
    want = (3, 3 * cin) if variant == "jointw" else (9, cin)
    if w.dim() != 3 or tuple(w.shape[:2]) != want:
        raise ValueError(f"conv_window_taps: {variant} takes w "
                         f"{want + ('N',)}, got {tuple(w.shape)}")
    if reps < 1:
        raise ValueError(f"conv_window_taps: reps={reps} must be at least 1")


def plain_conv_window_taps(xwin, w, variant: str, *, W: int, reps: int = 1):
    """T11's function over xwin (nwin, H_T+2, Wp, Cin) and w (9, Cin, N),
    or (3, 3*Cin, N) for `jointw`: the nine products of `variant`'s tap
    read accumulated in fp32, then the tool's loop carry, acc[0, 0, 0] of
    each window added reps - 1 times one after the other, on every element;
    one rounding to xwin's dtype: (nwin, H_T, W, N)."""
    _check_taps(xwin, w, variant, W, reps)
    H_T = xwin.shape[1] - 2
    acc = _PLAIN_TAPS[variant](xwin.float(), w.float(), H_T, W)
    first = acc[:, 0, 0, 0]
    extra = torch.zeros_like(first)
    for _ in range(reps - 1):
        extra = extra + first
    return (acc + extra[:, None, None, None]).to(xwin.dtype).contiguous()


# --- kernels ---


def _check_operands(name, x, *others):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    for t in (x,) + tuple(t for t in others if t is not None):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{x.device}")


def pipelined(x, a, c, w, b):
    """T12: conv3x3_VALID(silu(pad(x)*a + c)) + b; kernel on CUDA,
    plain_pipelined on CPU. x (B,H,W,Cin); a, c (B,Cin), taken as fp32; w
    (3,3,Cin,Cout); b (Cout,) or None."""
    if x.device.type == "cpu":
        return plain_pipelined(x, a, c, w, b)
    return _pipelined(x, a, c, w, b)


def _pipelined(x, a, c, w, b, consumers=None, splits=None):
    """T12 on CUDA: in bf16 dtp_gn_conv_pipelined_sm90, the affine mode of
    csrc/gn_conv_sm90.cu with the plan of gn_conv.pipelined_sm90_plan
    (`consumers` 1 or 2 and `splits` force its tile and split of K: the
    tests and tools call this entry with them); in fp32
    dtp_gn_conv_pipelined of csrc/conv_arms.cu (the next channel chunk's
    copy and prologue issued before this chunk's taps)."""
    name = "pipelined"
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            3, 3, x.shape[3]):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype or (
            b is not None and b.dtype != x.dtype):
        raise TypeError(f"{name}: x, w and b must share bf16 or fp32, got "
                        f"{x.dtype}, {w.dtype}"
                        + ("" if b is None else f", {b.dtype}"))
    if tuple(a.shape) != (B, cin) or tuple(c.shape) != (B, cin) or (
            b is not None and tuple(b.shape) != (cout,)):
        raise ValueError(f"{name}: a, c must be {(B, cin)} and b {(cout,)}")
    a = a.float().contiguous()
    c = c.float().contiguous()
    _check_operands(name, x, a, c, w, b)
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        if not gn_conv.affine_tma_describable(x, w):
            raise ValueError(f"{name}: TMA needs Cin a multiple of 8 and "
                             "16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)}")
        wk, bk = gn_conv.pad_cout(w, b)
        plan = gn_conv.pipelined_sm90_plan(B, H, W, cin, wk.shape[3], cout,
                                           consumers, splits)
        work = (torch.empty(plan["work_floats"], dtype=torch.float32,
                            device=x.device) if plan["work_floats"] else None)
        source, symbol = gn_conv.GN_SM90_SOURCE, "dtp_gn_conv_pipelined_sm90"
        fn = _cuda.function(source, symbol, _PIPE_SM90_ARGTYPES)
        code = fn(x.data_ptr(), a.data_ptr(), c.data_ptr(), wk.data_ptr(),
                  _ptr(bk), out.data_ptr(), _ptr(work), B, H, W, cin,
                  wk.shape[3], cout, consumers or 0, splits or 0,
                  _cuda.stream_of(x))
    else:
        source, symbol = "conv_arms", "dtp_gn_conv_pipelined"
        fn = _cuda.function(source, symbol, _PIPE_ARGTYPES)
        code = fn(x.data_ptr(), a.data_ptr(), c.data_ptr(), w.data_ptr(),
                  _ptr(b), out.data_ptr(), B, H, W, cin, cout, 0,
                  _cuda.stream_of(x))
    _cuda.check(source, symbol, code)
    pipelined_launches.record((tuple(x.shape), tuple(w.shape),
                               b is not None))
    return out


def taps_tma_describable(xwin, w) -> bool:
    """Whether TMA can read bf16 T11's operands: Cin a multiple of 8
    (rows of whole 16 bytes) and 16-byte-aligned bases (an N off 8 is
    zero-padded by the wrapper)."""
    return (xwin.shape[-1] % 8 == 0 and xwin.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


def conv_window_taps(xwin, w, variant: str, *, W: int, reps: int = 1):
    """T11: the nine-tap product over resident windows with `variant`'s
    tap read, `reps` passes; kernel on CUDA (bf16: dtp_conv_window_taps_sm90
    of csrc/window_taps_sm90.cu; fp32: dtp_conv_window_taps of
    csrc/conv_arms.cu; the carry added in the epilogue),
    plain_conv_window_taps on CPU. xwin (nwin, H_T+2, Wp, Cin) with Wp >=
    W + 2; w (9, Cin, N), or (3, 3*Cin, N) for `jointw`; returns (nwin,
    H_T, W, N)."""
    if xwin.device.type == "cpu":
        return plain_conv_window_taps(xwin, w, variant, W=W, reps=reps)
    return _conv_window_taps(xwin, w, variant, W=W, reps=reps)


def _conv_window_taps(xwin, w, variant, *, W, reps=1, consumers=None,
                      splits=None):
    """T11 on CUDA; in bf16 `consumers` 1 or 2 and `splits` force the sm90
    kernel's tile and split of K (the tests and tools/sm90_plans.py call
    this entry with them)."""
    name = "conv_window_taps"
    _check_taps(xwin, w, variant, W, reps)
    if xwin.dtype not in _KERNEL_DTYPES or w.dtype != xwin.dtype:
        raise TypeError(f"{name}: xwin and w must share bf16 or fp32, got "
                        f"{xwin.dtype} and {w.dtype}")
    _check_operands(name, xwin, w)
    nwin, rows, Wp, cin = xwin.shape
    n = w.shape[2]
    out = torch.empty((nwin, rows - 2, W, n), dtype=xwin.dtype,
                      device=xwin.device)
    if xwin.dtype == torch.bfloat16:
        if not taps_tma_describable(xwin, w):
            raise ValueError(f"{name}: TMA needs Cin a multiple of 8 and "
                             "16-byte-aligned bases, got xwin "
                             f"{tuple(xwin.shape)}, w {tuple(w.shape)}")
        wk = F.pad(w, (0, -n % 8)) if n % 8 else w
        plan = gn_conv.taps_sm90_plan(nwin, rows - 2, W, Wp, cin,
                                      wk.shape[2], variant, consumers, splits)
        work = (torch.empty(plan["work_floats"], dtype=torch.float32,
                            device=xwin.device)
                if plan["work_floats"] else None)
        source, symbol = gn_conv.TAPS_SM90_SOURCE, "dtp_conv_window_taps_sm90"
        fn = _cuda.function(source, symbol, _TAPS_SM90_ARGTYPES)
        code = fn(xwin.data_ptr(), wk.data_ptr(), out.data_ptr(), _ptr(work),
                  nwin, rows - 2, W, Wp, cin, wk.shape[2], n,
                  VARIANTS.index(variant), int(reps), consumers or 0,
                  splits or 0, _cuda.stream_of(xwin))
    else:
        source, symbol = "conv_arms", "dtp_conv_window_taps"
        fn = _cuda.function(source, symbol, _TAPS_ARGTYPES)
        code = fn(xwin.data_ptr(), w.data_ptr(), out.data_ptr(), nwin,
                  rows - 2, W, Wp, cin, n, VARIANTS.index(variant),
                  int(reps), 0, _cuda.stream_of(xwin))
    _cuda.check(source, symbol, code)
    conv_window_taps_launches.record((tuple(xwin.shape), tuple(w.shape),
                                      variant, int(W), int(reps)))
    return out
