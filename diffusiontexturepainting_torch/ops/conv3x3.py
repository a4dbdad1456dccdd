"""3x3 stride-1 SAME convolution, the fused x2-upsample convolution and the
fused GroupNorm -> SiLU -> 3x3 convolution, NHWC.

Port of diffusiontexturepainting_tpu/ops/conv3x3.py. Each op has a kernel
written for Hopper and a plain PyTorch version beside it: a wrapper takes
the plain version only for a tensor on the CPU or inside the trainer's
scope, conv_impl("plain"); otherwise, for a CUDA tensor, it launches the
kernel or raises.

  conv3x3             kernel K7 (replaces _conv3x3_pallas / _conv_kernel):
                      in bf16 the PLAIN mode of csrc/gn_conv_sm90.cu's
                      K1/K5 kernel (A read straight from the TMA-staged
                      windows, wgmma; operands TMA cannot describe raise
                      ValueError), in fp32 csrc/conv3x3.cu; with _IN_PAD,
                      conv3x3_inpad
  upsample2x_conv3x3  kernel K4 (replaces _upconv_pallas /
                      _upconv_kernel_padded): in bf16 the four parity
                      planes over one TMA-staged window on wgmma
                      (csrc/gn_conv_sm90.cu's upsample mode; operands TMA
                      cannot describe raise ValueError), in fp32
                      csrc/conv3x3.cu; with _IN_PAD,
                      upsample2x_conv3x3_inpad
  conv3x3_inpad       kernel K12a (replaces _conv_kernel_inpad): K7's
                      function and, in bf16, K7's launch, counted apart
                      (TMA's out-of-bounds zeros are the on-chip padding);
                      in fp32 csrc/conv_staged.cu's staged-tile FMA twin
  upsample2x_conv3x3_inpad
                      kernel K12b (replaces _upconv_kernel): K4's function
                      and, in bf16, K4's launch, counted apart (TMA's
                      out-of-bounds zeros are the on-chip padding); in
                      fp32 csrc/conv_staged.cu's staged-tile UP mode
  conv3x3_stream      kernel K11 (replaces _conv3x3_stream /
                      _conv_stream_kernel): as K12a, counted apart (TMA's
                      windows are the streamed rows)
  gn_silu_conv3x3     kernel K10 (replaces gn_silu_conv3x3 /
                      _gn_conv_kernel): csrc/moments.cu's statistics pass,
                      then in bf16 the affine mode of csrc/gn_conv_sm90.cu's
                      K1/K5 kernel (the GroupNorm folded in the CTA, the
                      prologue and the epilogue in fp32, one rounding each;
                      operands TMA cannot describe raise ValueError, a
                      Cout off 8 is zero-padded and the real channels
                      stored), in fp32 csrc/conv_staged.cu's staged-tile GN
                      mode

The staged-tile modes stage each block's input window with its halo in
shared memory once per channel chunk and read all taps from there; K7's
PLAIN mode and K4's upsample mode have TMA bring each chunk's window with
its halo, zeros outside the image: both are the counterpart of the TPU
kernels' VMEM padding (K12) and row window (K11). The TPU's VMEM budgets
(the in-pad size gate, streaming_plan) do not apply: every shape goes to
the kernel, and bf16 K7, K4, K12a, K12b and K11 refuse only what TMA
cannot describe (Cin or Cout off a multiple of 8, a base off 16 bytes).

Weights are HWIO (3, 3, Cin, Cout), as in the JAX package; the bias has the
activations' dtype and is added in fp32. The upsample kernel takes the
weights folded into 16 2x2 taps (fold_upsample_weights), which a module
does once at parameter load.
"""

from __future__ import annotations

import contextvars
import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _cuda
from .groupnorm import (
    gn_affine_from_stats,
    launch_moments,
    spatial_moments_plain,
)

conv3x3_launches = _cuda.LaunchCounter("conv3x3")
upsample_launches = _cuda.LaunchCounter("upsample2x_conv3x3")
conv3x3_inpad_launches = _cuda.LaunchCounter("conv3x3_inpad")
upsample_inpad_launches = _cuda.LaunchCounter("upsample2x_conv3x3_inpad")
conv3x3_stream_launches = _cuda.LaunchCounter("conv3x3_stream")
gn_silu_conv3x3_launches = _cuda.LaunchCounter("gn_silu_conv3x3")

# The JAX package's switch of the same name: conv3x3 and upsample2x_conv3x3
# take the in-kernel-padding kernels (K12a/b) when it is True. Read at call
# time; off by default, as there. It changes only the CUDA route: on the
# CPU both settings run the plain versions.
_IN_PAD = False

# The trainer's scope (the JAX package's conv_impl("xla"), ops/conv3x3.py
# there): inside conv_impl("plain") every wrapper of this module and of
# gn_conv.py, and attention(), takes its plain version for a CUDA tensor
# too, so a training step differentiates plain PyTorch ops with their
# native autograd and launches no kernel (none of them has a backward).
# This is the JAX trainer's own design, not a fallback: serving never
# enters the scope (its stamp and brush encode raise inside it,
# require_kernels), and outside it a CUDA tensor launches its kernel or
# raises as before. A ContextVar, so the scope is per thread and a serving
# thread is never affected.
_IMPL = contextvars.ContextVar("conv_impl", default=None)


def current_impl():
    """The scoped dispatch override: None (each wrapper's own rule) or
    "plain"."""
    return _IMPL.get()


class conv_impl:
    """`with conv_impl(impl):` a scope in which the kernel wrappers take
    their plain versions (`impl` "plain") or their own rule (None); the
    previous setting comes back on leaving it, however it is left. Nothing
    inside counts as a launch."""

    def __init__(self, impl):
        if impl not in (None, "plain"):
            raise ValueError(f"conv_impl: {impl!r} is not None or 'plain'")
        self.impl = impl

    def __enter__(self):
        self._token = _IMPL.set(self.impl)

    def __exit__(self, *exc_info):
        _IMPL.reset(self._token)


def require_kernels(caller: str) -> None:
    """Raises inside conv_impl("plain"): a served path (`caller`) runs its
    kernels, so the trainer's scope must never reach it."""
    if _IMPL.get() == "plain":
        raise RuntimeError(f"{caller}: called inside conv_impl('plain'), the "
                           "training step's scope; serving runs its kernels")


def plain_route(x) -> bool:
    """Whether a wrapper takes its plain version: x on the CPU, or inside
    conv_impl("plain")."""
    return x.device.type == "cpu" or _IMPL.get() == "plain"

_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
             + (ctypes.c_void_p,))
_SPLIT_ARGTYPES = (ctypes.c_int,) * 6
_STAGED_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                    + (ctypes.c_void_p,))
_GN_STAGED_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_float,)
                       + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
_GN_SILU_SM90_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_float,)
                          + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))
_UP_SM90_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
                     + (ctypes.c_void_p,))
_SAME_SM90_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7
                       + (ctypes.c_void_p,))
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


# (parity, fold index) of each index k of the 4x4 transposed-conv kernel,
# per axis: k = 0 (1, 1), 1 (0, 1), 2 (1, 0), 3 (0, 0)
_TRANSPOSED_TAP = ((1, 1), (0, 1), (1, 0), (0, 0))


def transposed_upsample_weight(taps):
    """(16,Cin,Cout) folded taps -> the (Cin,Cout,4,4) weight W4 with
    F.conv_transpose2d(x, W4, stride=2, padding=1) == conv3x3(nearest_x2(x))
    (NCHW): output row 2y+ry reads source rows y-1, y (ry 0) or y, y+1
    (ry 1), the transposed conv's kernel index k = 2(y - i) + ry + 1. The
    one PyTorch call computing K4's (and, without statistics, K6's and
    K12b's) function: a yardstick, which the port never calls."""
    cin, cout = taps.shape[1:]
    w4 = taps.new_empty((cin, cout, 4, 4))
    for kh, (ry, ai) in enumerate(_TRANSPOSED_TAP):
        for kw, (rx, bi) in enumerate(_TRANSPOSED_TAP):
            w4[:, :, kh, kw] = taps[((ry * 2 + rx) * 2 + ai) * 2 + bi]
    return w4


def gn_silu_conv3x3_plain(x, scale, bias, w, b, temb=None, residual=None,
                          num_groups=32, eps=1e-5):
    """GroupNorm(scale, bias) -> SiLU -> 3x3 SAME conv(w, b) [+ temb
    (B, Cout)] [+ residual (B, H, W, Cout)], NHWC (port of the JAX
    package's _gn_conv_reference with gn_affine_params, in the order of its
    kernel _gn_conv_kernel): the statistics and the affine a, c in fp32
    (E[x^2] - E[x]^2 per group), v = silu(x*a + c) in fp32 rounded once to
    x's dtype, the conv of v accumulated in fp32, then the bias, temb and
    residual added in fp32 and one rounding. (_gn_conv_reference rounds
    the conv + bias before adding temb and residual, one rounding more.)"""
    B, H, W, _ = x.shape
    a, c = gn_affine_from_stats(spatial_moments_plain(x), scale, bias,
                                num_groups, H * W, eps)
    v = F.silu(x.float() * a[:, None, None, :] + c[:, None, None, :])
    v = v.to(x.dtype).float()
    y = F.conv2d(v.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if temb is not None:
        y = y + temb.float()[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype).contiguous()


def _check(name, x, w, b, taps, optional=()):
    """Device, dtype, shape and layout of a kernel call's operands; b and
    the `optional` (tensor, shape) pairs may be None."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got "
                         f"{x.device}")
    cout = w.shape[-1]
    pairs = (((b, (cout,)),) if b is not None else ()) + tuple(
        (t, shape) for t, shape in optional if t is not None)
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype or any(
            t.dtype != x.dtype for t, _ in pairs):
        raise TypeError(f"{name}: operands must share bf16 or fp32, got "
                        f"x {x.dtype}, w {w.dtype}, "
                        + ", ".join(str(t.dtype) for t, _ in pairs))
    if x.dim() != 4 or w.shape[-2] != x.shape[-1] or w.shape[:-2] != taps \
            or any(tuple(t.shape) != shape for t, shape in pairs):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, "
                         + ", ".join(f"{tuple(t.shape)} (want {shape})"
                                     for t, shape in pairs))
    for t in (x, w) + tuple(t for t, _ in pairs):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on "
                             f"{x.device}")


def _launch(symbol, x, w, b, out):
    """Launch one fp32 conv entry point of csrc/conv3x3.cu on x's stream,
    with the split-K workspace the kernel asks for."""
    B, H, W, cin = x.shape
    cout = out.shape[-1]
    splits = _cuda.function("conv3x3", f"{symbol}_splits", _SPLIT_ARGTYPES)(
        B, H, W, cin, cout, 0)
    partial = (torch.empty(splits * out.numel(), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = _cuda.function("conv3x3", symbol, _ARGTYPES)
    code = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
              None if partial is None else partial.data_ptr(), B, H, W, cin,
              cout, splits, 0, _cuda.stream_of(x))
    _cuda.check("conv3x3", symbol, code)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_staged(symbol, x, w, b, out):
    """Launch an entry point of csrc/conv_staged.cu without a prologue."""
    B, H, W, cin = x.shape
    fn = _cuda.function("conv_staged", symbol, _STAGED_ARGTYPES)
    code = fn(x.data_ptr(), w.data_ptr(), _ptr(b), out.data_ptr(), B, H, W,
              cin, out.shape[-1], int(x.dtype == torch.bfloat16),
              _cuda.stream_of(x))
    _cuda.check("conv_staged", symbol, code)


def _same_conv(name, x, w, b, counter, fp32, consumers=None, splits=None):
    """One 3x3 SAME conv + bias of a CUDA tensor, counted on `counter`: in
    bf16 dtp_conv3x3_sm90, the PLAIN mode of csrc/gn_conv_sm90.cu with the
    plan of gn_conv.same_sm90_plan (`consumers` 1 or 2 and `splits` force
    its tile and split of K); in fp32 `fp32(x, w, b, out)`, the caller's
    FMA twin. K7, K12a and K11 compute this one function and share this
    launch; operands TMA cannot describe raise ValueError before it."""
    _check(name, x, w, b, (3, 3))
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        from . import gn_conv

        if not gn_conv.upconv_tma_describable(x, w):
            raise ValueError(f"{name}: TMA needs Cin and Cout multiples of "
                             "8 and 16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)}")
        symbol = "dtp_conv3x3_sm90"
        fn = _cuda.function(gn_conv.GN_SM90_SOURCE, symbol,
                            _SAME_SM90_ARGTYPES)
        plan_of = lambda n: gn_conv.same_sm90_plan(n, H, W, cin, cout,
                                                   consumers, splits)

        def launch(b0, n):
            work = _work(plan_of(n), x.device)
            code = fn(_cuda.offset_ptr(x, b0), w.data_ptr(), _ptr(b),
                      _cuda.offset_ptr(out, b0), _ptr(work), n, H, W, cin,
                      cout, consumers or 0, splits or 0, _cuda.stream_of(x))
            _cuda.check(gn_conv.GN_SM90_SOURCE, symbol, code)

        # a batch whose tiles overflow the grid runs as several launches
        _cuda.launch_by_runs(B, lambda n: plan_of(n)["m_tiles"], launch,
                             counter, (tuple(x.shape), tuple(w.shape)),
                             x.dtype)
        return out
    fp32(x, w, b, out)
    counter.record((tuple(x.shape), tuple(w.shape)), x.dtype)
    return out


def _work(plan, device):
    """The sm90 PLAIN and upsample modes' work buffer (split tiles and
    counters), None where the plan needs none."""
    return (torch.empty(plan["work_floats"], dtype=torch.float32,
                        device=device) if plan["work_floats"] else None)


# fp32 K12a and K11: the staged-tile FMA twin (csrc/conv_staged.cu)
_staged_fp32 = functools.partial(_launch_staged, "dtp_conv3x3_staged")


def conv3x3_inpad(x, w, b):
    """conv3x3 with SAME padding done on chip (kernel K12a on CUDA), what
    conv3x3 runs under _IN_PAD: in bf16 K7's launch, where TMA's
    out-of-bounds zeros are the padding, counted apart; in fp32 the
    staged-tile FMA twin of csrc/conv_staged.cu."""
    if plain_route(x):
        return conv3x3_plain(x, w, b)
    return _same_conv("conv3x3_inpad", x, w, b, conv3x3_inpad_launches,
                      _staged_fp32)


def conv3x3_stream(x, w, b):
    """conv3x3 through row windows with halo staged on chip (kernel K11 on
    CUDA): in bf16 K7's launch, whose TMA windows are the streamed rows,
    counted apart; in fp32 the staged-tile FMA twin. No plan of its own:
    the TPU's streaming_plan is a VMEM budget."""
    if plain_route(x):
        return conv3x3_plain(x, w, b)
    return _same_conv("conv3x3_stream", x, w, b, conv3x3_stream_launches,
                      _staged_fp32)


def conv3x3(x, w, b):
    """3x3 stride-1 SAME conv, NHWC, fp32 accumulation, bias added in fp32,
    one rounding to x's dtype (kernel K7 on CUDA, or K12a under _IN_PAD;
    conv3x3_plain on CPU)."""
    if plain_route(x):
        return conv3x3_plain(x, w, b)
    if _IN_PAD:
        return conv3x3_inpad(x, w, b)
    return _conv3x3(x, w, b)


def _conv3x3(x, w, b, consumers=None, splits=None):
    """K7 on CUDA (conv3x3 with _IN_PAD off); in bf16 `consumers` 1 or 2
    and `splits` force the sm90 kernel's tile and split of K (the tests and
    tools/sm90_plans.py call this entry with them)."""
    return _same_conv("conv3x3", x, w, b, conv3x3_launches,
                      functools.partial(_launch, "dtp_conv3x3"), consumers,
                      splits)


def upsample2x_conv3x3(x, w, b, taps):
    """conv3x3(nearest_x2(x)), NHWC: (B,H,W,Cin) -> (B,2H,2W,Cout).

    w: (3,3,Cin,Cout), read by the plain repeat + conv on CPU; taps: the
    same weights through fold_upsample_weights, read by kernel K4 (K12b
    under _IN_PAD) on CUDA."""
    if plain_route(x):
        return upsample2x_conv3x3_plain(x, w, b)
    if _IN_PAD:
        return upsample2x_conv3x3_inpad(x, w, b, taps)
    return _upsample2x_conv3x3(x, b, taps)


def _upconv(name, x, b, taps, counter, fp32, splits=None):
    """One nearest-x2 upsample + 3x3 conv + bias of a CUDA tensor over the
    folded taps, counted on `counter`: in bf16 dtp_upsample2x_conv3x3_sm90,
    the upsample mode of csrc/gn_conv_sm90.cu with the plan of
    gn_conv.upconv_sm90_plan (`splits` forces its split of K); in fp32
    `fp32(x, taps, b, out)`, the caller's FMA twin. K4 and K12b compute
    this one function and share this launch; operands TMA cannot describe
    raise ValueError before it."""
    _check(name, x, taps, b, (16,))
    B, H, W, cin = x.shape
    cout = taps.shape[-1]
    out = torch.empty((B, 2 * H, 2 * W, cout), dtype=x.dtype,
                      device=x.device)
    if x.dtype == torch.bfloat16:
        from . import gn_conv

        if not gn_conv.upconv_tma_describable(x, taps):
            raise ValueError(f"{name}: TMA needs Cin and Cout multiples of "
                             "8 and 16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, taps {tuple(taps.shape)}")
        symbol = "dtp_upsample2x_conv3x3_sm90"
        fn = _cuda.function(gn_conv.GN_SM90_SOURCE, symbol, _UP_SM90_ARGTYPES)
        plan_of = lambda n: gn_conv.upconv_sm90_plan(n, H, W, cin, cout,
                                                     splits)

        def launch(b0, n):
            work = _work(plan_of(n), x.device)
            code = fn(_cuda.offset_ptr(x, b0), taps.data_ptr(), _ptr(b),
                      _cuda.offset_ptr(out, b0), _ptr(work), n, H, W, cin,
                      cout, splits or 0, _cuda.stream_of(x))
            _cuda.check(gn_conv.GN_SM90_SOURCE, symbol, code)

        # a batch whose tiles overflow the grid runs as several launches
        _cuda.launch_by_runs(B, lambda n: plan_of(n)["m_tiles"], launch,
                             counter, (tuple(x.shape), (3, 3, cin, cout)),
                             x.dtype)
        return out
    fp32(x, taps, b, out)
    counter.record((tuple(x.shape), (3, 3, cin, cout)), x.dtype)
    return out


def _upsample2x_conv3x3(x, b, taps, splits=None):
    """K4 on CUDA (upsample2x_conv3x3 with _IN_PAD off); in bf16 `splits`
    forces the sm90 kernel's split of K (the tests and tools/sm90_plans.py
    call this entry with it)."""
    return _upconv("upsample2x_conv3x3", x, b, taps, upsample_launches,
                   functools.partial(_launch, "dtp_upsample2x_conv3x3"),
                   splits)


def upsample2x_conv3x3_inpad(x, w, b, taps):
    """upsample2x_conv3x3 with SAME padding done on chip (kernel K12b on
    CUDA), what upsample2x_conv3x3 runs under _IN_PAD: in bf16 K4's launch,
    where TMA's out-of-bounds zeros are the padding, counted apart; in
    fp32 the staged-tile UP mode of csrc/conv_staged.cu over the folded
    taps."""
    if plain_route(x):
        return upsample2x_conv3x3_plain(x, w, b)
    return _upconv("upsample2x_conv3x3_inpad", x, b, taps,
                   upsample_inpad_launches,
                   functools.partial(_launch_staged,
                                     "dtp_upsample2x_conv3x3_staged"))


def gn_silu_conv3x3(x, scale, bias, w, b, temb=None, residual=None,
                    num_groups=32, eps=1e-5):
    """GroupNorm(scale, bias) -> SiLU -> 3x3 SAME conv(w, b) [+ temb
    (B, Cout)] [+ residual (B, H, W, Cout)], NHWC, with the GroupNorm's
    statistics taken of x itself (kernel K10 on CUDA: csrc/moments.cu's
    fp32 sums of x, then the conv, which folds them with scale and bias
    into its prologue; two launches, no host sync). scale, bias: (Cin,); b
    may be None. The arithmetic is gn_silu_conv3x3_plain's."""
    if plain_route(x):
        return gn_silu_conv3x3_plain(x, scale, bias, w, b, temb, residual,
                                     num_groups, eps)
    return _gn_silu_conv3x3(x, scale, bias, w, b, temb, residual,
                            num_groups, eps)


def _gn_silu_conv3x3(x, scale, bias, w, b, temb=None, residual=None,
                     num_groups=32, eps=1e-5, consumers=None, splits=None):
    """K10 on CUDA: in bf16 dtp_gn_silu_conv3x3_sm90, the affine mode of
    csrc/gn_conv_sm90.cu with the plan of gn_conv.gn_silu_sm90_plan
    (`consumers` 1 or 2 and `splits` force its tile and split of K: the
    tests and tools call this entry with them); in fp32
    dtp_gn_silu_conv3x3_staged, the staged-tile FMA twin."""
    name = "gn_silu_conv3x3"
    if x.dim() != 4 or scale is None or bias is None:
        raise ValueError(f"{name}: an NHWC x {tuple(x.shape)} and the "
                         "GroupNorm's scale and bias")
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    _check(name, x, w, b, (3, 3),
           ((scale, (cin,)), (bias, (cin,)), (temb, (B, cout)),
            (residual, (B, H, W, cout))))
    if not 0 < num_groups <= 128 or cin % num_groups:
        raise ValueError(f"{name}: {cin} channels in {num_groups} groups "
                         "(at most 128, dividing the channels)")
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        from . import gn_conv

        if not gn_conv.affine_tma_describable(x, w, residual):
            raise ValueError(f"{name}: TMA needs Cin a multiple of 8 and "
                             "16-byte-aligned bases, got x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)}")
    stats = launch_moments(name, x)
    if x.dtype == torch.bfloat16:
        wk, bk = gn_conv.pad_cout(w, b)
        plan = gn_conv.gn_silu_sm90_plan(B, H, W, cin, wk.shape[-1], cout,
                                         consumers, splits)
        work = (torch.empty(plan["work_floats"], dtype=torch.float32,
                            device=x.device) if plan["work_floats"] else None)
        source, symbol = gn_conv.GN_SM90_SOURCE, "dtp_gn_silu_conv3x3_sm90"
        fn = _cuda.function(source, symbol, _GN_SILU_SM90_ARGTYPES)
        code = fn(x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), wk.data_ptr(), _ptr(bk), _ptr(temb),
                  _ptr(residual), out.data_ptr(), _ptr(work), float(eps), B,
                  H, W, cin, wk.shape[-1], cout, num_groups, consumers or 0,
                  splits or 0, _cuda.stream_of(x))
    else:
        source, symbol = "conv_staged", "dtp_gn_silu_conv3x3_staged"
        fn = _cuda.function(source, symbol, _GN_STAGED_ARGTYPES)
        code = fn(x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), w.data_ptr(), _ptr(b), _ptr(temb),
                  _ptr(residual), out.data_ptr(), float(eps), B, H, W, cin,
                  cout, num_groups, 0, _cuda.stream_of(x))
    _cuda.check(source, symbol, code)
    gn_silu_conv3x3_launches.record((tuple(x.shape), tuple(w.shape),
                                     temb is not None, residual is not None,
                                     num_groups))
    return out
