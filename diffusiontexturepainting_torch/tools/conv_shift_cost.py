"""A/B of the four tap reads of a 3x3 conv over a resident window (T11).

    python -m diffusiontexturepainting_torch.tools.conv_shift_cost
    python -m diffusiontexturepainting_torch.tools.conv_shift_cost \\
        --device cpu --shapes tiny

The port of the JAX repository's tools/bench_conv_shift_cost.py main(): at
the VAE decoder's three window shapes (H_T, W, Cin, N) the nine-tap product
over xwin (nwin, H_T+2, Wp, Cin), Wp = W + 2 rounded up to 8, with each tap
read of ops/conv_variants.py conv_window_taps:

  shifted    the VALID 3x3 conv (tap (di, dj) reads the window shifted)
  unshifted  every tap reads the unshifted window (wrong on purpose: the
             same products without the shifted reads)
  rowflat    taps read flat rows at pitch W
  jointw     per di the three dj reads as one K = 3*Cin product (the tool's
             main() never runs it; here it runs)

seeded uniform [0, 1) inputs, bf16, reps 24 passes a call as the tool. Two
settings a shape: nwin 1 (the tool's single window, 16 to 32 blocks here)
and as many windows as give the card two blocks an SM. Each row: ms a pass
(CUDA events over back-to-back calls, best of 4, over reps), TF/s, and
max|diff| against the plain version; `shifted` also against F.conv2d on the
same windows (a yardstick: the port never calls it). On the CPU
(--device cpu) the plain versions run and nothing is timed. Without a card
and without --device cpu it exits nonzero. Prints one line per row, then
one JSON line.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import conv_variants as cv
from . import _common

# (H_T, W, Cin, N, tag)
SHAPE_SETS = {
    "tool": [(16, 128, 512, 128, "dec 128^2x512"),
             (8, 256, 256, 256, "dec 256^2x256"),
             (8, 512, 128, 128, "dec 512^2x128")],
    "tiny": [(4, 10, 16, 8, "tiny"), (3, 7, 5, 24, "tiny ragged")],
}
REPS = 24
TINY_REPS = 3


def window_inputs(nwin, H_T, W, cin, n, device, gen, dtype=torch.bfloat16):
    """The tool's inputs with a leading axis of windows: xwin and the
    (9, Cin, N) weights, uniform [0, 1); jointw reads the same weights as
    (3, 3*Cin, N), which is the same memory."""
    wp = W + 2 + (-(W + 2)) % 8
    xwin = torch.rand((nwin, H_T + 2, wp, cin), generator=gen,
                      device=device).to(dtype)
    w = torch.rand((9, cin, n), generator=gen, device=device).to(dtype)
    return xwin, w


def weights_for(w, variant):
    return w.view(3, 3 * w.shape[1], w.shape[2]) if variant == "jointw" else w


def conv2d_call(xwin, w, W):
    """F.conv2d computing `shifted` at reps 1 on the same windows (the
    columns beyond W + 2 cut outside the call)."""
    x = xwin[:, :, :W + 2].permute(0, 3, 1, 2)  # channels-last memory
    wc = w.view(3, 3, *w.shape[1:]).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x = x.contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, wc)


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "tool", argv)
    ok, card = _common.open_device(args, "conv_shift_cost")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    reps = REPS if timed else TINY_REPS
    rows = []
    with torch.inference_mode():
        for H_T, W, cin, n, tag in SHAPE_SETS[args.shapes]:
            blocks = -(-H_T // 8) * -(-W // 16) * -(-n // 128)
            counts = [1] + ([_common.fill_count(blocks)] if timed else [])
            for nwin in counts:
                xwin, w = window_inputs(nwin, H_T, W, cin, n, args.device,
                                        gen)
                flops = 2 * nwin * H_T * W * cin * n * 9
                lib_ms = (_common.event_ms(conv2d_call(xwin, w, W))
                          if timed else None)
                for variant in cv.VARIANTS:
                    wv = weights_for(w, variant)
                    got = cv.conv_window_taps(xwin, wv, variant, W=W,
                                              reps=reps)
                    want = cv.plain_conv_window_taps(xwin, wv, variant, W=W,
                                                     reps=reps)
                    ms = (_common.event_ms(
                        lambda: cv.conv_window_taps(xwin, wv, variant, W=W,
                                                    reps=reps)) / reps
                        if timed else None)
                    r = {"tag": tag, "nwin": nwin, "H_T": H_T, "W": W,
                         "Cin": cin, "N": n, "variant": variant,
                         "reps": reps, "ms_a_pass": ms,
                         "tflops": flops / ms / 1e9 if timed else None,
                         "conv2d_ms": lib_ms if variant == "shifted"
                         else None,
                         "max_abs_diff_plain": _common.max_diff(got, want),
                         "peak": want.float().abs().max().item()}
                    rows.append(r)
                    f = _common.fmt
                    print(f"{tag} nwin={nwin} H_T={H_T} W={W} Cin={cin} "
                          f"N_T={n} {variant:9s}: {f(ms, '7.4f')} ms/pass  "
                          f"{f(r['tflops'], '6.1f')} TF/s"
                          + (f"; F.conv2d {f(lib_ms, '.4f')} ms"
                             if variant == "shifted" else "")
                          + f"; max|diff| vs its plain version "
                          f"{r['max_abs_diff_plain']:.3e} of "
                          f"{r['peak']:.3e}", flush=True)
    return _common.emit(args, card, rows, calls=_common.CALLS,
                        tries=_common.TRIES)


if __name__ == "__main__":
    sys.exit(main())
