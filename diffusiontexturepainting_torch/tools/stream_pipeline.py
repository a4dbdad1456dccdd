"""A/B of the software-pipelined GroupNorm-SiLU-conv prototype (T12)
against the shipped streamed kernel (K5).

    python -m diffusiontexturepainting_torch.tools.stream_pipeline
    python -m diffusiontexturepainting_torch.tools.stream_pipeline \\
        --device cpu --shapes tiny

The port of the JAX repository's tools/bench_stream_pipeline.py main(): at
the VAE's Cout-128 / 256 shapes (B, H, W, Cin -> Cout), the tool's seeded
inputs (x standard normal, a near 1, c near 0, w x 0.04), bf16, the rows

  ship   K5 (ops/gn_conv.py gn_conv_stream, statistics and residual off)
  piped  T12 (ops/conv_variants.py pipelined: in bf16 the affine mode of
         the K1/K5 kernel, csrc/gn_conv_sm90.cu, its fp32 prologue on every
         window pixel, TMA's zeros included)

with ms a call (CUDA events over 20 back-to-back calls, best of 4), TF/s,
and the interior max|diff| of the two on rows [8:-8], as the tool prints it
(the two differ at the border by design: K5's conv input is 0 there, T12's
silu(c); the tool cuts the rows and keeps every column, so the first and
last columns' difference is in that number); piped also against its plain
version everywhere. On the CPU (--device cpu) the plain versions run and
nothing is timed. Without a card and without --device cpu it exits nonzero.
Prints one line per shape, then one JSON line.
"""

from __future__ import annotations

import sys

import torch

from ..ops import conv_variants as cv
from ..ops import gn_conv
from . import _common

# (B, H, W, Cin, Cout)
SHAPE_SETS = {
    "tool": [(2, 512, 512, 128, 128), (1, 512, 512, 128, 128),
             (1, 256, 256, 256, 256)],
    "tiny": [(2, 24, 10, 16, 8), (1, 19, 7, 5, 24)],
}


def make_inputs(B, H, W, cin, cout, device, gen, dtype=torch.bfloat16):
    """x, a, c, w, b as the tool draws them."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return (rnd(B, H, W, cin).to(dtype), rnd(B, cin) * 0.1 + 1,
            rnd(B, cin) * 0.1, (rnd(3, 3, cin, cout) * 0.04).to(dtype),
            rnd(cout).to(dtype))


def ship(x, a, c, w, b):
    return gn_conv.gn_conv_stream(x, a, c, w, b, None, False, True)[0]


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "tool", argv)
    ok, card = _common.open_device(args, "stream_pipeline")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    rows = []
    with torch.inference_mode():
        for B, H, W, cin, cout in SHAPE_SETS[args.shapes]:
            ins = make_inputs(B, H, W, cin, cout, args.device, gen)
            ref, out = ship(*ins), cv.pipelined(*ins)
            want = cv.plain_pipelined(*ins)
            flops = 2 * B * H * W * cin * cout * 9
            t0 = _common.event_ms(lambda: ship(*ins)) if timed else None
            t1 = (_common.event_ms(lambda: cv.pipelined(*ins))
                  if timed else None)
            r = {"B": B, "H": H, "W": W, "Cin": cin, "Cout": cout,
                 "ship_ms": t0, "piped_ms": t1,
                 "ship_tflops": flops / t0 / 1e9 if timed else None,
                 "piped_tflops": flops / t1 / 1e9 if timed else None,
                 "interior_max_diff": _common.max_diff(ref[:, 8:-8],
                                                       out[:, 8:-8]),
                 "max_abs_diff_plain": _common.max_diff(out, want),
                 "peak": want.float().abs().max().item()}
            rows.append(r)
            f = _common.fmt
            print(f"({B},{H},{W},{cin})->{cout}: ship={f(t0, '.3f')}ms "
                  f"({f(r['ship_tflops'], '.0f')} TF/s) "
                  f"piped={f(t1, '.3f')}ms ({f(r['piped_tflops'], '.0f')}) "
                  f"interior maxdiff={r['interior_max_diff']:.2e}; piped vs "
                  f"its plain version {r['max_abs_diff_plain']:.2e} of "
                  f"{r['peak']:.2e}", flush=True)
    return _common.emit(args, card, rows, calls=_common.CALLS,
                        tries=_common.TRIES)


if __name__ == "__main__":
    sys.exit(main())
