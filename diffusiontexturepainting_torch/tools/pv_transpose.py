"""A/B of the two orientations of the attention's P V product (T10).

    python -m diffusiontexturepainting_torch.tools.pv_transpose
    python -m diffusiontexturepainting_torch.tools.pv_transpose \\
        --device cpu --shapes tiny

The port of the JAX repository's tools/bench_pv_transpose.py main(): at the
UNet's L0 / L1 / L2 shapes (bq, Lk, hd) the product e (bh, bq, Lk) @ v
(bh, Lk, hd) repeated inside one kernel call (ops/attention_variants.py
pv_product), as `e@v` and as `v^T@e^T` (hd on the M axis, transposed back
on the store), seeded uniform [0, 1) inputs, bf16. Two settings a shape:

  bh 1     the tool's own: one grid row, its `iters` dots a call (about 300
           GF); here bq / 64 blocks on the card's SMs
  bh fill  as many grid rows as give the card two blocks an SM, 64 dots

Each row: ms a call (CUDA events over back-to-back calls, best of 3), the
dots a call, TF/s, max|diff| against the plain version, and beside it one
torch.bmm of the same e and v (ms a dot and TF/s; a yardstick: the port
never calls it). On the CPU (--device cpu) the plain versions run and
nothing is timed. Without a card and without --device cpu it exits nonzero.
Prints one line per row, then one JSON line.
"""

from __future__ import annotations

import sys

import torch

from ..ops import attention_variants as arms
from . import _common

# (bq, Lk, hd, tag)
SHAPE_SETS = {
    "tool": [(512, 4096, 40, "L0"), (512, 1024, 80, "L1"),
             (256, 256, 160, "L2")],
    "tiny": [(100, 72, 40, "tiny40"), (64, 128, 80, "tiny80")],
}
FILL_ITERS = 64
CALLS, TRIES = 5, 3
TINY_ITERS = 3


def tool_iters(bq, lk, hd):
    """The tool's _iters: about 300 GF of dot work a call, at least 64."""
    return max(64, int(300e9 / (2 * bq * lk * hd)))


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "tool", argv)
    ok, card = _common.open_device(args, "pv_transpose")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    rows = []
    with torch.inference_mode():
        for bq, lk, hd, tag in SHAPE_SETS[args.shapes]:
            settings = [(1, tool_iters(bq, lk, hd) if timed else TINY_ITERS)]
            if timed:
                settings.append((_common.fill_count(-(-bq // 64)),
                                 FILL_ITERS))
            for bh, iters in settings:
                e = torch.rand((bh, bq, lk), generator=gen,
                               device=args.device).bfloat16()
                v = torch.rand((bh, lk, hd), generator=gen,
                               device=args.device).bfloat16()
                flops = 2 * bh * bq * lk * hd
                bmm_ms = (_common.event_ms(lambda: torch.bmm(e, v), 20,
                                           TRIES) if timed else None)
                for transposed in (False, True):
                    got = arms.pv_product(e, v, transposed=transposed,
                                          iters=iters)
                    want = arms.plain_pv_product(e, v, transposed=transposed,
                                                 iters=iters)
                    ms = (_common.event_ms(
                        lambda: arms.pv_product(e, v, transposed=transposed,
                                                iters=iters), CALLS, TRIES)
                        if timed else None)
                    label = "v^T@e^T" if transposed else "e@v"
                    r = {"tag": tag, "bh": bh, "bq": bq, "Lk": lk, "hd": hd,
                         "row": label, "iters": iters, "ms": ms,
                         "tflops": flops * iters / ms / 1e9 if timed
                         else None,
                         "bmm_ms_a_dot": bmm_ms,
                         "bmm_tflops": flops / bmm_ms / 1e9 if timed
                         else None,
                         "max_abs_diff_plain": _common.max_diff(got, want),
                         "peak": want.float().abs().max().item()}
                    rows.append(r)
                    f = _common.fmt
                    print(f"{tag} (bh={bh}, bq={bq}, Lk={lk}, hd={hd}) "
                          f"{label:7s}: {f(ms, '8.3f')} ms/call ({iters} "
                          f"dots)  {f(r['tflops'], '6.1f')} TF/s; torch.bmm "
                          f"{f(bmm_ms, '.4f')} ms/dot "
                          f"{f(r['bmm_tflops'], '.1f')} TF/s; max|diff| vs "
                          f"its plain version {r['max_abs_diff_plain']:.3e} "
                          f"of {r['peak']:.3e}", flush=True)
    return _common.emit(args, card, rows, calls=CALLS, tries=TRIES)


if __name__ == "__main__":
    sys.exit(main())
