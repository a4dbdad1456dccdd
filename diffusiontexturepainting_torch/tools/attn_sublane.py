"""A/B of the transposed-product attention (T1) against the attention()
route at the UNet's self-attention shapes of the 512px stamp.

    python -m diffusiontexturepainting_torch.tools.attn_sublane
    python -m diffusiontexturepainting_torch.tools.attn_sublane \\
        --device cpu --shapes tiny

The port of the JAX repository's tools/bench_attn_sublane.py main(): at each
shape (CFG batch 3, 8 heads; hd 40, 80, 160) the rows

  base     the port's attention() route there (K2)
  sublane  T1 (ops/attention_variants.py sublane_attention: S^T = K Q^T,
           the softmax over the keys on the M axis, O^T = V^T E^T)
  sdpa     torch's scaled_dot_product_attention (a yardstick)

with ms a call (a chain of 20 calls, each output the next call's q, CUDA
events, best of 4: tools/attn_variants.py chain_ms), base / sublane as the
tool prints it, and max|diff| of sublane against base and against its plain
version, in bf16. On the CPU (--device cpu) the wrappers run their plain
versions and nothing is timed. Without a card and without --device cpu it
exits nonzero. Prints one line per shape, then one JSON line.
"""

from __future__ import annotations

import sys

import torch

from . import _common, attn_variants as av

# (B, L, heads, hd), self-attention: the tool's three shapes
SHAPE_SETS = {
    "tool": [(3, 4096, 8, 40), (3, 1024, 8, 80), (3, 256, 8, 160)],
    "tiny": [(1, 256, 2, 40), (2, 128, 2, 80), (1, 100, 2, 160)],
}
ROWS = ("base", "sublane", "sdpa")


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "tool", argv)
    ok, card = _common.open_device(args, "attn_sublane")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    rows = []
    with torch.inference_mode():
        for B, L, heads, hd in SHAPE_SETS[args.shapes]:
            q, k, v = av.make_inputs(B, L, heads * hd, "variants",
                                     args.device, torch.bfloat16, gen)
            out = {row: av.row_call(row, q, k, v, heads) for row in ROWS}
            plain = av.row_call("sublane", q, k, v, heads, plain=True)
            ms = {row: av.chain_ms(row, q, k, v, heads, av.CALLS)
                  if timed else None for row in ROWS}
            r = {"B": B, "L": L, "heads": heads, "hd": hd, "ms": ms,
                 "base_over_sublane": ms["base"] / ms["sublane"]
                 if timed else None,
                 "max_abs_diff_base": av.max_diff(out["sublane"],
                                                  out["base"]),
                 "max_abs_diff_plain": av.max_diff(out["sublane"], plain),
                 "max_abs_diff_sdpa": av.max_diff(out["sublane"],
                                                  out["sdpa"])}
            rows.append(r)
            f = _common.fmt
            print(f"B{B} L{L} H{heads} hd{hd}: base={f(ms['base'], '.3f')} "
                  f"ms  sublane={f(ms['sublane'], '.3f')} ms  "
                  f"({f(r['base_over_sublane'], '.2f')}x)  "
                  f"sdpa={f(ms['sdpa'], '.3f')} ms  "
                  f"maxerr={r['max_abs_diff_base']:.4f} (vs its plain "
                  f"version {r['max_abs_diff_plain']:.3e})", flush=True)
    return _common.emit(args, card, rows, calls=av.CALLS, tries=av.TRIES)


if __name__ == "__main__":
    sys.exit(main())
