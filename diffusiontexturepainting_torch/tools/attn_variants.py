"""A/B of the attention softmax arms at the UNet's self-attention shapes.

    python -m diffusiontexturepainting_torch.tools.attn_variants
    python -m diffusiontexturepainting_torch.tools.attn_variants \\
        --shapes stamp --json-out attn_variants.json

The port of the JAX repository's tools/bench_attn_variants.py and
tools/bench_attn_round4.py main(). Rows at each shape:

  base            the port's attention() route there (K2 or K8)
  sdpa            torch's scaled_dot_product_attention (a yardstick)
  nomax-safe, nomax, nomax/bf16p          T2 (nomax_attention)
  chunk64, chunk128 and their /bf16p      T3 (chunked_attention) at the
                                          port's 64- and 128-key chunks
  chunk512, chunk1024, chunk2048 and their /bf16p
                                          T3 at the TPU tool's chunks, where
                                          the chunk divides L and is not L
                                          (the tool's rule)
  nomax-unpadded                          T5 (nomax_unpadded: heads split
                                          by one copy pass, then merged)
  pvT                                     T9 (pvt_attention)
  nomax-4d, nomax-allheads, nomax-laneslice
                                          T6, T7, T8 (T5's function, heads
                                          read in place)
  sublane                                 T1 (sublane_attention: the exact
                                          row-max softmax, both products
                                          transposed)
  base-slotted    K13 (flash_attention_slotted) over the (B, L, h*128)
                  head-slotted layout of the same data
  slotted-kernel, slotted-kernel/f32p     T4 (slotted_kernel_call, exp2 of
                                          bf16 or fp32 logits) over
                                          (B*h, L, 128) head slots

Each row gets its ms a call, its max|diff| against its yardstick (base; for
T4, base-slotted) and against its own plain version
(ops/attention_variants.py), in bf16 (the tools' dtype). The slotted rows'
inputs are split and padded outside the timed chain, as the tool does, and
their outputs cut back to (B, L, h*hd) before the diffs; they run where hd
fits the 128-lane slot (not at hd 160). Timing: a chain of CALLS calls, each
output fed back as the next q so that no call can be skipped (the tools'
chain_time), timed with CUDA events, best of TRIES.

Input sets (seeded torch.Generator): `variants` (q, k, v standard normal,
every row timed), `round4` (k x 0.2, base and pvT timed) and `clamp` (q and
k x 8: raw logits far above 83, where the clamped no-max arms leave the
exact softmax; not timed), the last at the first shape only.

Shapes: `tools` (the tools' unet L0 / L1 512px), `stamp` (the 1024^2 / 4
stamp's three UNet self-attentions), `all` (both, the default) and `tiny`
(for the CPU tests). On the CPU (--device cpu) the wrappers run their plain
versions and nothing is timed. Without a card and without --device cpu it
exits nonzero. Prints one line per row, then one JSON line.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import attention as attn
from ..ops import attention_variants as arms
from . import _common
from ._common import CALLS, TRIES

# (label, B, L, D, heads); self-attention, hd = D / heads
SHAPE_SETS = {
    "tools": [("unet L0 512px", 3, 4096, 320, 8),
              ("unet L1 512px", 3, 1024, 640, 8)],
    "stamp": [("1024^2 L0", 3, 16384, 320, 8),
              ("1024^2 L1", 3, 4096, 640, 8),
              ("1024^2 L2", 3, 1024, 1280, 8)],
    "tiny": [("tiny hd40", 1, 256, 80, 2), ("tiny hd80", 2, 128, 160, 2),
             # 1024 keys: chunk512 and its /bf16p under the tool's rule
             ("tiny 1024", 1, 1024, 80, 2)],
}
SHAPE_SETS["all"] = SHAPE_SETS["tools"] + SHAPE_SETS["stamp"]

# row -> (arm, options)
ARM_ROWS = {
    "nomax-safe": ("nomax_attention", dict(safe=True)),
    "nomax": ("nomax_attention", {}),
    "nomax/bf16p": ("nomax_attention", dict(bf16_p=True)),
    "chunk64": ("chunked_attention", dict(bk=64)),
    "chunk64/bf16p": ("chunked_attention", dict(bk=64, bf16_p=True)),
    "chunk128": ("chunked_attention", dict(bk=128)),
    "chunk128/bf16p": ("chunked_attention", dict(bk=128, bf16_p=True)),
    **{f"chunk{bk}{tag}": ("chunked_attention", dict(bk=bk, bf16_p=bf16_p))
       for bk in (512, 1024, 2048)
       for tag, bf16_p in (("", False), ("/bf16p", True))},
    "nomax-unpadded": ("nomax_unpadded", {}),
    "pvT": ("pvt_attention", {}),
    "nomax-4d": ("nomax_4d", {}),
    "nomax-allheads": ("nomax_allheads", {}),
    "nomax-laneslice": ("nomax_laneslice", {}),
    "sublane": ("sublane_attention", {}),
}
# T4's rows -> options; they and base-slotted take the head-slotted layouts
SLOTTED_ROWS = {"slotted-kernel": dict(exp2_bf16=True),
                "slotted-kernel/f32p": dict(exp2_bf16=False)}
ROWS = (("base", "sdpa") + tuple(ARM_ROWS) + ("base-slotted",)
        + tuple(SLOTTED_ROWS))
# the input sets and the rows each one times
TIMED = {"variants": ROWS, "round4": ("base", "pvT"), "clamp": ()}


def make_inputs(B, L, D, input_set, device, dtype, gen):
    """Seeded q, k, v of one input set, (B, L, D) each."""
    def rnd():
        return torch.randn((B, L, D), generator=gen, device=device)
    q, k, v = rnd(), rnd(), rnd()
    if input_set == "round4":
        k = k * 0.2
    elif input_set == "clamp":
        q, k = q * 8.0, k * 8.0
    return tuple(t.to(dtype) for t in (q, k, v))


def _sdpa(q, k, v, heads):
    qh, kh, vh = (attn._split_heads(t, heads) for t in (q, k, v))
    return attn._merge_heads(F.scaled_dot_product_attention(qh, kh, vh))


def base_plain(q, k, v, heads):
    """The plain version of attention()'s route at this shape."""
    route = attn.attention_route(q.shape[1], k.shape[1],
                                 q.shape[-1] // heads, q.dtype)
    if route == "plain":
        return attn.plain_attention(q, k, v, heads)
    # K2 and K8 compute one function
    return attn.plain_attention_streaming(q, k, v, heads)


def applies(row, L):
    """Whether a row runs at L keys: T3's chunks the TPU tool times only
    where they divide L and are not L."""
    bk = ARM_ROWS.get(row, (None, {}))[1].get("bk")
    return bk is None or bk <= 128 or not (L % bk or L == bk)


def layout(row):
    """The inputs a row takes: 'proj' (B, L, h*hd), 'slots' (B, L, h*128:
    each head's lanes first in its slot, zero pad lanes) or 'heads'
    (B*h, L, 128: the slots split by head)."""
    if row == "base-slotted":
        return "slots"
    return "heads" if row in SLOTTED_ROWS else "proj"


def to_slots(x, heads):
    """(B, L, h*hd) -> (B, L, h*128), zero pad lanes (K13's layout)."""
    B, L, D = x.shape
    out = x.new_zeros((B, L, heads, attn.SLOT))
    out[..., :D // heads] = x.view(B, L, heads, D // heads)
    return out.view(B, L, heads * attn.SLOT)


def from_layout(x, lay, batch, heads, hd):
    """A row's output in its layout -> (B, L, h*hd); None stays None."""
    if x is None or lay == "proj":
        return x
    if lay == "heads":
        x = arms.merge_heads(x, batch)
    B, L, _ = x.shape
    return x.view(B, L, heads, attn.SLOT)[..., :hd].reshape(B, L, heads * hd)


def row_call(row, q, k, v, heads, plain=False, hd=None):
    """One call of a row's function on inputs in its layout (its plain
    version with `plain`; None for sdpa, which has none); `hd`, the real
    head dim, for the slotted rows."""
    if row == "base-slotted":
        fn = (attn.plain_attention_slotted if plain
              else attn.flash_attention_slotted)
        return fn(q, k, v, heads, hd)
    if row in SLOTTED_ROWS:
        wrapper, plain_fn = arms.ARMS["slotted_kernel_call"]
        return (plain_fn if plain else wrapper)(q, k, v, hd**-0.5,
                                                **SLOTTED_ROWS[row])
    if row == "base":
        return (base_plain if plain else attn.attention)(q, k, v, heads)
    if row == "sdpa":
        return None if plain else _sdpa(q, k, v, heads)
    arm, options = ARM_ROWS[row]
    wrapper, plain_fn = arms.ARMS[arm]
    return (plain_fn if plain else wrapper)(q, k, v, heads, **options)


def chain_ms(row, q, k, v, heads, calls, hd=None):
    """Best of TRIES CUDA-event timings of a chain of `calls` calls, each
    output the next call's q; ms a call."""
    def chain():
        x = q
        for _ in range(calls):
            x = row_call(row, x, k, v, heads, hd=hd)
        return x
    return _common.event_ms(chain, 1, TRIES) / calls


def max_diff(a, b):
    """max|a - b|, or None where either is missing or not finite (T2
    without `safe` overflows on the clamp set, as on the TPU)."""
    if a is None or b is None:
        return None
    d = (a.float() - b.float()).abs().max().item()
    return d if d == d and d != float("inf") else None


def run_shape(label, B, L, D, heads, input_set, device, gen):
    """Every row at one shape and input set -> list of records (the
    slotted rows only where hd fits the slot, T3's tool chunks where
    `applies`)."""
    q, k, v = make_inputs(B, L, D, input_set, device, torch.bfloat16, gen)
    hd = D // heads
    inputs = {"proj": (q, k, v)}
    if hd <= attn.SLOT:
        inputs["slots"] = tuple(to_slots(t, heads) for t in (q, k, v))
        inputs["heads"] = tuple(arms.split_heads(t, heads)
                                for t in inputs["slots"])
    yardsticks = {"base": row_call("base", q, k, v, heads)}
    if "slots" in inputs:
        yardsticks["base-slotted"] = from_layout(
            row_call("base-slotted", *inputs["slots"], heads, hd=hd),
            "slots", B, heads, hd)
    records = []
    for row in ROWS:
        lay = layout(row)
        if lay not in inputs or not applies(row, L):
            continue
        ins = inputs[lay]
        yard = "base-slotted" if row in SLOTTED_ROWS else "base"
        got = (yardsticks[row] if row in yardsticks
               else from_layout(row_call(row, *ins, heads, hd=hd), lay, B,
                                heads, hd))
        want = from_layout(row_call(row, *ins, heads, plain=True, hd=hd),
                           lay, B, heads, hd)
        timed = device == "cuda" and row in TIMED[input_set]
        records.append({
            "shape": label, "B": B, "L": L, "D": D, "heads": heads,
            "input_set": input_set, "row": row,
            "route": attn.attention_route(L, L, hd, q.dtype),
            "ms": chain_ms(row, *ins, heads, CALLS, hd=hd) if timed else None,
            "base_row": yard,
            "max_abs_diff_base": max_diff(got, yardsticks[yard]),
            "max_abs_diff_plain": max_diff(got, want),
            "finite": bool(torch.isfinite(got).all()),
        })
        del got, want
    return records


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "all", argv)
    ok, card = _common.open_device(args, "attn_variants")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    shapes = SHAPE_SETS[args.shapes]
    records = []
    fmt = _common.fmt
    with torch.inference_mode():
        for i, (label, B, L, D, heads) in enumerate(shapes):
            for input_set in TIMED:
                if input_set == "clamp" and i:
                    continue
                rows = run_shape(label, B, L, D, heads, input_set,
                                 args.device, gen)
                for r in rows:
                    print(f"{label} {r['row']} [{input_set}, "
                          f"{r['route']} route]: "
                          f"{fmt(r['ms'], '.4f')} ms/call, max|diff| vs "
                          f"{r['base_row']} "
                          f"{fmt(r['max_abs_diff_base'], '.3e')}, "
                          f"vs its plain version "
                          f"{fmt(r['max_abs_diff_plain'], '.3e')}",
                          flush=True)
                records += rows
    return _common.emit(args, card, records, calls=CALLS, tries=TRIES)


if __name__ == "__main__":
    sys.exit(main())
