"""A/B of the tile plans of the bf16 K2 and K9 kernels.

    python -m diffusiontexturepainting_torch.tools.sm90_plans
    python -m diffusiontexturepainting_torch.tools.sm90_plans \\
        --device cpu --shapes tiny

K2 (ops/attention.py flash_attention, csrc/flash_attention_sm90.cu) at each
shape the served paths launch it at (UNet level 0 and the VAE mid-blocks
of a 256^2 stamp, levels 1 and 2 of a 1024^2 stamp) under every bucket of
SM90_BUCKETS at least hd deep, SDPA beside; K9 (ops/gn_conv.py
downconv_stream, csrc/conv_sm90.cu) at the default stamp's three calls at
256^2 and at 1024^2 with one and two consumer warpgroups a tile,
F.conv2d (channels-last, stride 2 on the input padded beforehand, no
statistics) beside. Seeded normal inputs, bf16. Each row: ms a call (CUDA
events over back-to-back calls, best of 4: the host's launch cost
included), device_ms (the same calls replayed from a CUDA graph: the
device's time alone), the CTAs of its grid, whether it is the plan's
choice, max|diff| against the plain version (K9: also of its statistics). The yardsticks are timed only; the port never calls them.
On the CPU (--device cpu) the plain versions run and nothing is timed.
Without a card and without --device cpu it exits nonzero. Prints one line
per row, then one JSON line.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import attention, gn_conv
from . import _common

# attention (B, L, D, heads, tag); downconv (B, H, W, Cin, Cout, tag)
SHAPE_SETS = {
    "stamp": {
        "attention": [(3, 1024, 320, 8, "256^2 UNet level 0"),
                      (2, 1024, 512, 1, "256^2 VAE encoder mid-block"),
                      (1, 1024, 512, 1, "256^2 VAE decoder mid-block"),
                      (3, 4096, 640, 8, "1024^2 UNet level 1"),
                      (3, 1024, 1280, 8, "1024^2 UNet level 2")],
        "downconv": [(2, 256, 256, 128, 128, "256^2 level 0"),
                     (2, 128, 128, 256, 256, "256^2 level 1"),
                     (2, 64, 64, 512, 512, "256^2 level 2"),
                     (2, 1024, 1024, 128, 128, "1024^2 level 0"),
                     (2, 512, 512, 256, 256, "1024^2 level 1"),
                     (2, 256, 256, 512, 512, "1024^2 level 2")]},
    "tiny": {
        "attention": [(1, 100, 80, 2, "tiny hd 40"),
                      (1, 70, 512, 1, "tiny hd 512")],
        "downconv": [(1, 10, 12, 16, 24, "tiny")]},
}


def _times(fn) -> dict:
    return {"ms": _common.event_ms(fn), "device_ms": _common.graph_ms(fn)}


def _attention_rows(shapes, gen, device, timed):
    rows = []
    for B, L, D, heads, tag in shapes:
        hd = D // heads
        q, k, v = (torch.randn((B, L, D), generator=gen, device=device)
                   .bfloat16() for _ in range(3))
        want = attention.plain_attention_streaming(q, k, v, heads)
        chosen = attention.sm90_bucket(hd, L, B * heads)
        buckets = [i for i, b in enumerate(attention.SM90_BUCKETS)
                   if b[0] >= hd] if timed else [chosen]
        for i in buckets:
            p = attention.sm90_plan(hd, L, B * heads, bucket=i)
            got = attention.flash_attention(q, k, v, heads, bucket=i)
            row = {"kernel": "K2", "tag": tag, "shape": [B, L, D, heads],
                   "bucket": i, "plan": i == chosen,
                   **{f: p[f] for f in ("kd", "nv", "bkv", "consumers",
                                        "slices")},
                   "ctas": -(-L // (64 * p["consumers"])) * B * heads
                   * p["slices"],
                   "max_diff": _common.max_diff(got, want), "ms": None,
                   "device_ms": None}
            if timed:
                row.update(_times(
                    lambda: attention.flash_attention(q, k, v, heads,
                                                      bucket=i)))
            rows.append(row)
        if timed:
            qh, kh, vh = (attention._split_heads(t, heads) for t in (q, k, v))
            rows.append({"kernel": "SDPA", "tag": tag,
                         "shape": [B, L, D, heads],
                         **_times(lambda: F.scaled_dot_product_attention(
                             qh, kh, vh))})
    return rows


def _downconv_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, cin, cout, tag in shapes:
        x = torch.randn((B, H, W, cin), generator=gen, device=device)
        w = torch.randn((3, 3, cin, cout), generator=gen,
                        device=device) * (9 * cin) ** -0.5
        b = torch.randn(cout, generator=gen, device=device) * 0.1
        x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
        want, want_st = gn_conv.downconv_stream_plain(x, w, b)
        chosen = gn_conv.downconv_sm90_plan(B, H, W, cin, cout)["consumers"]
        for nc in (1, 2) if timed else (chosen,):
            p = gn_conv.downconv_sm90_plan(B, H, W, cin, cout, nc)
            got, st = gn_conv.downconv_stream(x, w, b, consumers=nc)
            row = {"kernel": "K9", "tag": tag, "shape": [B, H, W, cin, cout],
                   "consumers": nc, "plan": nc == chosen,
                   "ctas": p["m_tiles"] * p["n_tiles"],
                   "max_diff": _common.max_diff(got, want),
                   "stats_max_diff": _common.max_diff(st, want_st),
                   "ms": None, "device_ms": None}
            if timed:
                row.update(_times(
                    lambda: gn_conv.downconv_stream(x, w, b, consumers=nc)))
            rows.append(row)
        if timed:
            xp = F.pad(x, (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rows.append({"kernel": "F.conv2d", "tag": tag,
                         "shape": [B, H, W, cin, cout],
                         **_times(lambda: F.conv2d(xp, wc, b, stride=2))})
    return rows


def main(argv=None) -> int:
    args = _common.parse_args(__doc__, SHAPE_SETS, "stamp", argv)
    ok, card = _common.open_device(args, "sm90_plans")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    sets = SHAPE_SETS[args.shapes]
    with torch.inference_mode():
        rows = (_attention_rows(sets["attention"], gen, args.device, timed)
                + _downconv_rows(sets["downconv"], gen, args.device, timed))
    for r in rows:
        print(f"{r['kernel']:8s} {r['tag']:28s} "
              + (f"bucket {r['bucket']} " if "bucket" in r else "")
              + (f"consumers {r['consumers']} " if "consumers" in r else "")
              + (f"ctas {r['ctas']} " if "ctas" in r else "")
              + ("(plan) " if r.get("plan") else "")
              + f"{_common.fmt(r['ms'], '.4f')} ms, device "
              + f"{_common.fmt(r['device_ms'], '.4f')} ms"
              + (f", max|diff| {r['max_diff']:.3e}" if "max_diff" in r
                 else ""), flush=True)
    return _common.emit(args, card, rows)


if __name__ == "__main__":
    raise SystemExit(main())
