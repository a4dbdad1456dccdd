"""A/B of the tile plans of the bf16 K2, K9, K1/K5, K3, K4, K6, K7, T11 and
T7 kernels (K7's also served as K12a and K11), and of K14's.

    python -m diffusiontexturepainting_torch.tools.sm90_plans
    python -m diffusiontexturepainting_torch.tools.sm90_plans --rows ff,upconv
    python -m diffusiontexturepainting_torch.tools.sm90_plans \\
        --rows upstats,same,inpad,stream
    python -m diffusiontexturepainting_torch.tools.sm90_plans --rows taps
    python -m diffusiontexturepainting_torch.tools.sm90_plans --rows arms
    python -m diffusiontexturepainting_torch.tools.sm90_plans \\
        --device cpu --shapes tiny

K2 (ops/attention.py flash_attention, csrc/flash_attention_sm90.cu) at each
shape the served paths launch it at (UNet level 0 and the VAE mid-blocks
of a 256^2 stamp, levels 1 and 2 of a 1024^2 stamp) under every bucket of
SM90_BUCKETS at least hd deep, SDPA beside; K9 (ops/gn_conv.py
downconv_stream, csrc/conv_sm90.cu) at the default stamp's three calls at
256^2 and at 1024^2 with one and two consumer warpgroups a tile,
F.conv2d (channels-last, stride 2 on the input padded beforehand, no
statistics) beside; K1/K5 (ops/gn_conv.py _gn_conv3x3, csrc/gn_conv_sm90.cu)
at the served shapes of the default stamp at 256^2 and 1024^2 with one and
two consumer warpgroups, each under its plan's split of K and without a
split, F.conv2d (channels-last, SAME: the conv alone, no prologue, residual
or statistics) beside; K14 (ops/groupnorm.py spatial_moments,
csrc/moments.cu) at the shapes it is called at, torch.var_mean over H and W
beside; with --rows ff,upconv (not in the default rows): K3
(ops/ff_geglu.py _ff_geglu, csrc/ff_geglu_sm90.cu) at one UNet eval's
feed-forward shapes at 256^2, 512^2 and 1024^2 with one and two consumer
warpgroups, each under its plan's split of the second GEMM's K and without
a split, beside the composition of two bf16 F.linear calls, the GEGLU
elementwise and the residual add (not one call: no PyTorch call computes
the function); K4 (ops/conv3x3.py _upsample2x_conv3x3, the upsample mode
of csrc/gn_conv_sm90.cu) at the UNet's upsample shapes at the same points
under its plan's split and without one, F.conv_transpose2d (stride 2,
padding 1, channels-last) on the 4x4 weight assembled from the folded taps
beside; with --rows upstats,same,inpad,stream (not in the default rows
either): K6 (ops/gn_conv.py _upconv_stream, K4's kernel with the
statistics in its epilogue) at the VAE decoder's upsamplers at 256^2,
512^2 and 1024^2 under its plan's split and without one,
F.conv_transpose2d on the assembled weight beside (no statistics); K7
(ops/conv3x3.py _conv3x3, the PLAIN mode of csrc/gn_conv_sm90.cu) at every
shape of the safe twin's 256^2 stamp (kernel_ab.TWIN_K7: K12a's shape set,
and K11's TWIN_K11 among it) under its plan and under every forced plan,
one or two consumer warpgroups by every split of K the kernel can run,
beside the K1/K5 kernel called with no prologue, residual or statistics
(the same function through the V buffers: row "K1/K5 no prologue") and
F.conv2d (channels-last, SAME); K12a (ops/conv3x3.py conv3x3_inpad) at
TWIN_K7 and K11 (conv3x3_stream) at TWIN_K11 through the served wrappers
under the plan, with max|diff| against K7 on the same inputs (0: one
plan, one launch), F.conv2d beside; with --rows taps: T11 (ops/
conv_variants.py _conv_window_taps, csrc/window_taps_sm90.cu) at the
conv_arms path's windows (kernel_ab.TAPS_ARMS, reps 1) and the TPU tool's
three shapes (kernel_ab.TAPS_TOOL, one window, reps 24), each read under
its plan, and `shifted` under every forced tile (64 or 128 flat rows: one
or two consumer warpgroups) by every split of K, F.conv2d (VALID,
channels-last) on the same windows beside; with --rows arms: T7 (ops/
attention_variants.py _nomax_allheads, the all-heads mode of
csrc/flash_attention_sm90.cu) at the attn_arms path's three shapes (the
1024^2/4 stamp's UNet self-attentions) under its plan and every consumer
warpgroup count the kernel offers at that hd, T9 (pvt_attention, the
head-major one-pass mode with p as hi + lo) under its plan, T7 on T9's
head-major grid and bucket (`T7 head-major`: T9 less its second product;
with T7's plan rows it parts T7 and T9's difference into the grid's share
and the split's), T1 (sublane_attention: the chunked mode in one chunk of
every key), T3 (chunked_attention) at chunks of 64, 128 and 1024 keys and
1024 with bf16 p (`T3 chunk64`, ...), the attention() route's K8 or K2 on
the same data (`K8/K2`: T3's family, which it equals bit for bit where the
chunk is the route's K/V tile with fp32 p), SDPA beside.
Seeded normal inputs, bf16. Each row: ms a call (CUDA
events over back-to-back calls, best of 4: the host's launch cost
included), device_ms (the same calls replayed from a CUDA graph: the
device's time alone), the CTAs of its grid, whether it is the plan's
choice, max|diff| against the plain version (K9, K1/K5: also of their
statistics). The yardsticks are timed only; the port never calls them.
On the CPU (--device cpu) the plain versions run and nothing is timed.
Without a card and without --device cpu it exits nonzero. Prints one line
per row, then one JSON line.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import attention, attention_variants, conv3x3, conv_variants
from ..ops import ff_geglu, gn_conv
from ..ops import groupnorm
from . import _common, kernel_ab

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
                     (2, 256, 256, 512, 512, "1024^2 level 2")],
        # (B, H, W, Cin, Cout, tag): K1 (UNet, batch 3), K5 (VAE)
        "gn_conv": [(3, 32, 32, 320, 320, "256^2 UNet level 0"),
                    (3, 16, 16, 640, 640, "256^2 UNet level 1"),
                    (3, 8, 8, 1280, 1280, "256^2 UNet level 2"),
                    (3, 4, 4, 1280, 1280, "256^2 UNet level 3"),
                    (2, 256, 256, 128, 128, "256^2 VAE encoder level 0"),
                    (1, 256, 256, 128, 128, "256^2 VAE decoder level 0"),
                    (3, 128, 128, 320, 320, "1024^2 UNet level 0"),
                    (3, 32, 32, 1280, 1280, "1024^2 UNet level 2"),
                    (2, 1024, 1024, 128, 128, "1024^2 VAE encoder level 0")],
        # (B, H, W, C, tag)
        "moments": [(3, 4, 4, 1280, "256^2 UNet level 3"),
                    (3, 32, 32, 640, "256^2 UNet up level 0"),
                    (2, 32, 32, 512, "256^2 VAE mid block"),
                    (2, 256, 256, 128, "256^2 VAE stem"),
                    (3, 128, 128, 640, "1024^2 UNet up level 0"),
                    (2, 1024, 1024, 128, "1024^2 VAE stem")],
        # (N, C, inner, tag): one UNet eval's feed-forwards, batch 3
        "ff": [(n, c, 4 * c, f"{res}^2 UNet {level}")
               for res, n0 in ((256, 3072), (512, 12288), (1024, 49152))
               for (n, c, level) in ((n0, 320, "level 0"),
                                     (n0 // 4, 640, "level 1"),
                                     (n0 // 16, 1280, "level 2"),
                                     (n0 // 64, 1280, "mid block"))],
        # (B, H, W, C, tag): the UNet's upsamplers' sources, batch 3
        "upconv": [(3, h, h, c, f"{res}^2 UNet up {level}")
                   for res, h0 in ((256, 4), (512, 8), (1024, 16))
                   for (h, c, level) in ((h0, 1280, "level 3"),
                                         (2 * h0, 1280, "level 2"),
                                         (4 * h0, 640, "level 1"))],
        # (B, H, W, C, tag): the VAE decoder's upsamplers' sources, batch 1
        "upstats": [(1, h, h, c, f"{res}^2 VAE up {level}")
                    for res, h0 in ((256, 32), (512, 64), (1024, 128))
                    for (h, c, level) in ((h0, 512, "0"), (2 * h0, 512, "1"),
                                          (4 * h0, 256, "2"))],
        # (B, H, W, Cin, Cout, tag): K7 and K12a at the safe twin's 256^2
        # stamp, K11 at those of its shapes that pass streaming_plan's test
        "same": None, "inpad": None, "stream": None,
        # (nwin, H_T, W, Cin, N, reps, tag): T11
        "taps": None,
        # (B, L, D, heads, tag): T7 and T9 on the attn_arms path
        "arms": [(B, L, D, heads, tag) for B, L, D, heads, _, tag
                 in kernel_ab.ATTN]},
    "tiny": {
        "attention": [(1, 100, 80, 2, "tiny hd 40"),
                      (1, 70, 512, 1, "tiny hd 512")],
        "downconv": [(1, 10, 12, 16, 24, "tiny")],
        "gn_conv": [(3, 4, 4, 24, 16, "tiny 4x4"), (1, 9, 10, 16, 8, "tiny")],
        "moments": [(2, 5, 7, 40, "tiny")],
        "ff": [(37, 64, 256, "tiny")],
        "upconv": [(1, 5, 7, 16, "tiny"), (3, 4, 4, 24, "tiny 4x4")],
        "upstats": [(1, 5, 7, 16, "tiny"), (2, 9, 6, 24, "tiny 2 images")],
        "same": [(3, 4, 4, 24, 16, "tiny 4x4"), (1, 9, 10, 16, 8, "tiny")],
        "inpad": [(3, 4, 4, 24, 16, "tiny 4x4"), (1, 9, 10, 16, 8, "tiny")],
        "stream": [(1, 9, 10, 16, 128, "tiny")],
        "taps": [(2, 4, 10, 16, 8, 3, "tiny"),
                 (1, 3, 7, 8, 24, 1, "tiny ragged")],
        "arms": [(1, 100, 80, 2, "tiny hd 40"), (2, 70, 160, 1, "tiny hd 160"),
                 (1, 128, 80, 2, "tiny 128 keys")]},
}
SHAPE_SETS["stamp"].update(
    same=kernel_ab.TWIN_K7, inpad=kernel_ab.TWIN_K7,
    stream=kernel_ab.TWIN_K11,
    taps=[(nwin, h_t, W, cin, n, 1, f"conv_arms {nwin}x{h_t}x{W} x{count}")
          for nwin, h_t, W, cin, n, count in kernel_ab.TAPS_ARMS]
    + [(nwin, h_t, W, cin, n, reps, f"tool {h_t}x{W}x{cin}")
       for nwin, h_t, W, cin, n, reps in kernel_ab.TAPS_TOOL])


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


def _gn_conv_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, cin, cout, tag in shapes:
        x = torch.randn((B, H, W, cin), generator=gen, device=device)
        w = torch.randn((3, 3, cin, cout), generator=gen,
                        device=device) * (9 * cin) ** -0.5
        b = torch.randn(cout, generator=gen, device=device) * 0.1
        r = torch.randn((B, H, W, cout), generator=gen, device=device)
        a = torch.rand((B, cin), generator=gen, device=device) + 0.5
        c = torch.randn((B, cin), generator=gen, device=device) * 0.2
        x, w, b, r = x.bfloat16(), w.bfloat16(), b.bfloat16(), r.bfloat16()
        want, want_st = gn_conv.gn_conv3x3_plain(x, a, c, w, b, r)
        chosen = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout)
        arms = [(chosen["consumers"], None)]
        if timed:
            arms = []
            for nc in (1, 2):
                p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout,
                                              consumers=nc)
                arms += [(nc, None)] + ([(nc, 1)] if p["splits"] > 1 else [])
        for nc, splits in arms:
            p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout, consumers=nc,
                                          splits=splits)
            call = (lambda nc=nc, splits=splits: gn_conv._gn_conv3x3(
                x, a, c, w, b, r, consumers=nc, splits=splits))
            got, st = call()
            row = {"kernel": "K1/K5", "tag": tag,
                   "shape": [B, H, W, cin, cout], "consumers": nc,
                   "splits": p["splits"],
                   "plan": (nc == chosen["consumers"]
                            and p["splits"] == chosen["splits"]),
                   "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                   "max_diff": _common.max_diff(got, want),
                   "stats_max_diff": _common.max_diff(st, want_st),
                   "ms": None, "device_ms": None}
            if timed:
                row.update(_times(call))
            rows.append(row)
        if timed:
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rows.append({"kernel": "F.conv2d", "tag": tag,
                         "shape": [B, H, W, cin, cout],
                         **_times(lambda: F.conv2d(xc, wc, b, padding=1))})
    return rows


def _moments_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, C, tag in shapes:
        x = (torch.randn((B, H, W, C), generator=gen, device=device)
             + 0.5).bfloat16()
        p = groupnorm.moments_plan(B, H * W, C, 2, C % 8 == 0)
        got = groupnorm.spatial_moments(x)
        row = {"kernel": "K14", "tag": tag, "shape": [B, H, W, C],
               "bands": p["bands"],
               "ctas": p["bands"] * B * p["slices"], "plan": True,
               "max_diff": _common.max_diff(
                   got, groupnorm.spatial_moments_plain(x)),
               "ms": None, "device_ms": None}
        if timed:
            row.update(_times(lambda: groupnorm.spatial_moments(x)))
        rows.append(row)
        if timed:
            rows.append({"kernel": "var_mean", "tag": tag,
                         "shape": [B, H, W, C],
                         **_times(lambda: torch.var_mean(
                             x, dim=(1, 2), correction=0))})
    return rows


def _ff_rows(shapes, gen, device, timed):
    rows = []
    for N, C, inner, tag in shapes:
        x, res = (torch.randn((N, C), generator=gen, device=device)
                  .bfloat16() for _ in range(2))
        w0 = (torch.randn((2 * inner, C), generator=gen, device=device)
              * C**-0.5).bfloat16()
        w2 = (torch.randn((C, inner), generator=gen, device=device)
              * inner**-0.5).bfloat16()
        b0, b2 = ((torch.randn(n, generator=gen, device=device) * 0.1)
                  .bfloat16() for n in (2 * inner, C))
        want = ff_geglu.ff_geglu_plain(x, w0, b0, w2, b2, res)
        chosen = ff_geglu.ff_sm90_plan(N, C, inner)
        arms = [(None, None)]
        if timed:
            arms = []
            for nc in (1, 2):
                p = ff_geglu.ff_sm90_plan(N, C, inner, consumers=nc)
                arms += [(nc, None)] + (
                    [(nc, 1)] if p["down"]["splits"] > 1 else [])
        for nc, splits in arms:
            p = ff_geglu.ff_sm90_plan(N, C, inner, consumers=nc,
                                      splits=splits)
            call = (lambda nc=nc, splits=splits: ff_geglu._ff_geglu(
                x, w0, b0, w2, b2, res, consumers=nc, splits=splits))
            gate, down = p["gate"], p["down"]
            row = {"kernel": "K3", "tag": tag, "shape": [N, C, inner],
                   "consumers": [gate["consumers"], down["consumers"]],
                   "splits": down["splits"],
                   "plan": (gate["consumers"] == chosen["gate"]["consumers"]
                            and down["consumers"]
                            == chosen["down"]["consumers"]
                            and down["splits"] == chosen["down"]["splits"]),
                   "ctas": [gate["m_tiles"] * gate["i_tiles"],
                            down["m_tiles"] * down["n_tiles"]
                            * down["splits"]],
                   "max_diff": _common.max_diff(call(), want),
                   "ms": None, "device_ms": None}
            if timed:
                row.update(_times(call))
            rows.append(row)
        if timed:
            def composition():
                h = F.linear(x, w0, b0)
                return F.linear(h[:, :inner] * F.gelu(h[:, inner:]), w2,
                                b2) + res
            rows.append({"kernel": "composition", "tag": tag,
                         "shape": [N, C, inner],
                         "note": "composition, not one call",
                         **_times(composition)})
    return rows


def _upconv_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, C, tag in shapes:
        x = torch.randn((B, H, W, C), generator=gen, device=device).bfloat16()
        w = (torch.randn((3, 3, C, C), generator=gen, device=device)
             * (9 * C) ** -0.5).bfloat16()
        b = (torch.randn(C, generator=gen, device=device) * 0.1).bfloat16()
        taps = conv3x3.fold_upsample_weights(w)
        want = conv3x3.upsample2x_conv3x3_plain(x, w, b)
        chosen = gn_conv.upconv_sm90_plan(B, H, W, C, C)
        arms = [None] + ([1] if timed and chosen["splits"] > 1 else [])
        for splits in arms:
            p = gn_conv.upconv_sm90_plan(B, H, W, C, C, splits)
            if device == "cpu":  # the wrapper's CPU route: the plain version
                call = (lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps))
            else:
                call = (lambda splits=splits: conv3x3._upsample2x_conv3x3(
                    x, b, taps, splits=splits))
            row = {"kernel": "K4", "tag": tag, "shape": [B, H, W, C, C],
                   "splits": p["splits"], "plan": splits is None,
                   "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                   "max_diff": _common.max_diff(call(), want),
                   "ms": None, "device_ms": None}
            if timed:
                row.update(_times(call))
            rows.append(row)
        if timed:
            xc = x.permute(0, 3, 1, 2)
            w4 = conv3x3.transposed_upsample_weight(taps).contiguous(
                memory_format=torch.channels_last)
            rows.append({"kernel": "F.conv_transpose2d", "tag": tag,
                         "shape": [B, H, W, C, C],
                         **_times(lambda: F.conv_transpose2d(
                             xc, w4, b, stride=2, padding=1))})
    return rows


def _upstats_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, C, tag in shapes:
        x = torch.randn((B, H, W, C), generator=gen, device=device).bfloat16()
        w = (torch.randn((3, 3, C, C), generator=gen, device=device)
             * (9 * C) ** -0.5).bfloat16()
        b = (torch.randn(C, generator=gen, device=device) * 0.1).bfloat16()
        taps = conv3x3.fold_upsample_weights(w)
        want, want_st = gn_conv.upconv_stream_plain(x, w, b)
        chosen = gn_conv.upconv_sm90_plan(B, H, W, C, C, None, True)
        arms = [None] + ([1] if timed and chosen["splits"] > 1 else [])
        for splits in arms:
            p = gn_conv.upconv_sm90_plan(B, H, W, C, C, splits, True)
            if device == "cpu":  # the wrapper's CPU route: the plain version
                call = (lambda: gn_conv.upconv_stream(x, w, b, taps))
            else:
                call = (lambda splits=splits: gn_conv._upconv_stream(
                    x, b, taps, True, splits))
            got, st = call()
            rows.append({"kernel": "K6", "tag": tag, "shape": [B, H, W, C, C],
                         "splits": p["splits"], "plan": splits is None,
                         "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                         "max_diff": _common.max_diff(got, want),
                         "stats_max_diff": _common.max_diff(st, want_st),
                         **(_times(call) if timed
                            else {"ms": None, "device_ms": None})})
        if timed:
            xc = x.permute(0, 3, 1, 2)
            w4 = conv3x3.transposed_upsample_weight(taps).contiguous(
                memory_format=torch.channels_last)
            rows.append({"kernel": "F.conv_transpose2d", "tag": tag,
                         "shape": [B, H, W, C, C],
                         **_times(lambda: F.conv_transpose2d(
                             xc, w4, b, stride=2, padding=1))})
    return rows


def _split_choices(chunks):
    """Every split of `chunks` channel chunks into runs of whole chunks
    that the kernel can run, once each: the distinct ceil(chunks / per)."""
    return sorted({-(-chunks // per) for per in range(1, chunks + 1)})


def _same_inputs(B, H, W, cin, cout, gen, device):
    x = torch.randn((B, H, W, cin), generator=gen, device=device).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=device)
         * (9 * cin) ** -0.5).bfloat16()
    b = (torch.randn(cout, generator=gen, device=device) * 0.1).bfloat16()
    return x, w, b


def _conv2d_row(x, w, b, tag):
    """F.conv2d (channels-last, SAME) on the same inputs, timed."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return {"kernel": "F.conv2d", "tag": tag, "shape": list(x.shape) + [
        w.shape[-1]], **_times(lambda: F.conv2d(xc, wc, b, padding=1))}


def _same_rows(shapes, gen, device, timed):
    rows = []
    for B, H, W, cin, cout, tag in shapes:
        x, w, b = _same_inputs(B, H, W, cin, cout, gen, device)
        want = conv3x3.conv3x3_plain(x, w, b)
        chosen = gn_conv.same_sm90_plan(B, H, W, cin, cout)
        # the plan, then on the card every forced tile and split of K
        arms = [(None, None)]
        if timed:
            arms += [(nc, s) for nc in (1, 2)
                     for s in _split_choices(chosen["chunks"])]
        for nc, splits in arms:
            p = gn_conv.same_sm90_plan(B, H, W, cin, cout, nc, splits)
            if device == "cpu":  # the wrapper's CPU route: the plain version
                call = (lambda: conv3x3.conv3x3(x, w, b))
            else:
                call = (lambda nc=nc, splits=splits: conv3x3._conv3x3(
                    x, w, b, consumers=nc, splits=splits))
            rows.append({"kernel": "K7", "tag": tag,
                         "shape": [B, H, W, cin, cout],
                         "consumers": p["consumers"], "splits": p["splits"],
                         "plan": nc is None,
                         "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                         "max_diff": _common.max_diff(call(), want),
                         **(_times(call) if timed
                            else {"ms": None, "device_ms": None})})
        if timed:
            # the zero-code variant: K1/K5's kernel with no prologue,
            # residual or statistics (its windows copied through V)
            p = gn_conv.gn_conv_sm90_plan(B, H, W, cin, cout, cout, False)
            call = (lambda: gn_conv._gn_conv3x3(x, None, None, w, b, None,
                                                False, False)[0])
            rows.append({"kernel": "K1/K5 no prologue", "tag": tag,
                         "shape": [B, H, W, cin, cout],
                         "consumers": p["consumers"], "splits": p["splits"],
                         "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                         "max_diff": _common.max_diff(call(), want),
                         **_times(call)})
            rows.append(_conv2d_row(x, w, b, tag))
    return rows


def _served_same_rows(kernel, op):
    """Rows of a served wrapper of K7's function (K12a, K11) at its shape
    set under the plan: max|diff| against the plain version and against
    K7 (ops/conv3x3.py _conv3x3; 0 where both run one launch), F.conv2d
    beside."""
    def rows_of(shapes, gen, device, timed):
        rows = []
        for B, H, W, cin, cout, tag in shapes:
            x, w, b = _same_inputs(B, H, W, cin, cout, gen, device)
            p = gn_conv.same_sm90_plan(B, H, W, cin, cout)
            call = lambda: op(x, w, b)
            got = call()
            k7 = (conv3x3.conv3x3_plain(x, w, b) if device == "cpu"
                  else conv3x3._conv3x3(x, w, b))
            rows.append({"kernel": kernel, "tag": tag,
                         "shape": [B, H, W, cin, cout],
                         "consumers": p["consumers"], "splits": p["splits"],
                         "plan": True,
                         "ctas": p["m_tiles"] * p["n_tiles"] * p["splits"],
                         "max_diff": _common.max_diff(
                             got, conv3x3.conv3x3_plain(x, w, b)),
                         "k7_max_diff": _common.max_diff(got, k7),
                         **(_times(call) if timed
                            else {"ms": None, "device_ms": None})})
            if timed:
                rows.append(_conv2d_row(x, w, b, tag))
        return rows
    return rows_of


def _taps_rows(shapes, gen, device, timed):
    rows = []
    cv = conv_variants
    for nwin, h_t, W, cin, n, reps, tag in shapes:
        wp = W + 2 + (-(W + 2)) % 8
        xwin = torch.rand((nwin, h_t + 2, wp, cin), generator=gen,
                          device=device).bfloat16()
        w9 = torch.rand((9, cin, n), generator=gen, device=device).bfloat16()
        for read in cv.VARIANTS:
            wv = w9.view(3, 3 * cin, n) if read == "jointw" else w9
            want = cv.plain_conv_window_taps(xwin, wv, read, W=W, reps=reps)
            chosen = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n, read)
            # the plan, then on the card for `shifted` every forced tile
            # and split of K
            arms = [(None, None)]
            if timed and read == "shifted":
                arms += [(nc, s) for nc in (1, 2)
                         for s in _split_choices(chosen["chunks"])]
            for nc, splits in arms:
                p = gn_conv.taps_sm90_plan(nwin, h_t, W, wp, cin, n, read,
                                           nc, splits)
                if device == "cpu":  # the wrapper's CPU route: plain
                    call = (lambda: cv.conv_window_taps(xwin, wv, read, W=W,
                                                        reps=reps))
                else:
                    call = (lambda nc=nc, splits=splits:
                            cv._conv_window_taps(xwin, wv, read, W=W,
                                                 reps=reps, consumers=nc,
                                                 splits=splits))
                rows.append({"kernel": "T11", "tag": f"{tag} {read}",
                             "shape": [nwin, h_t, W, wp, cin, n, reps],
                             "consumers": p["consumers"],
                             "splits": p["splits"], "plan": nc is None,
                             "ctas": p["m_tiles"] * p["n_tiles"]
                             * p["splits"],
                             "max_diff": _common.max_diff(call(), want),
                             **(_times(call) if timed
                                else {"ms": None, "device_ms": None})})
        if timed:
            xc = xwin[:, :, :W + 2].permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            wc = w9.view(3, 3, cin, n).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            rows.append({"kernel": "F.conv2d", "tag": f"{tag} shifted",
                         "shape": [nwin, h_t, W, wp, cin, n, 1],
                         **_times(lambda: F.conv2d(xc, wc))})
    return rows


def _arms_rows(shapes, gen, device, timed):
    rows = []
    av = attention_variants
    for B, L, D, heads, tag in shapes:
        hd = D // heads
        q, k, v = (torch.randn((B, L, D), generator=gen, device=device)
                   .bfloat16() for _ in range(3))
        want = av.plain_nomax_allheads(q, k, v, heads)
        chosen = av.allheads_sm90_plan(hd, L, B)
        # the plan, then on the card every consumer count
        arms = [None] + (list(range(1, 4 if hd <= 48 else 3)) if timed
                         else [])
        for nc in arms:
            p = av.allheads_sm90_plan(hd, L, B, nc)
            if device == "cpu":  # the wrapper's CPU route: plain
                call = (lambda: av.nomax_allheads(q, k, v, heads))
            else:
                call = (lambda nc=nc: av._nomax_allheads(
                    q, k, v, heads, consumers=nc))
            rows.append({"kernel": "T7", "tag": tag,
                         "shape": [B, L, D, heads],
                         "consumers": p["consumers"], "ctas": p["ctas"],
                         "plan": nc is None,
                         "max_diff": _common.max_diff(call(), want),
                         **(_times(call) if timed
                            else {"ms": None, "device_ms": None})})
        p = attention.sm90_plan(hd, L, B * heads)
        head_major = [("T9", lambda: av.pvt_attention(q, k, v, heads),
                       av.plain_pvt_attention(q, k, v, heads))]
        if timed:
            head_major.append(("T7 head-major", lambda: av._nomax_allheads(
                q, k, v, heads, head_major=True), want))
        for kernel, call, plain in head_major:
            rows.append({"kernel": kernel, "tag": tag,
                         "shape": [B, L, D, heads],
                         "consumers": p["consumers"],
                         "ctas": -(-L // (64 * p["consumers"])) * B * heads,
                         "plan": kernel == "T9",
                         "max_diff": _common.max_diff(call(), plain),
                         **(_times(call) if timed
                            else {"ms": None, "device_ms": None})})
        rows += _exact_rows(B, L, D, heads, tag, q, k, v, timed)
        if timed:
            qh, kh, vh = (attention._split_heads(t, heads) for t in (q, k, v))
            rows.append({"kernel": "SDPA", "tag": tag,
                         "shape": [B, L, D, heads],
                         **_times(lambda: F.scaled_dot_product_attention(
                             qh, kh, vh))})
    return rows


# T3's rows: (tag, bk, bf16_p)
CHUNK_ROWS = [("chunk64", 64, False), ("chunk128", 128, False),
              ("chunk1024", 1024, False), ("chunk1024/bf16p", 1024, True)]


def _exact_rows(B, L, D, heads, tag, q, k, v, timed):
    """T1, T3 under CHUNK_ROWS where the chunk divides L, and the
    attention() route's K8 or K2 on the same data."""
    av = attention_variants
    hd = D // heads
    route = attention.attention_route(L, L, hd, q.dtype)
    base = (attention.flash_attention_streaming if route == "streaming"
            else attention.flash_attention)
    calls = [("K8/K2", lambda: base(q, k, v, heads),
              attention.plain_attention_streaming(q, k, v, heads), {}),
             ("T1", lambda: av.sublane_attention(q, k, v, heads),
              av.plain_sublane_attention(q, k, v, heads), {})]
    for name, bk, bf16_p in CHUNK_ROWS:
        if L % bk:
            continue
        p = av.chunked_sm90_plan(hd, L, B * heads, L, bk, bf16_p)
        call = (lambda bk=bk, bf16_p=bf16_p: av.chunked_attention(
            q, k, v, heads, bk=bk, bf16_p=bf16_p))
        calls.append((f"T3 {name}", call, av.plain_chunked_attention(
            q, k, v, heads, bk=bk, bf16_p=bf16_p),
            {f: p[f] for f in ("bkv", "chunk_tiles", "passes")}))
    rows = []
    for kernel, call, plain, plan in calls:
        rows.append({"kernel": kernel, "tag": tag, "shape": [B, L, D, heads],
                     **plan, "max_diff": _common.max_diff(call(), plain),
                     **(_times(call) if timed
                        else {"ms": None, "device_ms": None})})
    return rows


def main(argv=None) -> int:
    args = _common.parse_args(
        __doc__, SHAPE_SETS, "stamp", argv,
        extra=[("--rows", dict(default="attention,downconv,gn_conv,moments",
                               help="row groups to run, comma-separated"))])
    ok, card = _common.open_device(args, "sm90_plans")
    if not ok:
        return 1
    gen = torch.Generator(device=args.device).manual_seed(0)
    timed = args.device == "cuda"
    sets = SHAPE_SETS[args.shapes]
    groups = {"attention": _attention_rows, "downconv": _downconv_rows,
              "gn_conv": _gn_conv_rows, "moments": _moments_rows,
              "ff": _ff_rows, "upconv": _upconv_rows,
              "upstats": _upstats_rows, "same": _same_rows,
              "inpad": _served_same_rows("K12a", conv3x3.conv3x3_inpad),
              "stream": _served_same_rows("K11", conv3x3.conv3x3_stream),
              "taps": _taps_rows, "arms": _arms_rows}
    rows = []
    with torch.inference_mode():
        for name in args.rows.split(","):
            rows += groups[name](sets[name], gen, args.device, timed)
    for r in rows:
        print(f"{r['kernel']:18s} {r['tag']:28s} "
              + (f"bucket {r['bucket']} " if "bucket" in r else "")
              + (f"consumers {r['consumers']} " if "consumers" in r else "")
              + (f"splits {r['splits']} " if "splits" in r else "")
              + (f"bands {r['bands']} " if "bands" in r else "")
              + (f"ctas {r['ctas']} " if "ctas" in r else "")
              + (f"bkv {r['bkv']} tiles a chunk {r['chunk_tiles']} "
                 if "chunk_tiles" in r else "")
              + ("(plan) " if r.get("plan") else "")
              + f"{_common.fmt(r['ms'], '.4f')} ms, device "
              + f"{_common.fmt(r['device_ms'], '.4f')} ms"
              + (f", max|diff| {r['max_diff']:.3e}" if "max_diff" in r
                 else "")
              + (f", against K7 {r['k7_max_diff']:.3e}"
                 if "k7_max_diff" in r else ""), flush=True)
    return _common.emit(args, card, rows)


if __name__ == "__main__":
    raise SystemExit(main())
