"""Eager and CUDA-graph device time of the served K3, K1, K5, K4, K6, K7,
K12a, K11, K12b, K8 and K2 wrappers at their served shapes, of the T4, T10,
T11, T7, T9, T1, T3, T2, T5, T6 and T8 arms and of K10 and T12 at their
paths' shapes, for comparing two checkouts on one card.

    python diffusiontexturepainting_torch/tools/kernel_ab.py --json-out A.json
    PYTHONPATH=<another checkout> python \\
        diffusiontexturepainting_torch/tools/kernel_ab.py --json-out B.json

Run by path, the script imports the package found first on PYTHONPATH (or
its own checkout's), so the same script times another checkout's kernels
through the wrappers both share: ops.ff_geglu.ff_geglu (K3) at one UNet
eval's feed-forward shapes at 256^2, 512^2 and 1024^2,
ops.gn_conv.gn_conv_resident (K1, statistics on) at K10's resnet shapes
(RESNET_K10: conv1 without, conv2 with the residual) and
ops.gn_conv.gn_conv_stream (K5, no residual or statistics) at T12's
(CONV_ARMS), the kernels K10 and T12 share their body with,
ops.conv3x3.upsample2x_conv3x3 (K4) at the UNet's upsample shapes at the
same points, ops.gn_conv.upconv_stream (K6, statistics on) at the VAE
decoder's three upsamplers at the same points (batch 1), and
ops.conv3x3.conv3x3 (K7) at every shape the safe twin's 256^2 stamp runs
it at (TWIN_K7), the same call with ops.conv3x3._IN_PAD set (K12a, as the
twin_inpad path runs it) at the same shapes, ops.conv3x3.conv3x3_stream
(K11) at those of them that pass streaming_plan's shape test (TWIN_K11),
ops.conv3x3.upsample2x_conv3x3 at the safe twin's 256^2 K4 shapes
(TWIN_K4) with _IN_PAD off (K4) and set (K12b, as the twin_inpad path
runs it), F.conv_transpose2d on the assembled 4x4 weight beside,
ops.attention.flash_attention_streaming (K8) and flash_attention (K2) at
the 1024^2/4 stamp's three UNet self-attention shapes (ATTN: K8 at level
0, K2 at levels 1 and 2, each 20 calls a stamp),
ops.attention.flash_attention_slotted (K13) at the slotted 512^2/4 stamp's
two K13 shapes, ops.attention_variants.slotted_kernel_call (T4) at the
slotted 512^2/4 stamp's two K13 shapes as (B*h, L, 128) slots (hd 40 and
80 real lanes) in both softmax flavours, and
ops.attention_variants.pv_product (T10) at the TPU tool's three shapes, bh
1, 64 passes, both orientations (PV), and
ops.conv_variants.conv_window_taps (T11), each of its four reads, at the
conv_arms path's windows (TAPS_ARMS: the default 256^2/20 stamp's K5
images with a prologue cut into windows of 8 rows, reps 1) and at the TPU
tool's three shapes (TAPS_TOOL: one window, reps 24), F.conv2d (VALID,
channels-last) on the same windows beside `shifted`, then
ops.attention_variants.nomax_allheads (T7), pvt_attention (T9),
sublane_attention (T1) and chunked_attention (T3) at chunks of 64 and 128
keys, then of 1024 keys with fp32 and bf16 p (a tree whose wrapper lacks
chunked_sm90_plan, whose kernel takes chunks of 64 and 128 keys only,
prints that it skips them) at ATTN (the attn_arms path's shapes and
calls), SDPA beside, nomax_attention (T2) in the entry point's three forms
(`T2 safe`, the attn_arms path's; `T2`, unclamped; `T2/bf16p`) and
nomax_unpadded (T5, its copies of the heads included), nomax_4d (T6) and
nomax_laneslice (T8) at ATTN, and last, the kernels this tree may differ
in: ops.conv3x3.gn_silu_conv3x3 (K10) at the resnet_bodies path's 44
calls (RESNET_K10: one UNet eval's 22 resnet bodies at 256^2, batch 3,
conv1 with temb and conv2 with the residual, 32 groups) and
ops.conv_variants.pipelined (T12) at the conv_arms path's 50 calls
(CONV_ARMS: the default 256^2/20 stamp's K5 launches with a prologue).
Seeded normal bf16 inputs (T10,
T11: the tools' uniform ones). Each row: ms a call (CUDA
events over back-to-back calls, best of 4: the host's launch cost
included), device_ms (the same calls replayed from a CUDA graph) and a
digest of the output's bits (two checkouts' rows compare bit for bit); the
K12b and T11 rows also their launches a stamp (`count`), and the run
ends with each read's T11 sums over a conv_arms stamp, the attention
rows' sums over the attn_arms path, K10's over the resnet_bodies path and
T12's over the conv_arms path. Without a card it
exits nonzero. Prints one line per row, then one JSON line naming the
package's path.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    # run by path: the checkout holding this script comes after PYTHONPATH
    sys.path.append(str(Path(__file__).resolve().parents[2]))

import diffusiontexturepainting_torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from diffusiontexturepainting_torch.ops import (  # noqa: E402
    attention,
    attention_variants,
    conv3x3,
    conv_variants,
    ff_geglu,
    gn_conv,
)
from diffusiontexturepainting_torch.tools import _common  # noqa: E402

# (N, C, inner, tag): K3; (B, H, W, C, tag): K4's source and channels
FF = [(n, c, 4 * c, f"{res}^2 UNet {level}")
      for res, n0 in ((256, 3072), (512, 12288), (1024, 49152))
      for n, c, level in ((n0, 320, "level 0"), (n0 // 4, 640, "level 1"),
                          (n0 // 16, 1280, "level 2"),
                          (n0 // 64, 1280, "mid block"))]
UP = [(3, h, h, c, f"{res}^2 UNet up {level}")
      for res, h0 in ((256, 4), (512, 8), (1024, 16))
      for h, c, level in ((h0, 1280, "level 3"), (2 * h0, 1280, "level 2"),
                          (4 * h0, 640, "level 1"))]
# (B, H, W, C, tag): K6's sources, the VAE decoder's upsamplers
UPSTATS = [(1, h, h, c, f"{res}^2 VAE up {level}")
           for res, h0 in ((256, 32), (512, 64), (1024, 128))
           for h, c, level in ((h0, 512, "0"), (2 * h0, 512, "1"),
                               (4 * h0, 256, "2"))]
# (B, H, W, Cin, Cout, tag): K7 at the safe twin's 256^2 stamp (its 22 UNet
# resnets at batch 3, the VAE encoder's at batch 2, the decoder's at 1)
TWIN_K7 = [
    *[(3, h, h, cin, cout, f"UNet {h}^2 {cin}->{cout}")
      for h, cin, cout in ((32, 320, 320), (32, 640, 320), (32, 960, 320),
                           (16, 320, 640), (16, 640, 640), (16, 960, 640),
                           (16, 1280, 640), (16, 1920, 640),
                           (8, 640, 1280), (8, 1280, 1280),
                           (8, 1920, 1280), (8, 2560, 1280),
                           (4, 1280, 1280), (4, 2560, 1280))],
    *[(2, h, h, cin, cout, f"VAE enc {h}^2 {cin}->{cout}")
      for h, cin, cout in ((256, 128, 128), (128, 128, 256),
                           (128, 256, 256), (64, 256, 512), (64, 512, 512),
                           (32, 512, 512))],
    *[(1, h, h, cin, cout, f"VAE dec {h}^2 {cin}->{cout}")
      for h, cin, cout in ((32, 512, 512), (64, 512, 512), (128, 512, 256),
                           (128, 256, 256), (256, 256, 128),
                           (256, 128, 128))]]
# K11 at the twin's K7 shapes that pass the JAX package's streaming_plan
# shape test (H >= 8, W >= 2, Cin >= 16, Cout >= 128): all but the 4x4 level
TWIN_K11 = [s for s in TWIN_K7
            if s[1] >= 8 and s[2] >= 2 and s[3] >= 16 and s[4] >= 128]
# (B, H, W, C, launches a stamp): K4 at the safe twin's 256^2/4 stamp (the
# UNet's three upsamplers at batch 3, each step; the VAE decoder's three):
# K12b's shapes on the twin_inpad path
TWIN_K4 = [(3, 4, 4, 1280, 4), (3, 8, 8, 1280, 4), (3, 16, 16, 640, 4),
           (1, 32, 32, 512, 1), (1, 64, 64, 512, 1), (1, 128, 128, 256, 1)]
# (nwin, H_T, W, Cin, N, launches a stamp): T11 on the conv_arms path: the
# default 256^2/20 stamp's K5 calls with a prologue (the VAE encoder's at
# batch 2, the decoder's at 1), each image as (1, B*H, W, Cin) cut into
# windows of 8 rows
TAPS_ARMS = [(64, 8, 256, 128, 128, 4), (32, 8, 128, 128, 256, 1),
             (32, 8, 128, 256, 256, 3), (16, 8, 64, 256, 512, 1),
             (16, 8, 64, 512, 512, 3), (8, 8, 32, 512, 512, 8),
             (8, 8, 32, 512, 8, 1), (4, 8, 32, 512, 512, 10),
             (8, 8, 64, 512, 512, 6), (16, 8, 128, 512, 256, 1),
             (16, 8, 128, 256, 256, 5), (32, 8, 256, 256, 128, 1),
             (32, 8, 256, 128, 128, 5), (32, 8, 256, 128, 3, 1)]
# (B, H, W, Cin, Cout, launches a path): T12 on the conv_arms path, the
# images TAPS_ARMS cuts into windows (B from the windows' rows)
CONV_ARMS = [(nwin * h_t // W, W, W, cin, n, count)
             for nwin, h_t, W, cin, n, count in TAPS_ARMS]
# (H, Cin, Cout, temb, residual, launches a path): K10 on the
# resnet_bodies path, one UNet eval's 22 resnet bodies at 256^2 (batch 3,
# latent 32): conv1 with the time embedding, conv2 with the residual
RESNET_K10 = [
    (32, 320, 320, True, False, 2), (32, 960, 320, True, False, 1),
    (32, 640, 320, True, False, 2), (16, 320, 640, True, False, 1),
    (16, 640, 640, True, False, 1), (16, 1920, 640, True, False, 1),
    (16, 1280, 640, True, False, 1), (16, 960, 640, True, False, 1),
    (8, 640, 1280, True, False, 1), (8, 1280, 1280, True, False, 1),
    (8, 2560, 1280, True, False, 2), (8, 1920, 1280, True, False, 1),
    (4, 1280, 1280, True, False, 4), (4, 2560, 1280, True, False, 3),
    (32, 320, 320, False, True, 5), (16, 640, 640, False, True, 5),
    (8, 1280, 1280, False, True, 5), (4, 1280, 1280, False, True, 7)]
# (nwin, H_T, W, Cin, N, reps): T11 at the TPU tool's three shapes
TAPS_TOOL = [(1, 16, 128, 512, 128, 24), (1, 8, 256, 256, 256, 24),
             (1, 8, 512, 128, 128, 24)]
TAP_READS = ("shifted", "unshifted", "rowflat", "jointw")
# (B*h, L, real lanes): T4 at the slotted 512^2/4 stamp's K13 shapes
SLOTTED = [(24, 4096, 40), (24, 1024, 80)]
# (B, L, D, heads, kernel, tag): the 1024^2/4 stamp's UNet self-attentions,
# each 20 calls a stamp, with the route attention() takes there
ATTN = [(3, 16384, 320, 8, "K8", "1024^2 L0"),
        (3, 4096, 640, 8, "K2", "1024^2 L1"),
        (3, 1024, 1280, 8, "K2", "1024^2 L2")]
ATTN_CALLS = 20
# (bk, bf16_p): T3's chunks at ATTN
CHUNKS = [(64, False), (128, False), (1024, False), (1024, True)]
# (row, safe, bf16_p): T2's forms at ATTN, the attn_arms path's first
NOMAX = [("T2 safe", True, False), ("T2", False, False),
         ("T2/bf16p", False, True)]
# (bq, Lk, hd): T10 at the TPU tool's shapes, bh 1, PV_ITERS passes
PV = [(512, 4096, 40), (512, 1024, 80), (256, 256, 160)]
PV_ITERS = 64


def _rows(gen):
    rows = []
    rnd = lambda *s, std=1.0: (torch.randn(s, generator=gen, device="cuda")
                               * std).bfloat16()

    def row(kernel, tag, shape, call, count=None):
        rows.append({"kernel": kernel, "tag": tag, "shape": shape,
                     "digest": digest(call()),
                     "ms": _common.event_ms(call),
                     "device_ms": _common.graph_ms(call),
                     **({} if count is None else {"count": count})})

    for N, C, inner, tag in FF:
        x, res = rnd(N, C), rnd(N, C)
        w0, b0 = rnd(2 * inner, C, std=C**-0.5), rnd(2 * inner, std=0.1)
        w2, b2 = rnd(C, inner, std=inner**-0.5), rnd(C, std=0.1)
        row("K3", tag, [N, C, inner],
            lambda: ff_geglu.ff_geglu(x, w0, b0, w2, b2, res))
    for H, cin, cout, _, has_res, _ in RESNET_K10:
        x = rnd(3, H, H, cin)
        a = torch.randn((3, cin), generator=gen, device="cuda") * 0.2 + 1
        c = torch.randn((3, cin), generator=gen, device="cuda") * 0.2
        w, b = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout,
                                                                 std=0.1)
        r = rnd(3, H, H, cout) if has_res else None
        row("K1", f"{H}^2 {cin}->{cout}" + (" res" if has_res else ""),
            [3, H, H, cin, cout],
            lambda: gn_conv.gn_conv_resident(x, a, c, w, b, r, True))
    for B, H, W, cin, cout, _ in CONV_ARMS:
        x = rnd(B, H, W, cin)
        a = torch.randn((B, cin), generator=gen, device="cuda") * 0.2 + 1
        c = torch.randn((B, cin), generator=gen, device="cuda") * 0.2
        w, b = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout,
                                                                 std=0.1)
        wk, bk = gn_conv.pad_cout(w, b)
        extra = dict(out_channels=cout) if wk is not w else {}
        row("K5", f"conv_arms {B}x{H}x{W} {cin}->{cout}",
            [B, H, W, cin, cout],
            lambda: gn_conv.gn_conv_stream(x, a, c, wk, bk, None, False,
                                           True, **extra))
    for B, H, W, C, tag in UP:
        x = rnd(B, H, W, C)
        w, b = rnd(3, 3, C, C, std=(9 * C) ** -0.5), rnd(C, std=0.1)
        taps = conv3x3.fold_upsample_weights(w)
        row("K4", tag, [B, H, W, C, C],
            lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps))
    for B, H, W, C, tag in UPSTATS:
        x = rnd(B, H, W, C)
        w, b = rnd(3, 3, C, C, std=(9 * C) ** -0.5), rnd(C, std=0.1)
        taps = conv3x3.fold_upsample_weights(w)
        row("K6", tag, [B, H, W, C, C],
            lambda: gn_conv.upconv_stream(x, w, b, taps))
    same = [(s, rnd(*s[:4]), rnd(3, 3, *s[3:5], std=(9 * s[3]) ** -0.5),
             rnd(s[4], std=0.1)) for s in TWIN_K7]
    # K7's rows in one run, then K12a's, then K11's: a row's time follows
    # the card's load before it, so K7 (code both trees of an A/B share)
    # is not timed right after a kernel that differs between them
    for (B, H, W, cin, cout, tag), x, w, b in same:
        row("K7", tag, [B, H, W, cin, cout],
            lambda: conv3x3.conv3x3(x, w, b))
    # K12a: conv3x3 as the twin_inpad path calls it, _IN_PAD set
    conv3x3._IN_PAD = True
    try:
        for (B, H, W, cin, cout, tag), x, w, b in same:
            row("K12a", tag, [B, H, W, cin, cout],
                lambda: conv3x3.conv3x3(x, w, b))
    finally:
        conv3x3._IN_PAD = False
    for s, x, w, b in same:
        if s in TWIN_K11:
            row("K11", s[5], list(s[:5]),
                lambda: conv3x3.conv3x3_stream(x, w, b))
    # K4 then K12b at the twin's K4 shapes (K4's rows first, as K7's),
    # F.conv_transpose2d beside
    ups = []
    for B, H, W, C, count in TWIN_K4:
        x = rnd(B, H, W, C)
        w, b = rnd(3, 3, C, C, std=(9 * C) ** -0.5), rnd(C, std=0.1)
        ups.append(((B, H, W, C, count), x, w, b,
                    conv3x3.fold_upsample_weights(w)))
    for (B, H, W, C, count), x, w, b, taps in ups:
        row("K4", f"twin {H}^2 {C}", [B, H, W, C, C],
            lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps), count)
    conv3x3._IN_PAD = True
    try:
        for (B, H, W, C, count), x, w, b, taps in ups:
            row("K12b", f"twin {H}^2 {C}", [B, H, W, C, C],
                lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps), count)
    finally:
        conv3x3._IN_PAD = False
    for (B, H, W, C, count), x, w, b, taps in ups:
        xc = x.permute(0, 3, 1, 2)
        w4 = conv3x3.transposed_upsample_weight(taps).contiguous(
            memory_format=torch.channels_last)
        row("F.conv_transpose2d", f"twin {H}^2 {C}", [B, H, W, C, C],
            lambda: F.conv_transpose2d(xc, w4, b, stride=2, padding=1),
            count)
    for nwin, h_t, W, cin, n, extra in TAPS_ARMS + TAPS_TOOL:
        arms = (nwin, h_t, W, cin, n, extra) in TAPS_ARMS
        reps, count = (1, extra) if arms else (extra, 1)
        wp = W + 2 + (-(W + 2)) % 8
        xwin = torch.rand((nwin, h_t + 2, wp, cin), generator=gen,
                          device="cuda").bfloat16()
        w9 = torch.rand((9, cin, n), generator=gen, device="cuda").bfloat16()
        where = "conv_arms" if arms else "tool"
        for read in TAP_READS:
            wv = w9.view(3, 3 * cin, n) if read == "jointw" else w9
            row("T11", f"{where} {read} {nwin}x{h_t}x{W}", [
                nwin, h_t + 2, wp, cin, n, W, reps, read],
                lambda: conv_variants.conv_window_taps(
                    xwin, wv, read, W=W, reps=reps), count)
        xc = xwin[:, :, :W + 2].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wc = w9.view(3, 3, cin, n).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row("F.conv2d", f"{where} shifted {nwin}x{h_t}x{W}",
            [nwin, h_t + 2, wp, cin, n, W, 1, "shifted"],
            lambda: F.conv2d(xc, wc), count)
    attn = [(B, L, D, heads, name, tag,
             *(rnd(B, L, D) for _ in range(3)))
            for B, L, D, heads, name, tag in ATTN]
    for B, L, D, heads, name, tag, q, k, v in attn:
        fn = (attention.flash_attention_streaming if name == "K8"
              else attention.flash_attention)
        row(name, tag, [B, L, D, heads], lambda: fn(q, k, v, heads),
            ATTN_CALLS)
    for BH, L, hd in SLOTTED:
        q, k, v = (torch.zeros((BH, L, 128), device="cuda").bfloat16()
                   for _ in range(3))
        for t in (q, k, v):
            t[..., :hd] = rnd(BH, L, hd)
        # K13 on the same slots in the (B, L, h*128) layout, 8 heads
        qm, km, vm = (attention_variants.merge_heads(t, BH // 8)
                      for t in (q, k, v))
        row("K13", f"slotted {L} hd {hd}", [BH // 8, L, 8 * 128, hd],
            lambda: attention.flash_attention_slotted(qm, km, vm, 8, hd))
        for exp2_bf16 in (True, False):
            row("T4", f"slotted {L} hd {hd}" + ("" if exp2_bf16 else " f32p"),
                [BH, L, 128, hd, exp2_bf16],
                lambda: attention_variants.slotted_kernel_call(
                    q, k, v, hd**-0.5, exp2_bf16=exp2_bf16))
    for bq, lk, hd in PV:
        e = torch.rand((1, bq, lk), generator=gen, device="cuda").bfloat16()
        v = torch.rand((1, lk, hd), generator=gen, device="cuda").bfloat16()
        for transposed in (False, True):
            row("T10", f"({bq}, {lk}, {hd}) "
                + ("v^T@e^T" if transposed else "e@v"),
                [1, bq, lk, hd, transposed, PV_ITERS],
                lambda: attention_variants.pv_product(
                    e, v, transposed=transposed, iters=PV_ITERS))
    for name, arm in (("T7", attention_variants.nomax_allheads),
                      ("T9", attention_variants.pvt_attention),
                      ("T1", attention_variants.sublane_attention)):
        for B, L, D, heads, _, tag, q, k, v in attn:
            row(name, tag, [B, L, D, heads], lambda: arm(q, k, v, heads),
                ATTN_CALLS)
    # T3: the chunks both kernels take, then the TPU tool's default chunk
    wide = hasattr(attention_variants, "chunked_sm90_plan")
    for bk, bf16_p in CHUNKS:
        name = f"T3 chunk{bk}" + ("/bf16p" if bf16_p else "")
        if bk > 128 and not wide:
            print(f"{name}: skipped, this tree's kernel takes chunks of 64 "
                  "and 128 keys only", flush=True)
            continue
        for B, L, D, heads, _, tag, q, k, v in attn:
            row(name, tag, [B, L, D, heads, bk, bf16_p],
                lambda: attention_variants.chunked_attention(
                    q, k, v, heads, bk=bk, bf16_p=bf16_p), ATTN_CALLS)
    for B, L, D, heads, _, tag, q, k, v in attn:
        qh, kh, vh = (t.view(B, L, heads, D // heads).transpose(1, 2)
                      for t in (q, k, v))
        row("SDPA", tag, [B, L, D, heads],
            lambda: F.scaled_dot_product_attention(qh, kh, vh), ATTN_CALLS)
    for name, safe, bf16_p in NOMAX:
        for B, L, D, heads, _, tag, q, k, v in attn:
            row(name, tag, [B, L, D, heads, safe, bf16_p],
                lambda: attention_variants.nomax_attention(
                    q, k, v, heads, safe=safe, bf16_p=bf16_p), ATTN_CALLS)
    for name, arm in (("T5", attention_variants.nomax_unpadded),
                      ("T6", attention_variants.nomax_4d),
                      ("T8", attention_variants.nomax_laneslice)):
        for B, L, D, heads, _, tag, q, k, v in attn:
            row(name, tag, [B, L, D, heads], lambda: arm(q, k, v, heads),
                ATTN_CALLS)
    for H, cin, cout, has_temb, has_res, count in RESNET_K10:
        x = rnd(3, H, H, cin) + 0.3
        scale, shift = rnd(cin, std=0.2) + 1, rnd(cin, std=0.2)
        w, b = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout,
                                                                 std=0.1)
        t = rnd(3, cout) if has_temb else None
        r = rnd(3, H, H, cout) if has_res else None
        row("K10", f"{H}^2 {cin}->{cout}" + (" temb" if has_temb else "")
            + (" res" if has_res else ""), [3, H, H, cin, cout],
            lambda: conv3x3.gn_silu_conv3x3(x, scale, shift, w, b, t, r, 32),
            count)
    for B, H, W, cin, cout, count in CONV_ARMS:
        x = rnd(B, H, W, cin)
        w, b = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout,
                                                                 std=0.1)
        a = torch.randn((B, cin), generator=gen, device="cuda") * 0.2 + 1
        c = torch.randn((B, cin), generator=gen, device="cuda") * 0.2
        row("T12", f"conv_arms {B}x{H}x{W} {cin}->{cout}",
            [B, H, W, cin, cout],
            lambda: conv_variants.pipelined(x, a, c, w, b), count)
    return rows


def digest(out) -> str:
    """A hash of the bits of a call's output (every tensor of a tuple)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def stamp_sums(rows):
    """{name: (ms, device_ms)}: count-weighted sums of the rows that carry
    launches a stamp: K4, K12b and F.conv_transpose2d over the twin's K4
    shapes; each T11 read and F.conv2d over the conv_arms path's windows;
    K8, K2, T7, T9, T1, each T3 chunk, SDPA, each T2 form, T5, T6 and T8
    over the attn_arms path; K10 over the resnet_bodies path; T12 over the
    conv_arms path."""
    sums = {}
    for r in rows:
        if "count" not in r or r["tag"].startswith("tool"):
            continue
        name = r["kernel"] + ("" if r["kernel"] not in ("T11", "F.conv2d")
                              else " " + r["tag"].split()[1])
        ms, device_ms = sums.get(name, (0.0, 0.0))
        sums[name] = (ms + r["count"] * r["ms"],
                      device_ms + r["count"] * r["device_ms"])
    return sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    package = str(Path(diffusiontexturepainting_torch.__file__).parent)
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); package "
          f"{package}", flush=True)
    with torch.inference_mode():
        rows = _rows(torch.Generator(device="cuda").manual_seed(0))
    for r in rows:
        print(f"{r['kernel']} {r['tag']:28s} {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, bits {r['digest']}", flush=True)
    stamp = stamp_sums(rows)
    for name, (ms, device_ms) in stamp.items():
        print(f"{name}: {ms:.4f} ms a stamp, device {device_ms:.4f} ms",
              flush=True)
    record = {"device": torch.cuda.get_device_name(0), "card": card,
              "package": package, "rows": rows, "stamp": stamp}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
