#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own lines; any failure raises (nonzero exit):
  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc builds every kernel from csrc/, in parallel, seconds
               printed; ptxas's registers and spills, none allowed in the
               bf16 K2/K8/K13 kernel (csrc/flash_attention_sm90.cu), the
               bf16 K9 kernel (csrc/conv_sm90.cu), the bf16 K1/K5, K4, K6
               and K7 kernels (csrc/gn_conv_sm90.cu), the bf16 K3 kernel
               (csrc/ff_geglu_sm90.cu) or the bf16 T10 kernel
               (csrc/pv_product_sm90.cu);
  3. probe     each kernel against its plain version at a few shapes,
               K2 at its four launched head dims (40, 80, 160, 512) and a
               ragged length, the 16384-token streaming attentions (K8)
               and a ragged hd-512 one, the slotted attentions of 256^2 and
               512^2 (K13), K9 at the default stamp's three shapes and
               ragged and odd ones, K1/K5 at ragged shapes (Cin 96 ->
               Cout 40 on 4x4 images at batch 3, odd H and W, the VAE's
               Cout 8 and 3 heads) and on the split concat conv's weight
               halves read in place, and the spatial moments (K14) among
               them, K6 and K7 at ragged shapes; K9, K1/K5, K14, K6 and K7
               bit-identical on replay, output and statistics; K6's
               statistics also against its own fp32 output before the
               rounding; T10 and T4 bit-identical on replay; the bf16
               K2/K8/K13, K9, K1/K5, K3, K4, K6, K7, T10 and T4 refuse what
               TMA cannot describe (ValueError, no launch); the fp32 entries
               of csrc/conv3x3.cu, T10's (attn_transposed.cu) and T4's
               (attn_layouts.cu) refuse bf16;
  4. default   the served configuration (PipelineConfig(): every fused
               switch on): full-width SD-1.5 (seeded random weights, bf16)
               at 256^2 / 20 DDIM steps: one NEW_BRUSH_IMAGE and three
               NEW_STAMP requests as wire bytes through the port's request
               handler (serving/wire.py), plus a replay of the first stamp
               that must be bit-identical, each reply checked; then each
               kernel's launches in that run against the count derived from
               the configuration;
  5. twin      the same for the "safe twin" (every fused switch off, module
               legs only), built from the default model's state_dict, at
               4 DDIM steps; then the first stamps of the two
               configurations at equal steps, compared in u8;
  5b. twin_inpad
               the twin again with the port's _IN_PAD switch set (the
               in-kernel-padding kernels K12a/b take every call of K7/K4),
               as phase 4; its first stamp against the twin's;
  5c. resnet_bodies
               the 22 resnets of one UNet eval of the twin at 256^2 (batch
               3, their inputs captured from the module legs), each as two
               gn_silu_conv3x3 calls (K10), held against the module leg in
               bf16 and fp32; and K11 (conv3x3_stream) as often as the twin
               ran K7, at each of its K7 shapes that pass the JAX package's
               streaming_plan shape test;
  6. server    the port's server (serving/server.py) on loopback around
               the default model: GET /health, then a NEW_BRUSH_IMAGE, a
               NEW_BRUSH_PROMPT and a NEW_STAMP over a websocket, each reply
               byte-equal to the request handler's at the same request
               counter;
  6b. session  a stroke session on the default model at 256^2 / 4 steps
               through the request handler: BEGIN_SESSION on a 512^2
               canvas, four STAMP_ATs that return no pixels (one
               overpainting, one clamped; enqueued with host syncs made an
               error, their acknowledgement times beside the stroke's
               synchronized wall), one that returns its pixels, ERASE_AT,
               FETCH_CANVAS, END_SESSION; the kernels' launches against the
               configuration; the fetched canvas byte-equal to the host
               oracle (each stamp's crop replayed through generate_u8 at its
               request counter, host_stamp_update and the erase rule); then
               the same bytes over the server's websocket, every reply
               byte-equal, with RETURN_ERROR for a STAMP_AT before
               BEGIN_SESSION and for a second connection's BEGIN_SESSION;
  7. envelope  the default configuration at 1024^2 / 4 DDIM steps (the
               engine envelope: 16384-token attention through K8), as
               phase 4, with its peak device memory;
  8. slotted   slotted_config() (head-slotted self-attention, K13) at
               512^2 / 4 steps, as phase 4; its first stamp against the
               default configuration's at 512^2 / 4, compared in u8;
  9a. attn_arms
               eight arms of the attention kernels through the A/B entry
               point's functions (diffusiontexturepainting_torch.tools.
               attn_variants): the softmax arms T2 no-max, T3 chunked, T5
               unpadded no-max (heads split by one copy pass) and T9
               transposed P V (csrc/attn_arms.cu), and the head-layout arms
               T6 (heads read in place, head-major blocks), T7 (all heads in
               one block) and T8 (head fastest) (csrc/attn_layouts.cu), and
               T1 (both products transposed, the exact row-max softmax;
               csrc/attn_transposed.cu), at
               the 1024^2 / 4 stamp's three UNet self-attention shapes, each
               launched as often as that stamp launches K8/K2 there (20 a
               shape), each output against the attention() route's; the
               clamp probe (raw logits above 83: the clamped arms equal
               their plain versions and differ from the exact softmax of K8,
               which rounds q as the arms do; T3 and T1 equal it) and the
               underflow probe (every exp2 underflows: zeros from the safe
               arms, no NaN);
  9b. slotted_arm
               the slotted-input arm T4 (slotted_kernel_call: the row-max
               softmax with exp2 of bf16 logits over (B*h, L, 128) head
               slots; bf16 on K13's two-pass kernel in
               csrc/flash_attention_sm90.cu) at the slotted path's K13 shapes
               (512^2 / 4: 4096 tokens at hd 40, 1024 at hd 80), each as
               often as a stamp launches K13 there (20 a shape), the slots
               split outside the counted calls; each output against its
               plain version and against K13 on the same data;
  9c. pv_product
               T10 (pv_product: the P V product alone, PV_ITERS passes a
               call; bf16 on csrc/pv_product_sm90.cu) at the TPU tool's three
               shapes (bq, Lk, hd) with bh 1, as e v and as (v^T e^T)^T,
               one call each, each against its plain version, the two
               orientations against each other;
  9d. conv_arms
               the conv arms (csrc/conv_arms.cu) at every shape at which
               the default 256^2 / 20 stamp launches K5 with its prologue,
               as often as one stamp launches K5 there: T12 (pipelined:
               conv3x3_VALID(silu(pad(x)*a + c)) + b) on seeded images of
               those shapes, against its plain version and, away from the
               border, against K5; T11 (conv_window_taps) on the same
               images cut into row windows of 8 rows with halo, each of its
               four tap reads, against its plain version, `shifted` also
               against K11 on the image;
  9. kernels   each kernel against its plain version at every shape any
               path launched it at, in bf16 and fp32 (TF32 off),
               statistics included; CUDA-event times of the kernel, its
               plain version and the one PyTorch call that computes the
               same function where there is one (for K1/K5 and K9 the conv
               alone), at the shapes of the path it is reported for, beside
               its bound (K2, K3, K4, K6, K9, K1, K5 and K14 also at the
               envelope path's; K1/K5, K14, K3, K4, K6, K7, T4 and T10
               also in CUDA-graph device time; T10 also beside a chain of
               PV_ITERS torch.baddbmm calls, as many products);
 10. no jax    the run imported neither JAX, nor the JAX package, nor
               tornado, nor PIL.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time
from collections import Counter

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
RES, STEPS, TWIN_STEPS = 256, 20, 4
ENVELOPE_RES, SLOTTED_RES, FEW_STEPS = 1024, 512, 4
# Published peaks of one H100 SXM (dense): the bounds of the kernels' work
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def settings(steps, res=RES):
    return dict(steps=steps, width=res, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=steps, context_pad=150)


# Tolerance relative to the output's largest magnitude. bf16 products
# accumulate in fp32 in both versions but round at other places (the plain
# convs round before their bias add, the plain attention rounds normalized
# probabilities, the plain GroupNorm prologue rounds the affine's product
# and sum apart): 2^-5 of the largest output is 4 to 8 bf16 ulps at that
# magnitude. fp32: accumulation order only. Statistics: the same fraction
# of the sum of |y| (row 0) or of y^2 (row 1) over the pixels, the scale
# that bounds their rounding error.
TOL = {"bfloat16": 2.0**-5, "float16": 2.0**-5, "float32": 1e-4}
# K1/K5's and K14's statistics are also held against those of the kernel's
# own output, per (image, channel): only the fp32 order of summation may
# differ there, so the bound is far below TOL's, a fraction of that entry's
# sum of |y| (row 0) or of y^2 (row 1). The probes' images differ from one
# another (per_image), so two images' statistics swapped inside a tile, or
# one tile partial dropped (1/512 of an image at the 1024^2 VAE), exceed it.
STATS_SELF_TOL = 2.0**-14
STATS_SELF_KINDS = ("gn_conv_resident", "gn_conv_stream", "spatial_moments")
# K6 takes its statistics before the rounding: they are held, at the same
# bound, against those of its own output in fp32 (the same folded bf16
# taps, fp32 accumulation), which the kernel rounds once.
STATS_PRE_KINDS = ("upconv_stream",)
# The first stamps of two configurations at equal steps: the same math
# with other rounding points in bf16 (fused epilogues round once where the
# module legs round twice; the slotted softmax rounds its logits to bf16),
# amplified through the DDIM steps of a random-weight UNet: at most
# MAX_MEAN_DIFF u8 levels apart on average over the pixels.
MAX_MEAN_DIFF = 8.0

SOURCES = {
    # bf16 (the paths' and the timed type); fp32 runs conv3x3.cu
    "conv3x3": "csrc/gn_conv_sm90.cu",
    # bf16 (the paths' and the timed type); fp32 runs conv3x3.cu
    "upsample2x_conv3x3": "csrc/gn_conv_sm90.cu",
    # bf16 (the paths' and the timed type); fp32 runs flash_attention.cu
    "flash_attention": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs conv3x3.cu
    "gn_conv_resident": "csrc/gn_conv_sm90.cu",
    "gn_conv_stream": "csrc/gn_conv_sm90.cu",
    "upconv_stream": "csrc/gn_conv_sm90.cu",
    # bf16; fp32 runs ff_geglu.cu
    "ff_geglu": "csrc/ff_geglu_sm90.cu",
    # bf16 (the paths' and the timed type); fp32 runs flash_attention.cu
    "flash_attention_streaming": "csrc/flash_attention_sm90.cu",
    "flash_attention_slotted": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs conv3x3.cu
    "downsample_conv3x3_stats": "csrc/conv_sm90.cu",
    "spatial_moments": "csrc/moments.cu",
    "conv3x3_inpad": "csrc/conv_staged.cu",
    "upsample2x_conv3x3_inpad": "csrc/conv_staged.cu",
    "conv3x3_stream": "csrc/conv_staged.cu",
    "gn_silu_conv3x3": "csrc/conv_staged.cu",
    "nomax_attention": "csrc/attn_arms.cu",
    "chunked_attention": "csrc/attn_arms.cu",
    "nomax_unpadded": "csrc/attn_arms.cu",
    "pvt_attention": "csrc/attn_arms.cu",
    "nomax_4d": "csrc/attn_layouts.cu",
    "nomax_allheads": "csrc/attn_layouts.cu",
    "nomax_laneslice": "csrc/attn_layouts.cu",
    # bf16; fp32 runs attn_layouts.cu
    "slotted_kernel_call": "csrc/flash_attention_sm90.cu",
    "sublane_attention": "csrc/attn_transposed.cu",
    # bf16; fp32 runs attn_transposed.cu
    "pv_product": "csrc/pv_product_sm90.cu",
    "conv_window_taps": "csrc/conv_arms.cu",
    "pipelined": "csrc/conv_arms.cu",
}
# the arms of the attn_arms path (the softmax arms, then the head-layout
# arms) and the slotted-input arm of the slotted_arm path
ARMS = ("nomax_attention", "chunked_attention", "nomax_unpadded",
        "pvt_attention", "nomax_4d", "nomax_allheads", "nomax_laneslice",
        "sublane_attention")
SLOTTED_ARM = "slotted_kernel_call"
# the exact row-max arms: no clamp, no static shift
EXACT_ARMS = ("chunked_attention", "sublane_attention")
# T10 on the pv_product path; T11 and T12 on the conv_arms path
PV, TAPS, PIPE = "pv_product", "conv_window_taps", "pipelined"
# T10's passes a call in this script (the tool's minimum; its own counts,
# about 300 GF a call, are the entry point's)
PV_ITERS = 64
# (bq, Lk, hd) of tools/bench_pv_transpose.py main(), bh 1
PV_SHAPES = ((512, 4096, 40), (512, 1024, 80), (256, 256, 160))
# T11's windows on the conv_arms path: rows of output a window
TAPS_ROWS = 8
TAP_READS = ("shifted", "unshifted", "rowflat", "jointw")
REPLACES = {
    "conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:162",
    "upsample2x_conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:761",
    "flash_attention": "diffusiontexturepainting_tpu/ops/flash_attention.py:37",
    "gn_conv_resident": "diffusiontexturepainting_tpu/ops/conv3x3.py:1031",
    "gn_conv_stream": "diffusiontexturepainting_tpu/ops/gn_conv_stream.py:173",
    "upconv_stream": "diffusiontexturepainting_tpu/ops/gn_conv_stream.py:739",
    "ff_geglu": "diffusiontexturepainting_tpu/ops/ff_geglu.py:68",
    "flash_attention_streaming":
        "diffusiontexturepainting_tpu/ops/flash_attention.py:311",
    "flash_attention_slotted":
        "diffusiontexturepainting_tpu/ops/flash_attention.py:240",
    "downsample_conv3x3_stats":
        "diffusiontexturepainting_tpu/ops/gn_conv_stream.py:1007",
    "spatial_moments": "diffusiontexturepainting_tpu/ops/groupnorm.py:42",
    "conv3x3_inpad": "diffusiontexturepainting_tpu/ops/conv3x3.py:184",
    "upsample2x_conv3x3_inpad":
        "diffusiontexturepainting_tpu/ops/conv3x3.py:726",
    "conv3x3_stream": "diffusiontexturepainting_tpu/ops/conv3x3.py:956",
    "gn_silu_conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:486",
    "nomax_attention": "tools/bench_attn_variants.py:99",
    "chunked_attention": "tools/bench_attn_variants.py:70",
    "nomax_unpadded": "tools/bench_attn_variants.py:257",
    "pvt_attention": "tools/bench_attn_round4.py:60",
    # the pallas_call lines: T6's body is T5's kernel, T4's is K2's
    "nomax_4d": "tools/bench_attn_variants.py:325",
    "nomax_allheads": "tools/bench_attn_variants.py:379",
    "nomax_laneslice": "tools/bench_attn_variants.py:426",
    "slotted_kernel_call": "tools/bench_attn_variants.py:235",
    "sublane_attention": "tools/bench_attn_sublane.py:43",
    "pv_product": "tools/bench_pv_transpose.py:34",
    "conv_window_taps": "tools/bench_conv_shift_cost.py:41",
    "pipelined": "tools/bench_stream_pipeline.py:47",
}
# What the library yardstick of a kernel computes, where it is not the
# kernel's whole function.
LIBRARY_IS = {
    **{name: "F.conv_transpose2d(x, W4, stride 2, padding 1), channels-last, "
             "W4 (Cin, Cout, 4, 4) assembled from the 16 folded taps "
             "(conv3x3.transposed_upsample_weight)"
       for name in ("upsample2x_conv3x3", "upsample2x_conv3x3_inpad")},
    "upconv_stream": "F.conv_transpose2d(x, W4, stride 2, padding 1), "
                     "channels-last, W4 assembled from the folded taps; no "
                     "statistics",
    "downsample_conv3x3_stats":
        "F.conv2d, channels-last, stride 2 on the input padded beforehand; "
        "no statistics",
    "spatial_moments": "torch.var_mean over H and W (correction 0), the "
                       "nearest one-call equivalent",
    **{name: "F.conv2d, channels-last, SAME: the conv alone: no prologue, "
             "residual or statistics"
       for name in ("gn_conv_resident", "gn_conv_stream")},
    **{name: "SDPA: the exact row-max softmax; equal to the no-max arms "
             "while raw logits < 83" for name in ARMS},
    "sublane_attention": "SDPA: the exact row-max softmax, q and p not "
                         "rounded to bf16",
    PV: "one torch.baddbmm(out, e, v, beta=0, alpha=iters): the passes' sum "
        "as one scaled product",
    TAPS: "F.conv2d (VALID, channels-last) on the same windows, for the "
          "`shifted` read only: the other three reads are not a conv",
    SLOTTED_ARM: "SDPA over the (B*h, 1, L, 128) slots with T4's scale: "
                 "the exact row-max softmax, p not rounded to bf16",
}
# The path each kernel's times are reported for; any other kernel: the
# default path.
REPORTED_ON = {"conv3x3": "twin", "flash_attention_streaming": "envelope",
               "flash_attention_slotted": "slotted",
               "conv3x3_inpad": "twin_inpad",
               "upsample2x_conv3x3_inpad": "twin_inpad",
               "conv3x3_stream": "resnet_bodies",
               "gn_silu_conv3x3": "resnet_bodies",
               **{name: "attn_arms" for name in ARMS},
               SLOTTED_ARM: "slotted_arm", PV: "pv_product",
               TAPS: "conv_arms", PIPE: "conv_arms"}
# What a kernel's "ms" sums, where it is not one stamp of its path.
MS_IS = {
    "conv3x3_stream": "bf16 kernel time per stamp of the safe twin's K7 "
                      "calls that pass streaming_plan's shape test, at "
                      "256^2, summed over their shapes",
    "gn_silu_conv3x3": "bf16 kernel time of the 22 resnet bodies of one "
                       "UNet eval at 256^2 (batch 3), two calls each, "
                       "summed over their shapes",
    **{name: "bf16 kernel time of the 60 UNet self-attentions of one "
             "1024^2/4 stamp" for name in ARMS},
    SLOTTED_ARM: "bf16 kernel time of the 40 slotted self-attentions of one "
                 "512^2/4 stamp (K13's shapes), all 128 lanes of a slot "
                 "read",
    PV: f"bf16 kernel time of six calls of {PV_ITERS} passes: the TPU "
        "tool's three shapes at bh 1, both orientations",
    TAPS: "bf16 kernel time of the four tap reads, each once per K5 launch "
          "with a prologue of one default 256^2/20 stamp, on that launch's "
          f"image cut into windows of {TAPS_ROWS} rows (reps 1)",
    PIPE: "bf16 kernel time at the shapes and launches of one default "
          "256^2/20 stamp's K5 calls with a prologue",
}
# The member of the conv family that computes the same function at the
# same shapes, timed beside each staged-tile kernel.
FAMILY_IS = {
    "conv3x3_inpad": "K7 (conv3x3, _IN_PAD off: in bf16 the PLAIN mode of "
                     "gn_conv_sm90.cu)",
    "conv3x3_stream": "K7 (conv3x3, _IN_PAD off: in bf16 the PLAIN mode of "
                      "gn_conv_sm90.cu)",
    "upsample2x_conv3x3_inpad": "K4 (upsample2x_conv3x3, _IN_PAD off)",
    "gn_silu_conv3x3": "K14 + gn_affine_from_stats + K1 (gn_conv_resident "
                       "with the residual; the time embedding not added)",
    **{name: "K8 at (3, 16384, 320), K2 at the other two shapes (the "
             "attention() route)" for name in ARMS},
    SLOTTED_ARM: "K13 (flash_attention_slotted) on the same data in the "
                 "(B, L, h*128) layout",
    TAPS: "K11 (conv3x3_stream) on the image the windows were cut from, "
          "for the `shifted` read only",
    PIPE: "K5 (gn_conv_stream, statistics and residual off; its border "
          "input is 0, T12's silu(c))",
}
# The PyTorch composition timed beside a kernel that no one PyTorch call
# computes, or (T10) beside the library call, the chain of calls that
# issues as many products as the kernel: not a library call, reported apart
# from library_ms.
COMPOSITION_IS = {
    PV: "note, not the library call: iters chained torch.baddbmm(acc, e, "
        "v) calls, as many products as the kernel issues",
    "ff_geglu": "composition, not one call: F.linear(x, w0, b0) and "
                "F.linear(h, w2, b2) in bf16, the GEGLU elementwise between "
                "them (F.gelu in bf16) and the residual add",
}
# Kernels whose library and family calls exist for some of their shape
# keys only (TAPS: the `shifted` read): their sums run over those keys.
PARTIAL_YARDSTICKS = (TAPS,)
# The option of a shape key by which a kernel's time is also reported.
OPTION_OF = {
    PV: lambda key: "v^T@e^T" if key[2] else "e@v",
    TAPS: lambda key: key[2],
}
# The arms' options as the attn_arms path runs them: each arm's row of the
# A/B entry point (T2 in its safe form, T3 at 64-key chunks).
ARM_PATH_ROWS = {"nomax_attention": "nomax-safe",
                 "chunked_attention": "chunk64",
                 "nomax_unpadded": "nomax-unpadded", "pvt_attention": "pvT",
                 "nomax_4d": "nomax-4d", "nomax_allheads": "nomax-allheads",
                 "nomax_laneslice": "nomax-laneslice",
                 "sublane_attention": "sublane"}
# K8/K2 launches a 1024^2/4 stamp at each UNet self-attention shape
ARM_LAUNCHES = 20
# Kernels whose device time (the calls replayed from a CUDA graph, the
# host's launch cost left out) is also taken at their timed shapes, with
# their library call's: the kernels this round of work redesigned last
DEVICE_TIMED = ("gn_conv_resident", "gn_conv_stream", "spatial_moments",
                "ff_geglu", "upsample2x_conv3x3", "upconv_stream", "conv3x3",
                SLOTTED_ARM, PV)
# the sources whose ptxas report must show no spill
NO_SPILL = ("flash_attention_sm90", "conv_sm90", "gn_conv_sm90",
            "ff_geglu_sm90", "pv_product_sm90")
# Kernels also timed at a second path's shapes: K2, K3, K4, K6, K9, K1, K5
# and K14 at the 1024^2 envelope's
ALSO_REPORTED_ON = {"flash_attention": "envelope",
                    "ff_geglu": "envelope",
                    "upsample2x_conv3x3": "envelope",
                    "upconv_stream": "envelope",
                    "downsample_conv3x3_stats": "envelope",
                    "gn_conv_resident": "envelope",
                    "gn_conv_stream": "envelope",
                    "spatial_moments": "envelope"}
# The JAX package's streaming_plan shape test (ops/conv3x3.py:942), without
# its VMEM budget: H >= 8, W >= 2, Cin >= 16, Cout >= 128.
STREAM_MIN = (8, 2, 16, 128)


def log(*parts):
    print(*parts, flush=True)


def counters():
    from diffusiontexturepainting_torch.ops import (
        attention,
        attention_variants,
        conv3x3,
        conv_variants,
        ff_geglu,
        gn_conv,
        groupnorm,
    )

    return [*attention_variants.LAUNCHES.values(),
            *conv_variants.LAUNCHES.values(),
            conv3x3.conv3x3_launches, conv3x3.upsample_launches,
            attention.flash_launches, gn_conv.gn_conv_resident_launches,
            gn_conv.gn_conv_stream_launches, gn_conv.upconv_stream_launches,
            ff_geglu.ff_geglu_launches, attention.flash_streaming_launches,
            attention.flash_slotted_launches,
            gn_conv.downconv_stream_launches,
            groupnorm.spatial_moments_launches,
            conv3x3.conv3x3_inpad_launches, conv3x3.upsample_inpad_launches,
            conv3x3.conv3x3_stream_launches,
            conv3x3.gn_silu_conv3x3_launches]


def per_image(t, shift):
    """t (B, ...) with image b scaled by 1 + b / 4 and shifted by b * shift,
    in t's dtype: images whose statistics differ."""
    import torch

    k = torch.arange(t.shape[0], device=t.device, dtype=torch.float32)
    k = k.view(-1, *(1,) * (t.dim() - 1))
    return (t.float() * (1 + k / 4) + k * shift).to(t.dtype)


def stats_self_err(y, stats):
    """The largest |stats - the statistics of y| over (image, row, channel),
    each entry's error over its own sum of |y| (row 0) or of y^2 (row 1)."""
    import torch

    yf = y.float()
    dims = tuple(range(1, yf.dim() - 1))
    want = torch.stack([yf.sum(dims), yf.square().sum(dims)], dim=1)
    scale = torch.stack([yf.abs().sum(dims), yf.square().sum(dims)], dim=1)
    return ((stats - want).abs() / scale.clamp_min(1e-30)).max().item()


def kernel_case(kind, shape_key, dtype, gen):
    """Seeded inputs at `shape_key`; returns zero-argument callables
    (kernel, plain, library, family, composition, pre) over the same
    inputs, library being the one PyTorch call that computes the same
    function, or None, family the conv family's other kernel for the same
    function (FAMILY_IS), or None, composition the PyTorch ops computing it
    where no one call does (COMPOSITION_IS), or None, and pre the kernel's
    output before its rounding, in fp32, for the kinds whose statistics
    are taken there (STATS_PRE_KINDS), or None. The fused convs return
    (out, statistics or None)."""
    case = _kernel_case(kind, shape_key, dtype, gen)
    return case + (None,) * (6 - len(case))


def _kernel_case(kind, shape_key, dtype, gen):
    import torch
    import torch.nn.functional as F

    from diffusiontexturepainting_torch.ops import (
        attention,
        attention_variants,
        conv3x3,
        conv_variants,
        ff_geglu,
        gn_conv,
        groupnorm,
    )

    def rnd(*shape, std=1.0, mean=0.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + mean).to(dt)

    def sdpa(q, k, v, heads, hd=None):
        """SDPA on (B, heads, L, hd) views of the (B, L, heads*slot)
        tensors."""
        def view(t):
            b, l, d = t.shape
            return t.view(b, l, heads, d // heads)[..., :hd].transpose(1, 2)
        qh, kh, vh = view(q), view(k), view(v)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh)

    if kind in ("flash_attention", "flash_attention_streaming"):
        q_shape, k_shape, heads = shape_key
        q, k, v = rnd(*q_shape), rnd(*k_shape), rnd(*k_shape)
        if kind == "flash_attention":
            # K2 computes K8's function
            pair = (lambda: attention.flash_attention(q, k, v, heads),
                    lambda: attention.plain_attention_streaming(q, k, v,
                                                                heads))
        else:
            pair = (lambda: attention.flash_attention_streaming(q, k, v,
                                                                heads),
                    lambda: attention.plain_attention_streaming(q, k, v,
                                                                heads))
        return pair + (sdpa(q, k, v, heads),)
    if kind == SLOTTED_ARM:
        # T4 over the (B*h, L, P) split of head-slotted data (the first hd
        # lanes of each slot random, the rest zero); K13 reads the same
        # data in the (B, L, h*P) layout where P is its 128-lane slot
        (BH, L, P), (_, Lk, _), heads, hd, exp2_bf16 = shape_key
        B = BH // heads

        def slots(length):
            x = torch.zeros((B, length, heads, P), dtype=dtype,
                            device="cuda")
            x[..., :hd] = rnd(B, length, heads, hd)
            return x.view(B, length, heads * P)
        qs, ks, vs = slots(L), slots(Lk), slots(Lk)
        qh, kh, vh = (attention_variants.split_heads(t, heads)
                      for t in (qs, ks, vs))
        scale = hd**-0.5
        return (lambda: attention_variants.slotted_kernel_call(
                    qh, kh, vh, scale, exp2_bf16=exp2_bf16),
                lambda: attention_variants.plain_slotted_kernel_call(
                    qh, kh, vh, scale, exp2_bf16=exp2_bf16),
                lambda: F.scaled_dot_product_attention(
                    qh[:, None], kh[:, None], vh[:, None], scale=scale),
                (lambda: attention.flash_attention_slotted(qs, ks, vs, heads,
                                                           hd))
                if P == attention.SLOT and L == Lk else None)
    if kind == PV:
        # the tool's inputs: uniform [0, 1)
        e_shape, v_shape, transposed, iters = shape_key
        e = torch.rand(e_shape, generator=gen, device="cuda").to(dtype)
        v = torch.rand(v_shape, generator=gen, device="cuda").to(dtype)
        out = torch.empty((*e_shape[:2], v_shape[2]), dtype=dtype,
                          device="cuda")

        def chain():
            acc = torch.zeros_like(out)
            for _ in range(iters):
                acc = torch.baddbmm(acc, e, v)
            return acc
        return (lambda: attention_variants.pv_product(
                    e, v, transposed=transposed, iters=iters),
                lambda: attention_variants.plain_pv_product(
                    e, v, transposed=transposed, iters=iters),
                lambda: torch.baddbmm(out, e, v, beta=0, alpha=iters),
                None, chain)
    if kind == TAPS:
        # an image cut into row windows with halo, as a streamed conv
        # would see them; `shifted` is then the SAME conv of the image
        (nwin, rows, wp, cin), w_shape, read, W, reps = shape_key
        n, h_t = w_shape[2], rows - 2
        image = torch.rand((1, nwin * h_t, W, cin), generator=gen,
                           device="cuda").to(dtype)
        xwin = image_windows(image, h_t, wp)
        w = (torch.rand((9, cin, n), generator=gen, device="cuda")
             * 2 * (9 * cin) ** -0.5).to(dtype).view(w_shape)
        is_conv = read == "shifted" and reps == 1
        xc = xwin[:, :, :W + 2].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w33 = w.view(3, 3, cin, n)
        wc = w33.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        zero = torch.zeros(n, dtype=dtype, device="cuda")
        return (lambda: conv_variants.conv_window_taps(xwin, w, read, W=W,
                                                       reps=reps),
                lambda: conv_variants.plain_conv_window_taps(
                    xwin, w, read, W=W, reps=reps),
                (lambda: F.conv2d(xc, wc)) if is_conv else None,
                (lambda: conv3x3.conv3x3_stream(image, w33, zero))
                if is_conv else None)
    if kind == PIPE:
        x_shape, w_shape, has_bias = shape_key
        B, cin, cout = x_shape[0], x_shape[3], w_shape[3]
        x = rnd(*x_shape)
        w = rnd(*w_shape, std=(9 * cin) ** -0.5)
        a = rnd(B, cin, std=0.2, mean=1.0, dt=torch.float32)
        c = rnd(B, cin, std=0.2, dt=torch.float32)
        b = rnd(cout, std=0.1) if has_bias else None
        return (lambda: conv_variants.pipelined(x, a, c, w, b),
                lambda: conv_variants.plain_pipelined(x, a, c, w, b), None,
                lambda: k5_call(gn_conv, x, a, c, w, b))
    if kind in ARMS:
        q_shape, k_shape, heads, *opts = shape_key
        q, k, v = rnd(*q_shape), rnd(*k_shape), rnd(*k_shape)
        options = ({} if not opts else
                   dict(safe=opts[0], bf16_p=opts[1])
                   if kind == "nomax_attention"
                   else dict(bk=opts[0], bf16_p=opts[1]))
        wrapper, plain = attention_variants.ARMS[kind]
        return (lambda: wrapper(q, k, v, heads, **options),
                lambda: plain(q, k, v, heads, **options),
                sdpa(q, k, v, heads),
                lambda: attention.attention(q, k, v, heads))
    if kind == "flash_attention_slotted":
        (B, L, D), heads, hd = shape_key
        # one fused projection's output, zero pad lanes, split into views
        qkv = torch.zeros((B, L, 3, heads, attention.SLOT), dtype=dtype,
                          device="cuda")
        qkv[..., :hd] = rnd(B, L, 3, heads, hd)
        q, k, v = qkv.reshape(B, L, 3 * D).chunk(3, dim=-1)
        return (lambda: attention.flash_attention_slotted(q, k, v, heads, hd),
                lambda: attention.plain_attention_slotted(q, k, v, heads, hd),
                sdpa(q, k, v, heads, hd))
    if kind == "ff_geglu":
        n, c, inner = shape_key
        x, res = rnd(n, c), rnd(n, c)
        w0, b0 = rnd(2 * inner, c, std=c**-0.5), rnd(2 * inner, std=0.1)
        w2, b2 = rnd(c, inner, std=inner**-0.5), rnd(c, std=0.1)
        inner_ = w2.shape[1]

        def composition():
            h = F.linear(x, w0, b0)
            return F.linear(h[:, :inner_] * F.gelu(h[:, inner_:]), w2,
                            b2) + res
        return (lambda: ff_geglu.ff_geglu(x, w0, b0, w2, b2, res),
                lambda: ff_geglu.ff_geglu_plain(x, w0, b0, w2, b2, res),
                None, None, composition)
    if kind == "spatial_moments":
        # (x, moments): compare holds the moments as statistics of x
        x = per_image(rnd(*shape_key[0], mean=0.5), 0.25)
        return (lambda: (x, groupnorm.spatial_moments(x)),
                lambda: (x, groupnorm.spatial_moments_plain(x)),
                lambda: torch.var_mean(x, dim=(1, 2), correction=0))
    x_shape, w_shape = shape_key[:2]
    x = rnd(*x_shape)
    w = rnd(*w_shape, std=(9 * w_shape[2]) ** -0.5)
    b = rnd(w_shape[3], std=0.1)
    if kind == "gn_silu_conv3x3":
        has_temb, has_res, groups = shape_key[2:]
        B, H, W, cin = x_shape
        cout = w_shape[3]
        x = rnd(*x_shape, mean=0.3)
        scale, shift = rnd(cin, std=0.2, mean=1.0), rnd(cin, std=0.2)
        t = rnd(B, cout) if has_temb else None
        r = rnd(B, H, W, cout) if has_res else None

        def family():
            a, c = groupnorm.gn_affine_from_stats(
                groupnorm.spatial_moments(x), scale, shift, groups, H * W)
            return gn_conv.gn_conv_resident(x, a, c, w, b, r, False)[0]
        return (lambda: conv3x3.gn_silu_conv3x3(x, scale, shift, w, b, t, r,
                                                groups),
                lambda: conv3x3.gn_silu_conv3x3_plain(x, scale, shift, w, b,
                                                      t, r, groups),
                None, family)
    if kind == "downsample_conv3x3_stats":
        stats = shape_key[2]
        # the yardstick pads outside the timed call
        xp = F.pad(x, (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return (lambda: gn_conv.downconv_stream(x, w, b, stats),
                lambda: gn_conv.downconv_stream_plain(x, w, b, stats),
                lambda: F.conv2d(xp, wc, b, stride=2))
    if kind in ("conv3x3", "conv3x3_inpad", "conv3x3_stream"):
        xc = x.permute(0, 3, 1, 2)  # channels-last memory, NCHW view
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        op = getattr(conv3x3, kind)
        return (lambda: op(x, w, b), lambda: conv3x3.conv3x3_plain(x, w, b),
                lambda: F.conv2d(xc, wc, b, padding=1),
                None if kind == "conv3x3"
                else lambda: conv3x3.conv3x3(x, w, b))
    # the modules fold the upsample weights once at load: outside the call,
    # as is the yardstick's 4x4 weight; K6's images differ from one another
    # (per_image), as the statistics probes' do
    if kind == "upconv_stream":
        x = per_image(x, 0.5)
    taps = conv3x3.fold_upsample_weights(w)
    xc = x.permute(0, 3, 1, 2)
    w4 = conv3x3.transposed_upsample_weight(taps).contiguous(
        memory_format=torch.channels_last)

    def transposed():
        return F.conv_transpose2d(xc, w4, b, stride=2, padding=1)
    if kind == "upsample2x_conv3x3":
        return (lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps),
                lambda: conv3x3.upsample2x_conv3x3_plain(x, w, b),
                transposed)
    if kind == "upsample2x_conv3x3_inpad":
        return (lambda: conv3x3.upsample2x_conv3x3_inpad(x, w, b, taps),
                lambda: conv3x3.upsample2x_conv3x3_plain(x, w, b), transposed,
                lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps))
    if kind == "upconv_stream":
        stats = shape_key[2]

        def pre():
            return F.conv_transpose2d(xc.float(), w4.float(), b.float(),
                                      stride=2, padding=1).permute(0, 2, 3, 1)
        return (lambda: gn_conv.upconv_stream(x, w, b, taps, stats),
                lambda: gn_conv.upconv_stream_plain(x, w, b, stats),
                transposed, None, None, pre)
    has_bias, has_res, stats, apply_gn = shape_key[2:]
    B, cin, cout = x_shape[0], x_shape[3], w_shape[3]
    x = per_image(x, 0.5)
    a = rnd(B, cin, std=0.2, mean=1.0, dt=torch.float32)
    c = rnd(B, cin, std=0.2, dt=torch.float32)
    b = b if has_bias else None
    r = per_image(rnd(*x_shape[:3], cout), 0.25) if has_res else None
    op = getattr(gn_conv, kind)
    # a head whose Cout is off 8 passes its weight zero-padded, as the VAE
    # decoder does
    wk, bk = gn_conv.pad_cout(w, b)
    extra = dict(out_channels=cout) if wk is not w else {}
    # the yardstick: the conv alone, channels-last
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return (lambda: op(x, a, c, wk, bk, r, stats, apply_gn, **extra),
            lambda: gn_conv.gn_conv3x3_plain(x, a, c, w, b, r, stats,
                                             apply_gn),
            lambda: F.conv2d(xc, wc, b, padding=1))


def k5_call(gn_conv, x, a, c, w, b):
    """K5 with its prologue, no residual and no statistics, as the VAE calls
    it: a weight whose Cout is off 8 zero-padded (pad_cout)."""
    wk, bk = gn_conv.pad_cout(w, b)
    extra = dict(out_channels=w.shape[-1]) if wk is not w else {}
    return gn_conv.gn_conv_stream(x, a, c, wk, bk, None, False, True,
                                  **extra)[0]


def image_windows(image, h_t, wp):
    """(1, H, W, C) -> (H / h_t, h_t + 2, wp, C): the image zero-padded by
    one pixel (to width wp on the right) and cut into windows of h_t output
    rows with their halo rows."""
    import torch.nn.functional as F

    W = image.shape[2]
    xp = F.pad(image[0], (0, 0, 1, wp - W - 1, 1, 1))
    return xp.unfold(0, h_t + 2, h_t).permute(0, 3, 1, 2).contiguous()


def taps_key(nwin, h_t, W, cin, n, read, reps=1):
    """T11's shape key: Wp = W + 2 rounded up to 8, as the TPU tool pads."""
    wp = W + 2 + (-(W + 2)) % 8
    w_shape = (3, 3 * cin, n) if read == "jointw" else (9, cin, n)
    return ((nwin, h_t + 2, wp, cin), w_shape, read, W, reps)


def work(kind, key, itemsize):
    """(operations, bytes) of one call: each input read once, each output
    written once; the operations of the function (multiply-adds as two).
    The upsample conv's operations are counted in the exact folded 4-tap
    form, its weight bytes as the 9-tap 3x3 kernel that the function
    needs (the folded 16-tap copy is the module's choice, not the work)."""
    if kind in ("flash_attention", "flash_attention_streaming", SLOTTED_ARM) \
            + ARMS:
        # T4: every lane of its (B*h, L, P) slots is its function's work
        (B, Lq, D), (_, Lk, _), *_ = key
        return 4 * B * Lq * Lk * D, itemsize * 2 * B * (Lq + Lk) * D
    if kind == "flash_attention_slotted":
        (B, L, D), heads, hd = key
        return 4 * B * L * L * heads * hd, itemsize * 4 * B * L * D
    if kind == PV:
        (bh, bq, lk), (_, _, hd), _, iters = key
        return (iters * 2 * bh * bq * lk * hd,
                itemsize * bh * (bq * lk + lk * hd + bq * hd))
    if kind == TAPS:
        (nwin, rows, wp, cin), (_, _, n), _, W, reps = key
        out = nwin * (rows - 2) * W * n
        return (reps * 2 * out * 9 * cin,
                itemsize * (nwin * rows * wp * cin + 9 * cin * n + out))
    if kind == PIPE:
        x_shape, (_, _, cin, cout), has_bias = key
        pixels = math.prod(x_shape[:3])
        return (2 * pixels * 9 * cin * cout,
                itemsize * (pixels * cin + 9 * cin * cout + has_bias * cout
                            + pixels * cout) + 4 * 2 * x_shape[0] * cin)
    if kind == "ff_geglu":
        t, c, inner = key
        return (6 * t * c * inner,
                itemsize * (3 * t * c + 3 * c * inner + 2 * inner + c))
    if kind == "spatial_moments":
        (B, H, W, C), = key
        return 3 * B * H * W * C, itemsize * B * H * W * C + 4 * 2 * B * C
    x_shape, (_, _, cin, cout) = key[:2]
    pixels = math.prod(x_shape[:3])
    if kind == "downsample_conv3x3_stats":
        out_pixels = x_shape[0] * (x_shape[1] // 2) * (x_shape[2] // 2)
        return (2 * out_pixels * 9 * cin * cout,
                itemsize * (pixels * cin + 9 * cin * cout + cout
                            + out_pixels * cout)
                + key[2] * 4 * 2 * x_shape[0] * cout)
    if kind in ("upsample2x_conv3x3", "upsample2x_conv3x3_inpad",
                "upconv_stream"):
        flops = 2 * 4 * pixels * 4 * cin * cout
        bytes_ = itemsize * (pixels * cin + 9 * cin * cout + cout
                             + 4 * pixels * cout)
        if kind == "upconv_stream" and key[2]:
            bytes_ += 4 * 2 * x_shape[0] * cout
        return flops, bytes_
    flops = 2 * pixels * 9 * cin * cout
    bytes_ = itemsize * (pixels * cin + 9 * cin * cout + pixels * cout)
    if kind in ("conv3x3", "conv3x3_inpad", "conv3x3_stream"):
        return flops, bytes_ + itemsize * cout
    if kind == "gn_silu_conv3x3":
        has_temb, has_res = key[2:4]
        return flops, bytes_ + itemsize * (cout + 2 * cin
                                           + has_temb * x_shape[0] * cout
                                           + has_res * pixels * cout)
    has_bias, has_res, stats, apply_gn = key[2:]
    bytes_ += itemsize * (has_bias * cout + has_res * pixels * cout
                          + apply_gn * 2 * x_shape[0] * cin)
    return flops, bytes_ + stats * 4 * 2 * x_shape[0] * cout


def bound_s(kind, key, dtype_name):
    """(seconds, "operations" or "bytes"): the least time of one call."""
    flops, bytes_ = work(kind, key, 2 if dtype_name == "bfloat16" else 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], bytes_ / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, budget_s=0.3, max_iters=20):
    """CUDA-event mean of one call, after a warm-up: up to `max_iters`
    calls, fewer when one call takes long."""
    import torch

    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - tic
    iters = int(min(max_iters, max(2, budget_s / max(one, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(kind, shape_key, dtype, gen, timed=False):
    """Kernel vs plain version on the same inputs; returns a dict of
    max_abs_err, tol, peak (max|plain|), err_over_tol (the worst of the
    output's and the statistics'), and kernel_ms / plain_ms / library_ms
    (None where no PyTorch call computes the function) and, for the staged
    kernels, family_ms (FAMILY_IS) when `timed`."""
    import torch

    kernel, plain, library, family, composition, pre = kernel_case(
        kind, shape_key, dtype, gen)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got_st = want_st = None
    if isinstance(got, tuple):
        (got, got_st), (want, want_st) = got, want
    name = f"{kind} {shape_key} {str(dtype)[6:]}"
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gave {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    rel = TOL[str(dtype).split(".")[-1]]
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    tol = rel * peak
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > tol "
                             f"{tol:.3e}")
    out = {"max_abs_err": err, "tol": tol, "peak": peak,
           "err_over_tol": err / tol}
    if kind == "flash_attention_slotted":
        D = shape_key[0][2]
        pad = got.reshape(*got.shape[:2], D // 128, 128)[..., shape_key[2]:]
        if pad.any():
            raise AssertionError(f"{name}: nonzero pad lanes")
    if kind == SLOTTED_ARM and got[..., shape_key[3]:].any():
        raise AssertionError(f"{name}: nonzero pad lanes")
    if (got_st is None) != (want_st is None):
        raise AssertionError(f"{name}: statistics returned by one side only")
    if want_st is not None:
        if got_st.shape != want_st.shape or not torch.isfinite(got_st).all():
            raise AssertionError(f"{name}: statistics {tuple(got_st.shape)}")
        yf = want.float()
        dims = tuple(range(1, yf.dim() - 1))
        scales = (yf.abs().sum(dims).max().item(),
                  yf.square().sum(dims).max().item())
        for row, scale in enumerate(scales):
            e = (got_st[:, row] - want_st[:, row]).abs().max().item()
            if not e <= rel * scale:
                raise AssertionError(f"{name}: statistics row {row} error "
                                     f"{e:.3e} > tol {rel * scale:.3e}")
            out["err_over_tol"] = max(out["err_over_tol"], e / (rel * scale))
            if kind == "spatial_moments":  # the moments are the output
                out["max_abs_err"] = max(out["max_abs_err"], e)
        out["stats_checked"] = True
        if kind in STATS_SELF_KINDS or pre is not None:
            own = got if pre is None else pre()
            e = stats_self_err(own, got_st)
            del own
            if not e <= STATS_SELF_TOL:
                raise AssertionError(f"{name}: statistics differ from those "
                                     f"of its own output by {e:.3e} of the "
                                     f"sums > {STATS_SELF_TOL:.3e}")
            out["stats_self_err"] = e
    del got, want, got_st, want_st
    if timed:
        # plain, kernel, kernel, plain: drift hits both sides alike
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
        out["kernel_ms"], out["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        out["library_ms"] = None if library is None else cuda_ms(library)
        if family is not None:
            out["family_ms"] = cuda_ms(family)
        if composition is not None:
            out["composition_ms"] = cuda_ms(composition)
        if kind in DEVICE_TIMED:
            from diffusiontexturepainting_torch.tools._common import graph_ms

            out["kernel_device_ms"] = graph_ms(kernel, calls=10, tries=3)
            for field, fn in (("library", library),
                              ("composition", composition)):
                if fn is not None:
                    out[f"{field}_device_ms"] = graph_ms(fn, calls=10,
                                                         tries=3)
    return out


def attention_launches(model, res, steps):
    """Launches of K2, K8 and K13 in one stamp of `model` at `res`, from its
    configuration and the routing rules: the UNet's self-attentions per
    eval and level, and the VAE's two mid-block attentions (encoder and
    decoder, at the latent size). Cross-attention (14 tokens) is plain."""
    from diffusiontexturepainting_torch.ops.attention import (
        attention_route,
        slotted_self_attention_fits,
    )

    u, v = model.unet.cfg, model.vae_encoder.cfg
    lat = res // 8
    kernel = {"flash": "flash_attention",
              "streaming": "flash_attention_streaming", "plain": None}
    out = Counter()

    def site(length, channels, heads, calls, slotted):
        hd = channels // heads
        if slotted and slotted_self_attention_fits(length, length, hd):
            out["flash_attention_slotted"] += calls
            return
        name = kernel[attention_route(length, length, hd, model.dtype)]
        if name:
            out[name] += calls
    heads, L = u.num_attention_heads, u.layers_per_block
    for i, ch in enumerate(u.block_out_channels):
        if u.attn_down[i]:
            site((lat >> i) ** 2, ch, heads, steps * (2 * L + 1),
                 u.fused_attn)
    n = len(u.block_out_channels) - 1
    site((lat >> n) ** 2, u.block_out_channels[-1], heads, steps,
         u.fused_attn)
    site(lat * lat, v.block_out_channels[-1], 1, 2, False)
    return out


def expected_per_stamp(model, res, steps, in_pad=False):
    """Launches of each kernel in one stamp of `model`, from its
    configuration; `in_pad`: under the _IN_PAD switch, K12a/b take K7's and
    K4's calls."""
    c = model.config
    u, v = model.unet.cfg, model.vae_encoder.cfg
    n_u, n_v = len(u.block_out_channels), len(v.block_out_channels)
    L, Lv = u.layers_per_block, v.layers_per_block
    plain_resnets = n_u * L + 2          # down path and mid: no skip
    skip_resnets = n_u * (L + 1)         # up path: skip un-concatenated
    transformers = sum(u.attn_down) * (2 * L + 1) + 1
    enc_resnets, dec_resnets = n_v * Lv + 2, n_v * (Lv + 1) + 2
    fused_unet, fused_enc, fused_dec = (c.fused_unet_resnet,
                                        c.fused_vae_encoder,
                                        c.fused_vae_decoder)
    unet_convs = 2 * (plain_resnets + skip_resnets)
    attn = attention_launches(model, res, steps)
    # statistics passes (stats_of) per UNet eval: each fused resnet's input,
    # both parts of an up-path resnet's un-concatenated input, and, where
    # the transformers fold their GroupNorm but the resnets do not hand
    # them statistics, each transformer's input; per VAE: the encoder's
    # stem and mid block, the decoder's conv_in and mid block
    unet_moments = ((plain_resnets + 2 * skip_resnets) if fused_unet
                    else transformers if c.fused_unet_norm else 0)
    convs = ((0 if fused_unet else steps * unet_convs)
             + (0 if fused_enc else 2 * enc_resnets)
             + (0 if fused_dec else 2 * dec_resnets))
    upconvs = steps * (n_u - 1) + (0 if fused_dec else n_v - 1)
    return {
        "conv3x3": 0 if in_pad else convs,
        "upsample2x_conv3x3": 0 if in_pad else upconvs,
        "conv3x3_inpad": convs if in_pad else 0,
        "upsample2x_conv3x3_inpad": upconvs if in_pad else 0,
        "conv3x3_stream": 0,
        "gn_silu_conv3x3": 0,
        "flash_attention": attn["flash_attention"],
        "gn_conv_resident": steps * (2 * plain_resnets + 3 * skip_resnets)
        if fused_unet else 0,
        "ff_geglu": steps * transformers if c.fused_unet_ff else 0,
        "gn_conv_stream": (2 * enc_resnets + 1 if fused_enc else 0)
        + (2 * dec_resnets + 1 if fused_dec else 0),
        "upconv_stream": n_v - 1 if fused_dec else 0,
        "flash_attention_streaming": attn["flash_attention_streaming"],
        "flash_attention_slotted": attn["flash_attention_slotted"],
        "downsample_conv3x3_stats": n_v - 1 if fused_enc else 0,
        "spatial_moments": steps * unet_moments + 2 * fused_enc
        + 2 * fused_dec,
        # the arms run on paths of their own (attn_arms, slotted_arm,
        # pv_product, conv_arms)
        **{name: 0 for name in ARMS + (SLOTTED_ARM, PV, TAPS, PIPE)},
    }


def check_reply(reply, want_type, res=RES, canvas=None):
    import numpy as np

    from diffusiontexturepainting_torch.serving import wire

    kind, img = wire.decode_response(reply)
    if kind != want_type or img.shape != (res, res, 3) \
            or img.dtype != np.uint8:
        raise AssertionError(f"reply type {kind} shape {img.shape} "
                             f"{img.dtype}")
    if canvas is not None:
        painted = canvas[..., 3] == 255
        diff = np.abs(img[painted].astype(int)
                      - canvas[..., :3][painted].astype(int)).max()
        if diff > 1:
            raise AssertionError(f"painted region changed by {diff} levels")
        if img[~painted].std() < 1.0:
            raise AssertionError("generated region is constant")
    return img


def requests(res=RES):
    import numpy as np

    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    canvas = np.zeros((res, res, 4), np.uint8)
    canvas[:res // 4, :, 3] = 255
    canvas[:res // 4, :, :3] = 64
    return brush, canvas


def run_path(label, model, steps, res=RES):
    """One brush + preview, three stamps and a replay of the first, as wire
    bytes through the request handler. The kernels' counts are set to 0
    just before and read just after. Returns (first stamp, launches,
    shapes, stamps run)."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving import wire

    R, handle = wire.RequestType, wire.handle_request_bytes
    brush, canvas = requests(res)
    stamp_req = wire.encode_request(R.NEW_STAMP, canvas,
                                    **settings(steps, res))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters():
        c.reset()
    times = []
    tic = time.perf_counter()
    check_reply(handle(model, wire.encode_request(R.NEW_BRUSH_IMAGE, brush,
                                                  **settings(steps, res))),
                R.RETURN_PREVIEW, res)
    times.append(("brush+preview", time.perf_counter() - tic))
    replies = []
    for k in range(3):
        tic = time.perf_counter()
        reply = handle(model, stamp_req)
        times.append((f"stamp {k + 1}", time.perf_counter() - tic))
        replies.append(check_reply(reply, R.RETURN_STAMP, res, canvas))
    if all(np.array_equal(replies[0], r) for r in replies[1:]):
        raise AssertionError("stamps with different counters are identical")
    # replay request 2 (the first NEW_STAMP) with its own counter
    model.request_counter = 1
    tic = time.perf_counter()
    again = handle(model, stamp_req)
    times.append(("stamp 1 replayed", time.perf_counter() - tic))
    if not np.array_equal(check_reply(again, R.RETURN_STAMP, res, canvas),
                          replies[0]):
        raise AssertionError(f"{label}: replayed stamp differs from the "
                             "original")
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters()}
    shapes = {c.name: dict(c.shapes) for c in counters()}
    for name, secs in times:
        log(f"{label}: {name}: {secs * 1e3:.1f} ms wall ({res}^2, {steps} "
            f"steps, {model.dtype})")
    log(f"{label}: replayed stamp bit-identical; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return replies[0], launches, shapes, 5  # preview + 3 stamps + replay


def check_counts(label, model, steps, launches, n_stamps, res=RES,
                 in_pad=False):
    want = {k: n_stamps * v for k, v in
            expected_per_stamp(model, res, steps, in_pad).items()}
    for name in want:
        log(f"{label} counts: {name}: {launches[name]} launches in "
            f"{n_stamps} stamps, expected {want[name]} "
            f"({want[name] // n_stamps} per stamp)")
        if launches[name] != want[name]:
            raise AssertionError(f"{label}: {name}: {launches[name]} "
                                 f"launches, expected {want[name]}")


def first_stamp_at(model, steps, res=RES):
    """The first NEW_STAMP of run_path (request counter 2) at `steps`."""
    from diffusiontexturepainting_torch.serving import wire

    R = wire.RequestType
    _, canvas = requests(res)
    model.request_counter = 1
    reply = wire.handle_request_bytes(
        model, wire.encode_request(R.NEW_STAMP, canvas,
                                   **settings(steps, res)))
    return check_reply(reply, R.RETURN_STAMP, res, canvas)


def compare_stamps(label, ours, theirs, what):
    diff = abs(ours.astype(int) - theirs.astype(int))
    log(f"{label}: first stamps of {what}: mean |diff| {diff.mean():.3f} u8 "
        f"levels, max {diff.max()}, {(diff == 0).mean():.4f} exact, "
        f"{(diff <= 4).mean():.4f} within 4, {(diff <= 16).mean():.4f} "
        "within 16")
    if not diff.mean() <= MAX_MEAN_DIFF:
        raise AssertionError(f"{label}: {what} differ by {diff.mean():.3f} "
                             "levels on average")


def serve_phase(model):
    """The port's server on loopback around `model`: /health, then a brush
    image, a brush prompt and a stamp over a websocket, each reply
    byte-equal to the request handler's at the same request counter."""
    import urllib.request

    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.serving.server import create_server

    R = wire.RequestType
    server = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.socket.getsockname()[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        if health.get("status") != "ok":
            raise AssertionError(f"server: /health said {health}")
        log(f"server: GET /health -> {health}")
        brush, canvas = requests()
        with connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            s = settings(TWIN_STEPS)
            for kind, req, want in (
                    (R.NEW_BRUSH_IMAGE,
                     wire.encode_request(R.NEW_BRUSH_IMAGE, brush, **s),
                     R.RETURN_PREVIEW),
                    (R.NEW_BRUSH_PROMPT,
                     wire.encode_brush_prompt_request("mossy stone", **s),
                     R.RETURN_PREVIEW),
                    (R.NEW_STAMP, wire.encode_request(R.NEW_STAMP, canvas,
                                                      **s),
                     R.RETURN_STAMP)):
                counter = model.request_counter
                tic = time.perf_counter()
                ws.send(req)
                reply = ws.recv(timeout=600)
                secs = time.perf_counter() - tic
                check_reply(reply, want)
                model.request_counter = counter
                direct = wire.handle_request_bytes(model, req)
                if reply != direct:
                    raise AssertionError(f"server: {kind.name} reply "
                                         "differs from the handler's")
                log(f"server: {kind.name} over the websocket: "
                    f"{len(reply)} reply bytes in {secs * 1e3:.1f} ms, "
                    "byte-equal to wire.handle_request_bytes at the same "
                    "request counter")
    finally:
        server.shutdown()
        thread.join(timeout=60)


# The session phase's stroke on a 512^2 canvas: (x0, y0, return_pixels,
# overpaint) of its stamps (four without pixels, the second overpainting
# the first's window, the fourth clamped to (256, 0); then one with
# pixels) and its erase (clamped to (256, 256)).
SESSION_CANVAS = 512
SESSION_STAMPS = [(0, 0, False, False), (96, 40, False, True),
                  (200, 180, False, False), (480, -30, False, False),
                  (128, 128, True, False)]
SESSION_ERASE = (300, 260, True)


def session_requests():
    """(canvas, the session's requests as wire bytes)."""
    import numpy as np

    from diffusiontexturepainting_torch.serving import wire

    rng = np.random.default_rng(1)
    n = SESSION_CANVAS
    canvas = np.zeros((n, n, 4), np.uint8)
    canvas[:n // 4, :, :3] = rng.integers(0, 256, (n // 4, n, 3))
    canvas[:n // 4, :, 3] = 255
    s = settings(FEW_STEPS)
    return canvas, ([wire.encode_begin_session(canvas, **s)]
                    + [wire.encode_stamp_at(x, y, px, op, **s)
                       for x, y, px, op in SESSION_STAMPS]
                    + [wire.encode_erase_at(*SESSION_ERASE),
                       wire.encode_fetch_canvas(),
                       wire.encode_end_session()])


def session_oracle(model, canvas, first_counter):
    """The session's canvas, the pixel-returning stamp's crop and the
    erase's crop on the host: each stamp's crop (centre cleared for
    overpaint) through generate_u8 at the stamp's request counter, written
    with host_stamp_update; then host_erase_update."""
    from diffusiontexturepainting_torch.pipeline import session

    n, res = canvas.shape[0], model.resolution()
    crop = None
    for k, (x0, y0, px, op) in enumerate(SESSION_STAMPS):
        x, y = session.clamped_corner(x0, y0, res, n, n)
        window = canvas[y:y + res, x:x + res].copy()
        if op:
            m = session.overpaint_margin(res)
            window[m:res - m, m:res - m] = 0
        model.request_counter = first_counter + k - 1
        comp = model.generate_u8(window, **settings(FEW_STEPS))
        canvas = session.host_stamp_update(canvas, comp, x0, y0)
        if px:
            crop = comp
    x0, y0, _ = SESSION_ERASE
    canvas = session.host_erase_update(canvas, res, x0, y0)
    x, y = session.clamped_corner(x0, y0, res, n, n)
    return canvas, crop, canvas[y:y + res, x:x + res, :3]


def session_phase(model):
    """A stroke session through the request handler, then over the
    server's websocket; returns (launches, shapes, stamps) of the handler's
    run."""
    import numpy as np
    import torch
    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.serving.server import create_server

    t_phase = time.perf_counter()
    R, handle = wire.RequestType, wire.handle_request_bytes
    canvas, reqs = session_requests()
    n_free = sum(not px for _, _, px, _ in SESSION_STAMPS)
    counter = model.request_counter
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    replies = [handle(model, reqs[0])]
    torch.cuda.synchronize()
    acks, busy = [], []
    stream = torch.cuda.current_stream()
    tic = time.perf_counter()
    for raw in reqs[1:1 + n_free]:
        t0 = time.perf_counter()
        # a stamp without pixels must not wait for the device: any
        # synchronizing CUDA call while it is enqueued raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            replies.append(handle(model, raw))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        acks.append(time.perf_counter() - t0)
        busy.append(not stream.query())  # its kernels still queued
    enqueued = time.perf_counter() - tic
    model.sync_session()
    wall = time.perf_counter() - tic
    for raw in reqs[1 + n_free:]:
        replies.append(handle(model, raw))
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters()}
    shapes = {c.name: dict(c.shapes) for c in counters()}
    log(f"session: {n_free} STAMP_ATs without pixels acknowledged in "
        + ", ".join(f"{a * 1e3:.1f}" for a in acks)
        + f" ms (all enqueued {enqueued * 1e3:.1f} ms after the first was "
        f"sent; the device still busy at each ack: {busy}); the stroke "
        f"synchronized {wall * 1e3:.1f} ms after it ({RES}^2 stamps, "
        f"{FEW_STEPS} steps, {SESSION_CANVAS}^2 canvas)")
    kinds = [r[0] for r in replies]
    want_kinds = ([R.RETURN_ACK] * (1 + n_free)
                  + [R.RETURN_STAMP, R.RETURN_STAMP, R.RETURN_CANVAS,
                     R.RETURN_ACK])
    if kinds != want_kinds:
        raise AssertionError(f"session: reply types {kinds}")
    seqs = [wire.decode_ack(r)[1] for r in replies if r[0] == R.RETURN_ACK]
    if seqs != list(range(len(seqs))):
        raise AssertionError(f"session: ack sequence {seqs}")
    fetched = wire.decode_response(replies[-2])[1]
    stamp_crop = wire.decode_response(replies[1 + n_free])[1]
    erase_crop = wire.decode_response(replies[2 + n_free])[1]
    want, want_crop, want_erase = session_oracle(model, canvas, counter + 1)
    model.request_counter = counter + len(SESSION_STAMPS)
    for what, got, exp in (("canvas", fetched, want),
                           ("stamp crop", stamp_crop, want_crop),
                           ("erase crop", erase_crop, want_erase)):
        if not np.array_equal(got, exp):
            raise AssertionError(
                f"session: fetched {what} differs from the host oracle in "
                f"{int((got != exp).sum())} bytes")
    log(f"session: fetched {canvas.shape} canvas, the stamp's and the "
        "erase's crops byte-equal to the host oracle (per-request stamps "
        "at the same request counters)")

    server = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"ws://127.0.0.1:{server.socket.getsockname()[1]}/websocket/"
        with connect(url, max_size=None, open_timeout=60) as ws:
            ws.send(reqs[1])
            kind, message = wire.decode_error(ws.recv(timeout=60))
            if kind != R.RETURN_ERROR:
                raise AssertionError(f"session: STAMP_AT before "
                                     f"BEGIN_SESSION replied type {kind}")
            log(f"session: STAMP_AT before BEGIN_SESSION -> RETURN_ERROR "
                f"{message!r}")
            model.request_counter = counter
            ws.send(reqs[0])
            served = [ws.recv(timeout=60)]
            with connect(url, max_size=None, open_timeout=60) as other:
                other.send(reqs[0])
                kind, message = wire.decode_error(other.recv(timeout=60))
            if kind != R.RETURN_ERROR:
                raise AssertionError(f"session: a second connection's "
                                     f"BEGIN_SESSION replied type {kind}")
            log(f"session: a second connection's BEGIN_SESSION -> "
                f"RETURN_ERROR {message!r}")
            ws_acks = []
            for raw in reqs[1:]:
                t0 = time.perf_counter()
                ws.send(raw)
                served.append(ws.recv(timeout=600))
                ws_acks.append(time.perf_counter() - t0)
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if served != replies:
        raise AssertionError("session: websocket replies differ from the "
                             "request handler's")
    log("session: over the websocket, STAMP_ATs without pixels "
        "acknowledged in " + ", ".join(f"{a * 1e3:.1f}"
                                       for a in ws_acks[:n_free])
        + " ms; every reply byte-equal to wire.handle_request_bytes")
    log(f"session: phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes, len(SESSION_STAMPS)


def resnet_bodies_phase(model, twin_shapes, twin_stamps):
    """The 22 resnets of one UNet eval of `model` (the twin, module legs)
    at RES: their inputs (x, the time embedding, an up block's skip) and
    outputs captured from the module legs, then each body as two
    gn_silu_conv3x3 calls (K10) with the counts set to 0 just before and
    read just after; in the same window, conv3x3_stream (K11) as many
    times per stamp as the twin ran K7 at each K7 shape that passes
    STREAM_MIN. Each body is then held against the module leg, in bf16 and
    in an fp32 copy. Returns (launches, shapes)."""
    import copy

    import torch

    from diffusiontexturepainting_torch.models.layers import (
        ResnetBlock,
        resnet_gn_silu_conv,
    )
    from diffusiontexturepainting_torch.ops import conv3x3

    unet, u = model.unet, model.unet.cfg
    lat = RES // 8
    gen = torch.Generator(device="cuda").manual_seed(5)
    sample = torch.randn((3, lat, lat, u.in_channels), generator=gen,
                         device="cuda")
    ctx = torch.randn((3, 14, u.cross_attention_dim), generator=gen,
                      device="cuda")
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out: calls.append((mod, args,
                                                     kwargs.get("skip"),
                                                     out)),
        with_kwargs=True) for m in unet.modules()
        if isinstance(m, ResnetBlock)]
    try:
        with torch.inference_mode():
            unet(sample, 500.0, ctx)
    finally:
        for h in hooks:
            h.remove()
    want_bodies = 2 * len(u.block_out_channels) * u.layers_per_block + 2 \
        + len(u.block_out_channels)
    if len(calls) != want_bodies:
        raise AssertionError(f"resnet_bodies: {len(calls)} resnets ran, "
                             f"expected {want_bodies}")
    selected = {key: n // twin_stamps for key, n in twin_shapes.items()
                if all(d >= m for d, m in zip(
                    (key[0][1], key[0][2], key[0][3], key[1][3]),
                    STREAM_MIN))}
    streams = []
    for (xs, ws), n in sorted(selected.items()):
        x = torch.randn(xs, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(ws, generator=gen, device="cuda")
             * (9 * ws[2]) ** -0.5).bfloat16()
        streams.append((x, w, torch.randn(ws[3], generator=gen,
                                          device="cuda").bfloat16() * 0.1, n))
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    with torch.inference_mode():
        bodies = [resnet_gn_silu_conv(m, a[0], a[1], skip)
                  for m, a, skip, _ in calls]
        firsts = [[conv3x3.conv3x3_stream(x, w, b) for _ in range(n)][0]
                  for x, w, b, n in streams]
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes = {c.name: dict(c.shapes) for c in counters()}
    want = {"gn_silu_conv3x3": 2 * len(calls),
            "conv3x3_stream": sum(selected.values())}
    for name, got in launches.items():
        log(f"resnet_bodies counts: {name}: {got} launches, expected "
            f"{want.get(name, 0)}")
        if got != want.get(name, 0):
            raise AssertionError(f"resnet_bodies: {name}: {got} launches, "
                                 f"expected {want.get(name, 0)}")
    log(f"resnet_bodies: {len(calls)} bodies and {len(streams)} K11 shapes "
        f"in {secs * 1e3:.1f} ms wall")
    for (x, w, b, _), got in zip(streams, firsts):
        want_y = conv3x3.conv3x3_plain(x, w, b).float()
        err = (got.float() - want_y).abs().max().item()
        tol = TOL["bfloat16"] * want_y.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"resnet_bodies: conv3x3_stream "
                                 f"{tuple(x.shape)} err {err:.3e} > {tol:.3e}")
    worst = {"bfloat16": 0.0, "float32": 0.0}
    with torch.inference_mode():
        for i, ((m, a, skip, out), got) in enumerate(zip(calls, bodies)):
            m32 = copy.deepcopy(m).float()
            up = lambda t: None if t is None else t.float()
            x32, t32, s32 = up(a[0]), up(a[1]), up(skip)
            pairs = {"bfloat16": (got, out),
                     "float32": (resnet_gn_silu_conv(m32, x32, t32, s32),
                                 m32(x32, t32, skip=s32))}
            msg = []
            for dt, (g, w_out) in pairs.items():
                if g.shape != w_out.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"resnet_bodies: body {i}: "
                                         f"{tuple(g.shape)}")
                err = (g.float() - w_out.float()).abs().max().item()
                tol = TOL[dt] * w_out.float().abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"resnet_bodies: body {i} {dt}: "
                                         f"err {err:.3e} > tol {tol:.3e}")
                worst[dt] = max(worst[dt], err / tol)
                msg.append(f"{dt} err {err:.3e} (tol {tol:.3e})")
            del m32
            cin = a[0].shape[-1] + (0 if skip is None else skip.shape[-1])
            log(f"resnet_bodies: body {i} {tuple(a[0].shape[:3])} "
                f"{cin}->{out.shape[-1]}: " + "; ".join(msg)
                + " against ResnetBlock.forward")
    log(f"resnet_bodies: worst err/tol bf16 {worst['bfloat16']:.3f}, fp32 "
        f"{worst['float32']:.3f}")
    return launches, shapes


def _err_tol(got, want, dtype_name="bfloat16"):
    """(max|got - want|, the smoke's tolerance on want's peak)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, TOL[dtype_name] * want.float().abs().max().item()


def attn_arms_phase(gen):
    """The softmax arms through the A/B entry point's functions at the
    1024^2/4 stamp's three UNet self-attention shapes, ARM_LAUNCHES calls of
    each arm a shape, with the counts set to 0 just before and read just
    after; each output against the attention() route's (K8/K2); then the
    clamp and underflow probes. Returns (launches, shapes)."""
    import torch

    from diffusiontexturepainting_torch.ops import attention
    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.tools import attn_variants as tool

    bf16 = torch.bfloat16
    shapes = tool.SHAPE_SETS["stamp"]
    inputs = [tool.make_inputs(B, L, D, "variants", "cuda", bf16, gen)
              for _, B, L, D, _ in shapes]
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    firsts = []
    with torch.inference_mode():
        for (_, _, _, _, heads), (q, k, v) in zip(shapes, inputs):
            firsts.append({name: [tool.row_call(row, q, k, v, heads)
                                  for _ in range(ARM_LAUNCHES)][0]
                           for name, row in ARM_PATH_ROWS.items()})
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes_seen = {c.name: dict(c.shapes) for c in counters()}
    for name, got in launches.items():
        want = ARM_LAUNCHES * len(shapes) if name in ARMS else 0
        log(f"attn_arms counts: {name}: {got} launches, expected {want}")
        if got != want:
            raise AssertionError(f"attn_arms: {name}: {got} launches, "
                                 f"expected {want}")
    log(f"attn_arms: {len(ARMS)} arms x {ARM_LAUNCHES} calls at "
        f"{len(shapes)} shapes in {secs * 1e3:.1f} ms wall")
    with torch.inference_mode():
        for (label, _, _, _, heads), (q, k, v), outs in zip(shapes, inputs,
                                                            firsts):
            base = attention.attention(q, k, v, heads)
            route = attention.attention_route(q.shape[1], k.shape[1],
                                              q.shape[-1] // heads, bf16)
            for name, got in outs.items():
                err, tol = _err_tol(got, base)
                if not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(f"attn_arms: {name} at {label}: "
                                         f"err {err:.3e} > tol {tol:.3e} "
                                         f"against {route}")
                log(f"attn_arms: {name} ({ARM_PATH_ROWS[name]}) at {label} "
                    f"{tuple(q.shape)}: max|diff| {err:.3e} against the "
                    f"{route} route (tol {tol:.3e}); err/tol {err / tol:.3f}")
        del inputs, firsts, base

        # clamp: raw logits far above 83. The exact softmax is K8's (K2
        # computes the same function): it rounds the pre-scaled q to bf16
        # as the arms do; at logits ~200 scaling fp32 logits instead would
        # alone move a peaked softmax by more than the tolerance
        q, k, v = tool.make_inputs(2, 1024, 320, "clamp", "cuda", bf16, gen)
        exact = attention.flash_attention_streaming(q, k, v, 8)
        for name in ARMS:
            row = ARM_PATH_ROWS[name]
            got = tool.row_call(row, q, k, v, 8)
            err, tol = _err_tol(got, tool.row_call(row, q, k, v, 8,
                                                   plain=True))
            off, tol_k2 = _err_tol(got, exact)
            clamped = name not in EXACT_ARMS
            if not err <= tol or clamped != (off > tol_k2):
                raise AssertionError(
                    f"attn_arms: clamp probe {name}: {err:.3e} from its "
                    f"plain version (tol {tol:.3e}), {off:.3e} from K8's "
                    f"exact softmax (tol {tol_k2:.3e})")
            log(f"attn_arms: clamp probe (2, 1024, 320), raw logits > 83: "
                f"{name} {err:.3e} from its plain version (tol {tol:.3e}), "
                f"{off:.3e} from K8's exact softmax ("
                + ("differs, as the clamp must" if clamped
                   else "within tol, as the running max must") + ")")

        # underflow: every base-2 logit far below shift - 126
        q = torch.full((2, 1100, 320), 60.0, device="cuda", dtype=bf16)
        v = torch.randn((2, 1100, 320), generator=gen, device="cuda").to(bf16)
        safe = [name for name in ARMS if name not in EXACT_ARMS]
        for name in safe:
            got = tool.row_call(ARM_PATH_ROWS[name], q, -q, v, 8)
            if not torch.equal(got, torch.zeros_like(got)):
                raise AssertionError(f"attn_arms: underflow probe {name}: "
                                     "not all zeros")
        log(f"attn_arms: underflow probe (2, 1100, 320): {', '.join(safe)} "
            "(nomax_attention safe) give zeros, no NaN")
    return launches, shapes_seen


def slotted_arm_phase(gen, k13_shapes, stamps):
    """T4 (slotted_kernel_call) at the slotted path's K13 shapes, each as
    often as one stamp launches K13 there, on the (B*h, L, 128) split of
    seeded head-slotted q, k, v (split outside the counted calls, as the
    tool does), with the counts set to 0 just before and read just after;
    each output against its plain version and against K13 on the same data
    in the (B, L, h*128) layout. Returns (launches, shapes), T4's shape keys
    with the heads and head dim its kernel case needs."""
    import torch

    from diffusiontexturepainting_torch.ops import attention
    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.tools import attn_variants as tool

    cases = []
    for ((B, L, _), heads, hd), n in sorted(k13_shapes.items()):
        slots = [tool.to_slots(torch.randn((B, L, heads * hd), generator=gen,
                                           device="cuda").bfloat16(), heads)
                 for _ in range(3)]
        cases.append((heads, hd, n // stamps, slots,
                      [av.split_heads(t, heads) for t in slots]))
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    with torch.inference_mode():
        firsts = [[av.slotted_kernel_call(*split, hd**-0.5)
                   for _ in range(calls)][0]
                  for _, hd, calls, _, split in cases]
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes_seen = {c.name: dict(c.shapes) for c in counters()}
    want = {SLOTTED_ARM: sum(case[2] for case in cases)}
    for name, got in launches.items():
        log(f"slotted_arm counts: {name}: {got} launches, expected "
            f"{want.get(name, 0)}")
        if got != want.get(name, 0):
            raise AssertionError(f"slotted_arm: {name}: {got} launches, "
                                 f"expected {want.get(name, 0)}")
    log(f"slotted_arm: {SLOTTED_ARM} x {want[SLOTTED_ARM]} calls at "
        f"{len(cases)} shapes in {secs * 1e3:.1f} ms wall")
    with torch.inference_mode():
        for (heads, hd, _, slots, split), got in zip(cases, firsts):
            label = f"{tuple(split[0].shape)} hd {hd}"
            plain = av.plain_slotted_kernel_call(*split, hd**-0.5)
            err, tol = _err_tol(got, plain)
            merged = av.merge_heads(got, slots[0].shape[0])
            off, tol13 = _err_tol(merged, attention.flash_attention_slotted(
                *slots, heads, hd))
            if (not torch.isfinite(got).all() or not err <= tol
                    or not off <= tol13):
                raise AssertionError(
                    f"slotted_arm: {label}: {err:.3e} from its plain version "
                    f"(tol {tol:.3e}), {off:.3e} from K13 (tol {tol13:.3e})")
            log(f"slotted_arm: {label}: max|diff| {err:.3e} against its "
                f"plain version (tol {tol:.3e}; err/tol {err / tol:.3f}), "
                f"{off:.3e} against K13 on the same data (tol {tol13:.3e}; "
                f"err/tol {off / tol13:.3f})")
    heads_of = {tuple(split[0].shape): (heads, hd)
                for heads, hd, _, _, split in cases}
    shapes_seen[SLOTTED_ARM] = {
        (q, k, *heads_of[q], exp2): n
        for (q, k, exp2), n in shapes_seen[SLOTTED_ARM].items()}
    return launches, shapes_seen


def pv_product_phase(gen):
    """T10 at the TPU tool's three shapes (bh 1, the tool's uniform
    inputs), PV_ITERS passes a call, as e v and as (v^T e^T)^T, one call
    each, with the counts set to 0 just before and read just after; each
    output against its plain version, the orientations against each other.
    Returns (launches, shapes)."""
    import torch

    from diffusiontexturepainting_torch.ops import attention_variants as av

    inputs = [(torch.rand((1, bq, lk), generator=gen,
                          device="cuda").bfloat16(),
               torch.rand((1, lk, hd), generator=gen,
                          device="cuda").bfloat16())
              for bq, lk, hd in PV_SHAPES]
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    with torch.inference_mode():
        outs = [[av.pv_product(e, v, transposed=t, iters=PV_ITERS)
                 for t in (False, True)] for e, v in inputs]
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes_seen = {c.name: dict(c.shapes) for c in counters()}
    for name, got in launches.items():
        want = 2 * len(PV_SHAPES) if name == PV else 0
        log(f"pv_product counts: {name}: {got} launches, expected {want}")
        if got != want:
            raise AssertionError(f"pv_product: {name}: {got} launches, "
                                 f"expected {want}")
    log(f"pv_product: {launches[PV]} calls of {PV_ITERS} passes in "
        f"{secs * 1e3:.1f} ms wall")
    with torch.inference_mode():
        for (bq, lk, hd), (e, v), (direct, flipped) in zip(PV_SHAPES, inputs,
                                                           outs):
            plain = av.plain_pv_product(e, v, iters=PV_ITERS)
            msg = []
            for label, got in (("e@v", direct), ("v^T@e^T", flipped)):
                err, tol = _err_tol(got, plain)
                if not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(
                        f"pv_product: {label} at (bq {bq}, Lk {lk}, hd "
                        f"{hd}): err {err:.3e} > tol {tol:.3e}")
                msg.append(f"{label} max|diff| {err:.3e} (tol {tol:.3e}; "
                           f"err/tol {err / tol:.3f})")
            gap, _ = _err_tol(flipped, direct)
            log(f"pv_product: (bq {bq}, Lk {lk}, hd {hd}) against the plain "
                f"version: " + "; ".join(msg) + f"; the two orientations "
                f"{gap:.3e} apart")
    return launches, shapes_seen


def conv_arms_phase(gen, k5_shapes, stamps):
    """T12 and T11 at every shape at which one stamp of the default path
    launches K5 with its prologue (`k5_shapes`: K5's shape keys and counts
    over `stamps` stamps), as often as a stamp launches K5 there, with the
    counts set to 0 just before and read just after. T12 runs on seeded
    images of those shapes; T11's four tap reads run on the same images cut
    into windows of TAPS_ROWS rows with halo. The first output of each is
    held against its plain version; T12's also against K5 away from the
    border, T11's `shifted` against K11 on the image. Returns (launches,
    shapes)."""
    import torch

    from diffusiontexturepainting_torch.ops import conv3x3, gn_conv
    from diffusiontexturepainting_torch.ops import conv_variants as cv

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * std + mean

    def taps_w(w, read):
        """(3, 3, Cin, N) as the read's weights: the same memory."""
        cin, n = w.shape[2:]
        return w.view(3, 3 * cin, n) if read == "jointw" else w.view(9, cin, n)

    cases = []
    for key, n in sorted(k5_shapes.items(), key=str):
        x_shape, w_shape, has_bias, _, _, apply_gn = key
        if not apply_gn:
            continue
        (B, H, W, cin), cout = x_shape, w_shape[3]
        if H % TAPS_ROWS:
            raise AssertionError(f"conv_arms: K5 image height {H} is not a "
                                 f"multiple of {TAPS_ROWS}")
        x = rnd(*x_shape).bfloat16()
        w = rnd(*w_shape, std=(9 * cin) ** -0.5).bfloat16()
        b = rnd(cout, std=0.1).bfloat16() if has_bias else None
        a, c = rnd(B, cin, std=0.2, mean=1.0), rnd(B, cin, std=0.2)
        wp = taps_key(1, TAPS_ROWS, W, cin, cout, "shifted")[0][2]
        xwin = image_windows(x.reshape(1, B * H, W, cin), TAPS_ROWS, wp)
        cases.append((n // stamps, (x, a, c, w, b), xwin))
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    with torch.inference_mode():
        piped = [[cv.pipelined(*ins) for _ in range(n)][0]
                 for n, ins, _ in cases]
        taps = [{read: [cv.conv_window_taps(xwin, taps_w(ins[3], read), read,
                                            W=ins[0].shape[2])
                        for _ in range(n)][0]
                 for read in TAP_READS} for n, ins, xwin in cases]
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes_seen = {c.name: dict(c.shapes) for c in counters()}
    calls = sum(n for n, _, _ in cases)
    want = {PIPE: calls, TAPS: len(TAP_READS) * calls}
    for name, got in launches.items():
        log(f"conv_arms counts: {name}: {got} launches, expected "
            f"{want.get(name, 0)}")
        if got != want.get(name, 0):
            raise AssertionError(f"conv_arms: {name}: {got} launches, "
                                 f"expected {want.get(name, 0)}")
    log(f"conv_arms: {PIPE} x {calls} and {TAPS} x {want[TAPS]} calls at "
        f"{len(cases)} K5 shapes in {secs * 1e3:.1f} ms wall")

    def hold(label, got, ref, what):
        err, tol = _err_tol(got, ref)
        if not torch.isfinite(got).all() or not err <= tol:
            raise AssertionError(f"conv_arms: {label}: err {err:.3e} > tol "
                                 f"{tol:.3e} against {what}")
        return f"{err:.3e} against {what} (err/tol {err / tol:.3f})"

    with torch.inference_mode():
        for (n, ins, xwin), got, by_read in zip(cases, piped, taps):
            x, a, c, w, b = ins
            B, H, W, cin = x.shape
            label = f"{tuple(x.shape)}->{w.shape[3]} x{n}"
            k5 = k5_call(gn_conv, x, a, c, w, b)
            log(f"conv_arms: {PIPE} {label}: max|diff| "
                + hold(f"{PIPE} {label}", got,
                       cv.plain_pipelined(x, a, c, w, b),
                       "its plain version") + ", "
                + hold(f"{PIPE} {label} interior", got[:, 1:-1, 1:-1],
                       k5[:, 1:-1, 1:-1], "K5 away from the border"))
            zero = torch.zeros(w.shape[3], dtype=x.dtype, device="cuda")
            for read, out in by_read.items():
                msg = hold(f"{TAPS} {read} {label}", out,
                           cv.plain_conv_window_taps(xwin, taps_w(w, read),
                                                     read, W=W),
                           "its plain version")
                if read == "shifted":
                    msg += ", " + hold(
                        f"{TAPS} shifted {label} as a conv",
                        out.reshape(1, B * H, W, -1),
                        conv3x3.conv3x3_stream(
                            x.reshape(1, B * H, W, cin), w, zero),
                        "K11 on the image")
                log(f"conv_arms: {TAPS} {read} {tuple(xwin.shape)}: "
                    f"max|diff| {msg}")
    return launches, shapes_seen


def release():
    """Returns the memory of the models the caller dropped to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def tma_refusal_probe(gen):
    """The bf16 K2, K8 and K13 (csrc/flash_attention_sm90.cu), K9
    (csrc/conv_sm90.cu) and K1/K5 (csrc/gn_conv_sm90.cu) refuse operands
    TMA cannot describe with ValueError and launch nothing: K2 and K8 at
    hd 36 (a 72-byte head stride), K13 on views of a projection whose rows
    are 8 bytes off 16, K9 and K1/K5 at Cin 20 and at Cout 12 (rows of 40
    and 24 bytes) and on an input 2 bytes off 16, K5 at Cout 3 without the
    padded weight; K3 (csrc/ff_geglu_sm90.cu) at C 36, at inner 36 and on
    an input 2 bytes off 16; K4, K6 and K7 (csrc/gn_conv_sm90.cu's upsample
    and PLAIN modes) at Cin 20, at Cout 12 and on an input 2 bytes off 16;
    T10 (csrc/pv_product_sm90.cu) at Lk 1100, at hd 36 and on an e 2 bytes
    off 16; T4 (csrc/flash_attention_sm90.cu's slotted mode) at P 36 and on
    a q 2 bytes off 16. Then csrc/conv3x3.cu's fp32 entries of K7, K4 and
    K6, attn_transposed.cu's T10 and attn_layouts.cu's T4 called in bf16:
    each returns cudaErrorInvalidValue, and the conv entries' split plans
    -1."""
    import torch

    from diffusiontexturepainting_torch.ops import (
        attention,
        conv3x3,
        ff_geglu,
        gn_conv,
    )
    from diffusiontexturepainting_torch.ops import attention_variants as av

    x = torch.randn((1, 256, 4 * 36), generator=gen,
                    device="cuda").bfloat16()
    qkv = torch.randn((1, 256, 3 * 1024 + 4), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (qkv[..., i * 1024:(i + 1) * 1024] for i in range(3))
    xc = torch.randn((1, 16, 16, 20), generator=gen, device="cuda").bfloat16()
    wc = torch.randn((3, 3, 20, 16), generator=gen, device="cuda").bfloat16()
    xd = torch.randn((1, 16, 16, 16), generator=gen, device="cuda").bfloat16()
    wd = torch.randn((3, 3, 16, 12), generator=gen, device="cuda").bfloat16()
    flat = torch.randn(1 + 16 * 16 * 16, generator=gen,
                       device="cuda").bfloat16()
    off = flat[1:].view(1, 16, 16, 16)
    w16 = torch.randn((3, 3, 16, 16), generator=gen,
                      device="cuda").bfloat16()
    w3 = torch.randn((3, 3, 16, 3), generator=gen, device="cuda").bfloat16()
    a20 = torch.rand((1, 20), generator=gen, device="cuda") + 0.5
    c20 = torch.randn((1, 20), generator=gen, device="cuda")
    a16, c16 = a20[:, :16].contiguous(), c20[:, :16].contiguous()

    def ff(n, c, inner, offset=0):
        t = torch.randn(offset + n * c, generator=gen, device="cuda")
        x = t.bfloat16()[offset:].view(n, c)
        w0, w2 = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                  for shape in ((2 * inner, c), (c, inner)))
        b0 = torch.zeros(2 * inner, device="cuda").bfloat16()
        return lambda: ff_geglu.ff_geglu(x, w0, b0, w2, b0[:c].contiguous(),
                                         x.contiguous())

    def up(x, cout, stats=False):
        w = torch.randn((3, 3, x.shape[-1], cout), generator=gen,
                        device="cuda").bfloat16()
        taps = conv3x3.fold_upsample_weights(w)
        if stats:
            return lambda: gn_conv.upconv_stream(x, w, None, taps)
        return lambda: conv3x3.upsample2x_conv3x3(x, w, None, taps)
    calls = {"flash_attention (1, 256, 144), 4 heads":
             lambda: attention.flash_attention(x, x, x, 4),
             "flash_attention_streaming (1, 256, 144), 4 heads":
             lambda: attention.flash_attention_streaming(x, x, x, 4),
             "flash_attention_slotted, rows 6152 bytes apart":
             lambda: attention.flash_attention_slotted(q, k, v, 8, 40),
             "downconv_stream Cin 20":
             lambda: gn_conv.downconv_stream(xc, wc, None),
             "downconv_stream Cout 12":
             lambda: gn_conv.downconv_stream(xd, wd, None),
             "downconv_stream x 2 bytes off 16":
             lambda: gn_conv.downconv_stream(off, w16, None),
             "gn_conv_resident Cin 20":
             lambda: gn_conv.gn_conv_resident(xc, a20, c20, wc, None),
             "gn_conv_stream Cout 12":
             lambda: gn_conv.gn_conv_stream(xd, a16, c16, wd, None),
             "gn_conv_stream Cout 3, unpadded":
             lambda: gn_conv.gn_conv_stream(xd, a16, c16, w3, None, None,
                                            False),
             "gn_conv_resident x 2 bytes off 16":
             lambda: gn_conv.gn_conv_resident(off, a16, c16, w16, None),
             "ff_geglu C 36": ff(64, 36, 128),
             "ff_geglu inner 36": ff(64, 64, 36),
             "ff_geglu x 2 bytes off 16": ff(64, 64, 128, offset=1),
             "upsample2x_conv3x3 Cin 20": up(xc, 16),
             "upsample2x_conv3x3 Cout 12": up(xd, 12),
             "upsample2x_conv3x3 x 2 bytes off 16": up(off, 16),
             "upconv_stream Cin 20": up(xc, 16, True),
             "upconv_stream Cout 12": up(xd, 12, True),
             "upconv_stream x 2 bytes off 16": up(off, 16, True),
             "conv3x3 Cin 20": lambda: conv3x3.conv3x3(xc, wc, None),
             "conv3x3 Cout 12": lambda: conv3x3.conv3x3(xd, wd, None),
             "conv3x3 x 2 bytes off 16":
             lambda: conv3x3.conv3x3(off, w16, None)}
    e_flat = torch.rand(1 + 64 * 1096, generator=gen,
                        device="cuda").bfloat16()
    v_ok = torch.rand((1, 1096, 40), generator=gen, device="cuda").bfloat16()
    e_ok = e_flat[:64 * 1096].view(1, 64, 1096)
    e_1100 = torch.rand((1, 64, 1100), generator=gen,
                        device="cuda").bfloat16()
    v_1100 = torch.rand((1, 1100, 40), generator=gen,
                        device="cuda").bfloat16()
    v_36 = torch.rand((1, 1096, 36), generator=gen, device="cuda").bfloat16()
    s_36 = torch.randn((2, 64, 36), generator=gen, device="cuda").bfloat16()
    s_flat = torch.randn(1 + 2 * 64 * 128, generator=gen,
                         device="cuda").bfloat16()
    s_off = s_flat[1:].view(2, 64, 128)
    calls.update({
        "pv_product Lk 1100": lambda: av.pv_product(e_1100, v_1100),
        "pv_product hd 36": lambda: av.pv_product(e_ok, v_36),
        "pv_product e 2 bytes off 16":
        lambda: av.pv_product(e_flat[1:].view(1, 64, 1096), v_ok),
        "slotted_kernel_call P 36":
        lambda: av.slotted_kernel_call(s_36, s_36, s_36, 0.1),
        "slotted_kernel_call q 2 bytes off 16":
        lambda: av.slotted_kernel_call(s_off, s_off, s_off, 0.1)})
    counters = (attention.flash_launches, attention.flash_streaming_launches,
                attention.flash_slotted_launches,
                gn_conv.downconv_stream_launches,
                gn_conv.gn_conv_resident_launches,
                gn_conv.gn_conv_stream_launches, ff_geglu.ff_geglu_launches,
                conv3x3.upsample_launches, gn_conv.upconv_stream_launches,
                conv3x3.conv3x3_launches, av.pv_product_launches,
                av.slotted_launches)
    before = [c.launches for c in counters]
    for label, call in calls.items():
        try:
            call()
        except ValueError as e:
            log(f"probe: {label}: refused ({e})")
        else:
            raise AssertionError(f"probe: {label} was not refused")
    if [c.launches for c in counters] != before:
        raise AssertionError("probe: a refused call launched a kernel")
    # the fp32 twins' entries, called in bf16 on tensors that fit them
    from diffusiontexturepainting_torch import _cuda

    x8 = torch.randn((1, 8, 8, 16), generator=gen, device="cuda").bfloat16()
    out = torch.empty((1, 16, 16, 16), dtype=torch.bfloat16, device="cuda")
    stats = torch.empty((1, 2, 16), device="cuda")
    ptrs = (x8.data_ptr(), w16.data_ptr(), w16.data_ptr(), out.data_ptr())
    stream = _cuda.stream_of(x8)
    codes = {
        "dtp_conv3x3": _cuda.function("conv3x3", "dtp_conv3x3",
                                      conv3x3._ARGTYPES)(
            *ptrs, None, 1, 8, 8, 16, 16, 1, 1, stream),
        "dtp_upsample2x_conv3x3": _cuda.function(
            "conv3x3", "dtp_upsample2x_conv3x3", conv3x3._ARGTYPES)(
            *ptrs, None, 1, 8, 8, 16, 16, 1, 1, stream),
        "dtp_upsample2x_conv3x3_stats": _cuda.function(
            "conv3x3", "dtp_upsample2x_conv3x3_stats", gn_conv._UP_ARGTYPES)(
            *ptrs, stats.data_ptr(), stats.data_ptr(), stats.data_ptr(), 1,
            8, 8, 16, 16, 1, 1, 1, stream),
        "dtp_pv_product": _cuda.function(
            "attn_transposed", "dtp_pv_product", av._PV_ARGTYPES)(
            e_ok.data_ptr(), v_ok.data_ptr(), out.data_ptr(), 1, 8, 8, 8, 1,
            0, 1, stream),
        "dtp_slotted_attention": _cuda.function(
            "attn_layouts", "dtp_slotted_attention", av._SLOTTED_ARGTYPES)(
            x8.data_ptr(), x8.data_ptr(), x8.data_ptr(), out.data_ptr(), 1,
            8, 8, 16, 0.1, 1, 1, stream)}
    splits = {symbol: _cuda.function("conv3x3", f"{symbol}_splits",
                                     conv3x3._SPLIT_ARGTYPES)(
        1, 8, 8, 16, 16, 1)
        for symbol in ("dtp_conv3x3", "dtp_upsample2x_conv3x3")}
    torch.cuda.synchronize()
    if set(codes.values()) != {1} or set(splits.values()) != {-1}:
        raise AssertionError(f"probe: fp32 entries in bf16 gave {codes}, "
                             f"split plans {splits}")
    log(f"probe: conv3x3.cu's, attn_transposed.cu's T10 and attn_layouts.cu's "
        f"T4 fp32 entries refuse bf16: {codes} (cudaErrorInvalidValue), "
        "conv split plans -1")


def replay_probe(gen):
    """bf16 K9 at the default stamp's three shapes, K1/K5 at a split-K, a
    whole-image and a tiled shape, K14 on K1/K5's inputs, K3 and K4 at the
    default stamp's shapes whose K splits, K6 at the default stamp's three
    shapes and a forced split, K7 at three of the safe twin's split
    shapes, T10 at its tool's three shapes in both orientations (the
    partials of many CTAs added by the last) and T4 at the slotted arm's
    two shapes in both softmax flavours, each twice on the same inputs:
    outputs and statistics bit-identical (fixed reduction orders, no float
    atomics); K1/K5's and K14's statistics also those of their own
    outputs, K6's those of its fp32 output before the rounding
    (STATS_SELF_TOL)."""
    import torch
    import torch.nn.functional as F

    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.ops import ff_geglu, gn_conv

    for bq, lk, hd in PV_SHAPES:
        for transposed in (False, True):
            key = ((1, bq, lk), (1, lk, hd), transposed, PV_ITERS)
            kernel = kernel_case(PV, key, torch.bfloat16, gen)[0]
            first, again = kernel(), kernel()
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"probe: {PV} {key} differs on replay")
            plan = av.pv_sm90_plan(1, bq, lk, hd, PV_ITERS, transposed)
            log(f"probe: {PV} {key} bf16 ({plan['ctas']} CTAs: "
                f"{plan['tiles']} tiles x {plan['nk']} chunks of "
                f"{plan['chunk']} keys x {plan['gc']}): bit-identical on "
                "replay")
    for L, hd in ((4096, 40), (1024, 80)):
        for exp2_bf16 in (True, False):
            key = ((24, L, 128), (24, L, 128), 8, hd, exp2_bf16)
            kernel = kernel_case(SLOTTED_ARM, key, torch.bfloat16, gen)[0]
            first, again = kernel(), kernel()
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"probe: {SLOTTED_ARM} {key} differs "
                                     "on replay")
            log(f"probe: {SLOTTED_ARM} {key} bf16: bit-identical on replay")

    for n, c, inner in ((768, 640, 2560), (192, 1280, 5120),
                        (48, 1280, 5120)):
        key = (n, c, inner)
        kernel = kernel_case("ff_geglu", key, torch.bfloat16, gen)[0]
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"probe: ff_geglu {key} differs on replay")
        splits = ff_geglu.ff_sm90_plan(*key)["down"]["splits"]
        log(f"probe: ff_geglu {key} bf16 ({splits} splits): bit-identical "
            "on replay")
    for B, H, C in ((3, 4, 1280), (3, 8, 1280), (3, 16, 640)):
        key = ((B, H, H, C), (3, 3, C, C))
        kernel = kernel_case("upsample2x_conv3x3", key, torch.bfloat16,
                             gen)[0]
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"probe: upsample2x_conv3x3 {key} differs "
                                 "on replay")
        splits = gn_conv.upconv_sm90_plan(B, H, H, C, C)["splits"]
        log(f"probe: upsample2x_conv3x3 {key} bf16 ({splits} splits): "
            "bit-identical on replay")
    # K6 at the default 256^2 stamp's three sources (the first splits K),
    # and forced to split where it does not
    from diffusiontexturepainting_torch.ops import conv3x3

    for B, H, C, forced in ((1, 32, 512, None), (1, 64, 512, None),
                            (1, 128, 256, None), (2, 16, 256, 3)):
        key = ((B, H, H, C), (3, 3, C, C), True)
        x = per_image(torch.randn(key[0], generator=gen, device="cuda"),
                      0.5).bfloat16()
        w = (torch.randn(key[1], generator=gen, device="cuda")
             * (9 * C) ** -0.5).bfloat16()
        b = (torch.randn(C, generator=gen, device="cuda") * 0.1).bfloat16()
        taps = conv3x3.fold_upsample_weights(w)
        first, again = (gn_conv._upconv_stream(x, b, taps, True, forced)
                        for _ in range(2))
        w4 = conv3x3.transposed_upsample_weight(taps).float()
        pre = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), w4,
                                 b.float(), stride=2,
                                 padding=1).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if not (torch.equal(first[0], again[0])
                and torch.equal(first[1], again[1])):
            raise AssertionError(f"probe: upconv_stream {key} differs on "
                                 "replay")
        e = stats_self_err(pre, first[1])
        if not e <= STATS_SELF_TOL:
            raise AssertionError(f"probe: upconv_stream {key}: statistics "
                                 f"off its fp32 output by {e:.3e} of the "
                                 "sums")
        plan = gn_conv.upconv_sm90_plan(B, H, H, C, C, forced, True)
        log(f"probe: upconv_stream {key} bf16 ({plan['splits']} splits, "
            f"{plan['tpi']} tiles an image): output and statistics "
            "bit-identical on replay; statistics against its fp32 output "
            f"before the rounding {e:.2e} of the sums")
    # K7 at the safe twin's split shapes
    for B, H, cin, cout in ((3, 4, 2560, 1280), (3, 8, 2560, 1280),
                            (3, 16, 1920, 640)):
        key = ((B, H, H, cin), (3, 3, cin, cout))
        kernel = kernel_case("conv3x3", key, torch.bfloat16, gen)[0]
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"probe: conv3x3 {key} differs on replay")
        splits = gn_conv.same_sm90_plan(B, H, H, cin, cout)["splits"]
        log(f"probe: conv3x3 {key} bf16 ({splits} splits): bit-identical "
            "on replay")

    for h, c in ((128, 128), (64, 256), (32, 512)):
        x = torch.randn((2, 2 * h, 2 * h, c), generator=gen,
                        device="cuda").bfloat16()
        w = (torch.randn((3, 3, c, c), generator=gen, device="cuda")
             * (9 * c) ** -0.5).bfloat16()
        b = (torch.randn(c, generator=gen, device="cuda") * 0.1).bfloat16()
        first, again = (gn_conv.downconv_stream(x, w, b) for _ in range(2))
        torch.cuda.synchronize()
        if not (torch.equal(first[0], again[0])
                and torch.equal(first[1], again[1])):
            raise AssertionError(f"probe: downconv_stream {tuple(x.shape)} "
                                 "differs on replay")
        log(f"probe: downconv_stream {tuple(x.shape)} x {tuple(w.shape)} "
            "bf16: output and statistics bit-identical on replay")
    from diffusiontexturepainting_torch.ops import groupnorm

    for B, H, cin, cout in ((3, 4, 1280, 1280), (3, 8, 640, 1280),
                            (3, 32, 320, 320), (2, 256, 128, 128)):
        x = per_image(torch.randn((B, H, H, cin), generator=gen,
                                  device="cuda"), 0.5).bfloat16()
        w = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
             * (9 * cin) ** -0.5).bfloat16()
        b = (torch.randn(cout, generator=gen, device="cuda") * 0.1).bfloat16()
        a = torch.rand((B, cin), generator=gen, device="cuda") + 0.5
        c = torch.randn((B, cin), generator=gen, device="cuda") * 0.2
        r = per_image(torch.randn((B, H, H, cout), generator=gen,
                                  device="cuda"), 0.25).bfloat16()
        first, again = (gn_conv.gn_conv_resident(x, a, c, w, b, r)
                        for _ in range(2))
        m1, m2 = (groupnorm.spatial_moments(x) for _ in range(2))
        torch.cuda.synchronize()
        if not (torch.equal(first[0], again[0])
                and torch.equal(first[1], again[1]) and torch.equal(m1, m2)):
            raise AssertionError(f"probe: gn_conv_resident or "
                                 f"spatial_moments {tuple(x.shape)} differs "
                                 "on replay")
        e = max(stats_self_err(*first), stats_self_err(x, m1))
        if not e <= STATS_SELF_TOL:
            raise AssertionError(f"probe: gn_conv_resident or "
                                 f"spatial_moments {tuple(x.shape)}: "
                                 f"statistics off their own outputs by "
                                 f"{e:.3e} of the sums")
        plan = gn_conv.gn_conv_sm90_plan(B, H, H, cin, cout)
        log(f"probe: gn_conv_resident {tuple(x.shape)} x {tuple(w.shape)} "
            f"bf16 ({plan['splits']} splits, {plan['tpi']} tiles an image) "
            "and spatial_moments: output and statistics bit-identical on "
            f"replay; statistics against their own outputs {e:.2e} of the "
            "sums")


def weight_slice_probe(gen):
    """The split concat conv's two K1 calls on halves of one weight read in
    place (w[:, :, :ca] and w[:, :, ca:]) at the UNet's up-path shapes,
    against the plain version on contiguous copies, statistics included
    (also against those of the output itself, STATS_SELF_TOL)."""
    import torch

    from diffusiontexturepainting_torch.ops import gn_conv

    for B, H, ca, cs, cout in ((3, 4, 1280, 1280, 1280),
                               (3, 8, 1280, 640, 1280),
                               (3, 32, 640, 320, 320)):
        x = per_image(torch.randn((B, H, H, ca + cs), generator=gen,
                                  device="cuda"), 0.5).bfloat16()
        w = (torch.randn((3, 3, ca + cs, cout), generator=gen, device="cuda")
             * (9 * (ca + cs)) ** -0.5).bfloat16()
        b = (torch.randn(cout, generator=gen, device="cuda") * 0.1).bfloat16()
        a = torch.rand((B, ca + cs), generator=gen, device="cuda") + 0.5
        c = torch.randn((B, ca + cs), generator=gen, device="cuda") * 0.2
        xa, xs = x[..., :ca].contiguous(), x[..., ca:].contiguous()
        h1, _ = gn_conv.gn_conv_resident(xa, a[:, :ca], c[:, :ca],
                                         w[:, :, :ca], b, None, False)
        h, st = gn_conv.gn_conv_resident(xs, a[:, ca:], c[:, ca:],
                                         w[:, :, ca:], None, h1, True)
        p1, _ = gn_conv.gn_conv3x3_plain(xa, a[:, :ca], c[:, :ca],
                                         w[:, :, :ca].contiguous(), b, None,
                                         False)
        p, pst = gn_conv.gn_conv3x3_plain(xs, a[:, ca:], c[:, ca:],
                                          w[:, :, ca:].contiguous(), None, p1)
        err, tol = _err_tol(h, p)
        yf = p.float()
        worst = err / tol
        for row, scale in enumerate((yf.abs().sum((1, 2)).max().item(),
                                     yf.square().sum((1, 2)).max().item())):
            e = (st[:, row] - pst[:, row]).abs().max().item()
            worst = max(worst, e / (TOL["bfloat16"] * scale))
        worst = max(worst, stats_self_err(h, st) / STATS_SELF_TOL)
        if not worst <= 1.0:
            raise AssertionError(f"probe: weight slices {(ca, cs, cout)}: "
                                 f"err/tol {worst:.3f}")
        log(f"probe: gn_conv_resident on w[:, :, :{ca}] and w[:, :, {ca}:] "
            f"of (3, 3, {ca + cs}, {cout}) read in place, x {tuple(x.shape)} "
            f"bf16: err/tol {worst:.3f} (output and statistics)")


def self_note(r):
    """The log's note of compare's statistics-against-own-output check."""
    if "stats_self_err" not in r:
        return ""
    return (f"; statistics against its own output {r['stats_self_err']:.2e} "
            f"of the sums (bound {STATS_SELF_TOL:.2e})")


def kernels_phase(gen, paths):
    """Every kernel at every shape of every path, both dtypes; timed at the
    shapes of the path it is reported for. Returns the JSON records."""
    import torch

    record = []
    for name in SOURCES:
        path = REPORTED_ON.get(name, "default")
        run = paths[path]
        if not run["launches"][name]:
            raise AssertionError(f"kernels: {name} was not launched on the "
                                 f"{path} path")
        counts = run["shapes"][name]
        also = ALSO_REPORTED_ON.get(name)
        also_counts = paths[also]["shapes"][name] if also else {}
        keys = sorted(set().union(*(paths[p]["shapes"][name]
                                    for p in paths)), key=str)
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
        totals = Counter()
        also_totals = Counter()
        by_option = Counter()
        lib_missing = False
        self_worst = 0.0
        for key in keys:
            count = counts.get(key, 0)
            also_count = also_counts.get(key, 0)
            for dt in errs:
                r = compare(name, key, dt, gen,
                            timed=(dt == torch.bfloat16
                                   and count + also_count > 0))
                errs[dt] = max(errs[dt], r["max_abs_err"])
                worst[dt] = max(worst[dt], r["err_over_tol"])
                self_worst = max(self_worst, r.get("stats_self_err", 0.0))
                msg = (f"kernels: {name} {key} {str(dt)[6:]}: max_abs_err "
                       f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}, "
                       f"max|plain| {r['peak']:.3e}); err/tol "
                       f"{r['err_over_tol']:.3f}"
                       + (" (output and statistics)"
                          if r.get("stats_checked") else "")
                       + self_note(r))
                if "kernel_ms" in r:
                    b_s, by = bound_s(name, key, "bfloat16")
                    for field, ms in (("kernel", r["kernel_ms"]),
                                      ("plain", r["plain_ms"]),
                                      ("library", r["library_ms"] or 0.0),
                                      ("bound", b_s * 1e3)):
                        also_totals[field] += also_count * ms
                    totals["kernel"] += count * r["kernel_ms"]
                    if name in OPTION_OF:
                        by_option[OPTION_OF[name](key)] += (
                            count * r["kernel_ms"])
                    totals["plain"] += count * r["plain_ms"]
                    totals["bound"] += count * b_s * 1e3
                    totals[by] += count * b_s * 1e3
                    if r["library_ms"] is None:
                        lib_missing |= name not in PARTIAL_YARDSTICKS
                    else:
                        totals["library"] += count * r["library_ms"]
                    if "family_ms" in r:
                        totals["family"] += count * r["family_ms"]
                    for field in ("composition", "kernel_device",
                                  "library_device", "composition_device"):
                        if f"{field}_ms" in r:
                            totals[field] += count * r[f"{field}_ms"]
                            also_totals[field] += also_count * r[
                                f"{field}_ms"]
                    lib = ("none" if r["library_ms"] is None
                           else f"{r['library_ms']:.4f} ms")
                    if "composition_ms" in r:
                        lib += (f", composition "
                                f"{r['composition_ms']:.4f} ms")
                    msg += (f"; {r['kernel_ms']:.4f} ms kernel, "
                            f"{r['plain_ms']:.4f} ms plain, library {lib}, "
                            f"bound {b_s * 1e3:.4f} ms ({by}), "
                            f"x{count // run['stamps']} per stamp"
                            + (f" ({path}), x"
                               f"{also_count // paths[also]['stamps']} "
                               f"({also})" if also else ""))
                log(msg)
                torch.cuda.empty_cache()
        n = run["stamps"]
        na = paths[also]["stamps"] if also else 1
        if name in FAMILY_IS:
            log(f"kernels: {name}: {totals['kernel'] / n:.4f} ms beside "
                f"{FAMILY_IS[name]} {totals['family'] / n:.4f} ms at the same "
                f"shapes and launches ({path} path)")
        record.append({
            "name": name, "route": "cuda",
            "source": "diffusiontexturepainting_torch/" + SOURCES[name],
            "replaces": REPLACES[name], "path": path,
            "launches": run["launches"][name],
            "launches_by_path": {p: paths[p]["launches"][name]
                                 for p in paths},
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "max_err_over_tol": worst[torch.bfloat16],
            "max_err_over_tol_fp32": worst[torch.float32],
            "ms": totals["kernel"] / n, "plain_ms": totals["plain"] / n,
            "bound_ms": totals["bound"] / n,
            "bound_by": ("operations"
                         if totals["operations"] >= totals["bytes"]
                         else "bytes"),
            "library_ms": None if lib_missing else totals["library"] / n,
            "ms_is": MS_IS.get(name, f"bf16 kernel time per stamp of the "
                                     f"{path} path ({run['res']}^2, "
                                     f"{run['steps']} steps), summed over "
                                     "its shapes"),
            **({"family_ms": totals["family"] / n,
                "family_is": FAMILY_IS[name]} if name in FAMILY_IS else {}),
            **({"stats_self_err": self_worst}
               if name in STATS_SELF_KINDS + STATS_PRE_KINDS else {}),
            **({"device_ms": totals["kernel_device"] / n,
                "library_device_ms": (None if lib_missing
                                      else totals["library_device"] / n)}
               if name in DEVICE_TIMED else {}),
            **({"composition_ms": totals["composition"] / n,
                "composition_device_ms": totals["composition_device"] / n,
                "composition_is": COMPOSITION_IS[name]}
               if name in COMPOSITION_IS else {}),
            **({"ms_by_option": {k: v / n for k, v in by_option.items()}}
               if by_option else {}),
            **({"library_is": LIBRARY_IS[name]} if name in LIBRARY_IS
               else {}),
            **({also: {"launches": paths[also]["launches"][name],
                       **{f"{f}_ms": (None if lib_missing and "library" in f
                                      else also_totals[f] / na)
                          for f in ("kernel", "plain", "library", "bound")
                          + (("kernel_device", "library_device")
                             if name in DEVICE_TIMED else ())
                          + (("composition", "composition_device")
                             if name in COMPOSITION_IS else ())}}}
               if also else {})})
        # the yardstick beside a kernel in the log: the library call, or
        # the composition where no one call computes the function
        yard = ("composition" if name in COMPOSITION_IS
                and name not in LIBRARY_IS else "library")
        if name in DEVICE_TIMED:
            log(f"kernels: {name} device time (CUDA-graph replays): "
                f"{totals['kernel_device'] / n:.4f} ms a stamp, {yard} "
                f"{totals[yard + '_device'] / n:.4f} ({path} path)"
                + (f"; {also_totals['kernel_device'] / na:.4f}, {yard} "
                   f"{also_totals[yard + '_device'] / na:.4f} ({also} path)"
                   if also else ""))
        if also:
            log(f"kernels: {name} at the {also} path's shapes: "
                f"{also_totals['kernel'] / na:.4f} ms a stamp, plain "
                f"{also_totals['plain'] / na:.4f}, {yard} "
                f"{also_totals[yard] / na:.4f}, bound "
                f"{also_totals['bound'] / na:.4f}")
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.core.config import (
        safe_twin_config,
        slotted_config,
    )
    from diffusiontexturepainting_torch.ops import conv3x3 as conv3x3_mod
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    t_start = time.perf_counter()
    card = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    secs = _cuda.build_all()
    log(f"build: {secs:.1f} s for {', '.join(_cuda.SOURCES)}")
    for name, report in _cuda.build_reports.items():
        entry = ""  # the kernel (mangled name) ptxas reports on
        for line in report.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {entry}: {line.strip()}")
            if (name in NO_SPILL and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads"
                    not in line):
                raise AssertionError(f"build: {name} spills: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    probes = [
        ("conv3x3", ((3, 32, 32, 320), (3, 3, 320, 320))),
        ("conv3x3", ((1, 64, 64, 512), (3, 3, 512, 256))),
        # K4 (bf16: csrc/gn_conv_sm90.cu's upsample mode) at its served
        # shapes at 256^2, 512^2 and 1024^2, then ragged: Cin 64 -> Cout
        # 72 on 5 x 7, odd H and W at batch 1, a 1x1 image
        *[("upsample2x_conv3x3", ((3, h, h, c), (3, 3, c, c)))
          for h, c in ((4, 1280), (8, 1280), (16, 640), (16, 1280),
                       (32, 640), (32, 1280), (64, 640))],
        ("upsample2x_conv3x3", ((1, 5, 7, 64), (3, 3, 64, 72))),
        ("upsample2x_conv3x3", ((1, 9, 19, 40), (3, 3, 40, 136))),
        ("upsample2x_conv3x3", ((2, 1, 1, 16), (3, 3, 16, 8))),
        # K2 at its launched shapes: UNet level 0 and the VAE mid-blocks of
        # 256^2 (hd 40, 512), levels 1 and 2 of 1024^2 (hd 80, 160); ragged
        # lengths at hd 160 and 512
        ("flash_attention", ((3, 1024, 320), (3, 1024, 320), 8)),
        ("flash_attention", ((1, 1024, 512), (1, 1024, 512), 1)),
        ("flash_attention", ((2, 1024, 512), (2, 1024, 512), 1)),
        ("flash_attention", ((3, 4096, 640), (3, 4096, 640), 8)),
        ("flash_attention", ((3, 1024, 1280), (3, 1024, 1280), 8)),
        ("flash_attention", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("flash_attention", ((1, 1100, 512), (1, 1100, 512), 1)),
        # images straddling statistics chunks, ragged widths and channels,
        # no bias / no prologue, split-K with statistics
        ("gn_conv_resident", ((3, 4, 4, 1280), (3, 3, 1280, 1280),
                              True, True, True, True)),
        ("gn_conv_resident", ((2, 5, 7, 40), (3, 3, 40, 24),
                              False, True, True, True)),
        ("gn_conv_stream", ((2, 9, 10, 16), (3, 3, 16, 3),
                            True, False, False, True)),
        ("gn_conv_stream", ((1, 16, 16, 64), (3, 3, 64, 128),
                            True, True, True, False)),
        # bf16 K1/K5 (csrc/gn_conv_sm90.cu): Cin 96 -> Cout 40 on 4x4
        # images at batch 3 (one tile, split K), odd H and W with Cout off
        # the 128-channel tile, the VAE's heads (Cout 8; Cout 3 through the
        # zero-padded weight, stored one element at a time)
        ("gn_conv_resident", ((3, 4, 4, 96), (3, 3, 96, 40),
                              True, True, True, True)),
        ("gn_conv_stream", ((2, 33, 31, 64), (3, 3, 64, 136),
                            True, True, True, True)),
        ("gn_conv_stream", ((2, 32, 32, 512), (3, 3, 512, 8),
                            True, False, False, True)),
        ("gn_conv_stream", ((1, 64, 64, 128), (3, 3, 128, 3),
                            True, False, False, True)),
        # K6 (bf16: csrc/gn_conv_sm90.cu's upsample mode with statistics):
        # ragged (Cin off 64, Cout off 128, odd H and W, one pixel, several
        # images a tile, no statistics)
        ("upconv_stream", ((1, 6, 5, 48), (3, 3, 48, 40), True)),
        ("upconv_stream", ((1, 9, 19, 40), (3, 3, 40, 136), True)),
        ("upconv_stream", ((2, 1, 1, 16), (3, 3, 16, 8), True)),
        ("upconv_stream", ((5, 3, 3, 8), (3, 3, 8, 16), True)),
        ("upconv_stream", ((2, 17, 33, 24), (3, 3, 24, 40), False)),
        # K7 (bf16: csrc/gn_conv_sm90.cu's PLAIN mode): ragged, as K6
        ("conv3x3", ((2, 12, 10, 96), (3, 3, 96, 136))),
        ("conv3x3", ((1, 9, 19, 40), (3, 3, 40, 136))),
        ("conv3x3", ((2, 1, 1, 16), (3, 3, 16, 8))),
        ("conv3x3", ((5, 3, 3, 8), (3, 3, 8, 16))),
        # K3 (bf16: csrc/ff_geglu_sm90.cu) at its served shapes (one UNet
        # eval at 256^2, 512^2, 1024^2), then ragged: N 1, 37, 100, C 96,
        # inner 384
        *[("ff_geglu", (n, c, 4 * c))
          for n, c in ((3072, 320), (768, 640), (192, 1280), (48, 1280),
                       (12288, 320), (3072, 640), (49152, 320),
                       (12288, 640), (3072, 1280), (768, 1280))],
        ("ff_geglu", (100, 96, 384)),
        ("ff_geglu", (37, 64, 256)),
        ("ff_geglu", (1, 96, 384)),
        # the 1024^2 envelope's 16384-token attentions (UNet level 0, VAE
        # mid block), and a ragged length
        ("flash_attention_streaming",
         ((3, 16384, 320), (3, 16384, 320), 8)),
        ("flash_attention_streaming",
         ((1, 16384, 512), (1, 16384, 512), 1)),
        ("flash_attention_streaming", ((2, 1100, 640), (2, 1100, 640), 4)),
        ("flash_attention_streaming", ((1, 1100, 512), (1, 1100, 512), 1)),
        # the slotted self-attentions of 256^2 and 512^2 (levels 0 and 1)
        ("flash_attention_slotted", ((3, 1024, 1024), 8, 40)),
        ("flash_attention_slotted", ((3, 256, 1024), 8, 80)),
        ("flash_attention_slotted", ((3, 4096, 1024), 8, 40)),
        # the stride-2 downsample (K9): the default stamp's three calls,
        # then odd sizes (the last row and column dropped), ragged
        # channels, a single row band, no statistics
        *[("downsample_conv3x3_stats", ((2, 2 * h, 2 * h, c), (3, 3, c, c),
                                        True))
          for h, c in ((128, 128), (64, 256), (32, 512))],
        ("downsample_conv3x3_stats", ((1, 18, 34, 48), (3, 3, 48, 40),
                                      True)),
        ("downsample_conv3x3_stats", ((2, 7, 9, 24), (3, 3, 24, 136),
                                      True)),
        ("downsample_conv3x3_stats", ((2, 2, 2, 16), (3, 3, 16, 8), True)),
        ("downsample_conv3x3_stats", ((1, 32, 32, 256), (3, 3, 256, 256),
                                      False)),
        # the moments: the UNet's 4x4 level, channels off the 16-byte
        # groups (scalar path), two channel slices, one row
        ("spatial_moments", ((3, 4, 4, 1280),)),
        ("spatial_moments", ((2, 9, 7, 40),)),
        ("spatial_moments", ((1, 32, 32, 2560),)),
        ("spatial_moments", ((2, 1, 1, 8),)),
        # the staged-tile mode: Cin 3 and 9 (one ragged channel chunk),
        # odd H and W, a 1x1 image, Cout off the tile, a UNet 4x4 level
        ("conv3x3_inpad", ((2, 5, 7, 3), (3, 3, 3, 40))),
        ("conv3x3_inpad", ((1, 1, 1, 9), (3, 3, 9, 24))),
        ("conv3x3_stream", ((1, 17, 9, 48), (3, 3, 48, 130))),
        ("upsample2x_conv3x3_inpad", ((1, 6, 5, 48), (3, 3, 48, 40))),
        ("upsample2x_conv3x3_inpad", ((3, 4, 4, 1280), (3, 3, 1280, 1280))),
        ("gn_silu_conv3x3", ((2, 9, 10, 64), (3, 3, 64, 136), True, True,
                             32)),
        ("gn_silu_conv3x3", ((3, 4, 4, 2560), (3, 3, 2560, 1280), True,
                             False, 32)),
        # the softmax arms: head dims 40, 80, 160 (the kernel's register
        # tiles), a ragged length, the options the attn_arms path does not
        # run (T3's keys a multiple of its chunk)
        ("nomax_attention", ((2, 1100, 320), (2, 1100, 320), 8, False,
                             False)),
        ("nomax_attention", ((2, 1100, 640), (2, 1100, 640), 8, True, True)),
        ("chunked_attention", ((2, 1100, 640), (2, 1152, 640), 8, 128,
                               False)),
        ("chunked_attention", ((2, 1100, 320), (2, 1152, 320), 8, 64, True)),
        ("nomax_unpadded", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("nomax_unpadded", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("pvt_attention", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("pvt_attention", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        # the layout arms at each register tile and a ragged length; T4 at
        # 128 lanes with fp32 logits (the option the slotted_arm path does
        # not run), with P = hd (no pad lanes), at the 160-lane bucket in
        # both flavours (keys != queries) and at 64 lanes
        ("nomax_4d", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("nomax_allheads", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("nomax_laneslice", ((2, 1100, 640), (2, 1100, 640), 8)),
        ("slotted_kernel_call", ((8, 1100, 128), (8, 1100, 128), 4, 40,
                                 False)),
        ("slotted_kernel_call", ((8, 1100, 80), (8, 1100, 80), 4, 80, True)),
        ("slotted_kernel_call", ((4, 1100, 160), (4, 1100, 160), 2, 150,
                                 True)),
        ("slotted_kernel_call", ((4, 300, 160), (4, 777, 160), 2, 160,
                                 False)),
        ("slotted_kernel_call", ((8, 300, 64), (8, 777, 64), 4, 64, True)),
        # T1 at each register tile, a ragged length, keys != queries
        ("sublane_attention", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("sublane_attention", ((2, 1100, 640), (2, 1000, 640), 8)),
        ("sublane_attention", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        # T10: bq off the 64-row tile, Lk off every key chunk, hd off the
        # wgmma N buckets and m64 tiles (bf16 needs Lk and hd multiples of
        # 8: TMA's 16-byte rows), several bh
        ("pv_product", ((3, 100, 1096), (3, 1096, 40), True, 3)),
        ("pv_product", ((2, 200, 1096), (2, 1096, 72), False, 2)),
        ("pv_product", ((2, 72, 200), (2, 200, 152), True, 2)),
        ("pv_product", ((2, 72, 200), (2, 200, 152), False, 1)),
        ("pv_product", ((2, 130, 264), (2, 264, 8), False, 5)),
        # fp32 T10 (the FMA twin, csrc/attn_transposed.cu) also where bf16's
        # TMA cannot go: Lk 1100, hd 150
        ("pv_product", ((3, 100, 1100), (3, 1100, 40), True, 3),
         (torch.float32,)),
        ("pv_product", ((2, 72, 200), (2, 200, 150), True, 2),
         (torch.float32,)),
        ("pv_product", ((2, 72, 200), (2, 200, 150), False, 1),
         (torch.float32,)),
        # T12 at the TPU tool's shapes, then odd H and W, Cin 3 and 40, Cout
        # off the tile, a 1x1 image, no bias
        ("pipelined", ((2, 512, 512, 128), (3, 3, 128, 128), True)),
        ("pipelined", ((1, 512, 512, 128), (3, 3, 128, 128), True)),
        ("pipelined", ((1, 256, 256, 256), (3, 3, 256, 256), True)),
        ("pipelined", ((2, 5, 7, 3), (3, 3, 3, 40), True)),
        ("pipelined", ((1, 9, 19, 40), (3, 3, 40, 130), False)),
        ("pipelined", ((1, 1, 1, 9), (3, 3, 9, 24), True)),
        # T11's four reads at the TPU tool's shapes (one window, reps 24),
        # then odd H_T and W, Cin 3 and 40, N off the tile, several windows
        *[("conv_window_taps", taps_key(1, h_t, W, cin, n, read, 24))
          for h_t, W, cin, n in ((16, 128, 512, 128), (8, 256, 256, 256),
                                 (8, 512, 128, 128))
          for read in TAP_READS],
        *[("conv_window_taps", taps_key(nwin, h_t, W, cin, n, read, reps))
          for nwin, h_t, W, cin, n, reps in ((3, 5, 9, 3, 40, 3),
                                             (2, 3, 19, 40, 130, 1))
          for read in TAP_READS],
    ]
    for kind, key, *only in probes:
        dtypes = only[0] if only else (torch.bfloat16, torch.float32) + (
            (torch.float16,) if kind == "spatial_moments" else ())
        for dt in dtypes:
            r = compare(kind, key, dt, gen)
            log(f"probe: {kind} {key} {str(dt)[6:]}: max_abs_err "
                f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}, max|plain| "
                f"{r['peak']:.3e}); err/tol {r['err_over_tol']:.3f}"
                + self_note(r))
    tma_refusal_probe(gen)
    replay_probe(gen)
    weight_slice_probe(gen)
    torch.cuda.empty_cache()

    paths = {}

    def drive(label, model, steps, res, in_pad=False):
        first, launches, shapes, n = run_path(label, model, steps, res)
        check_counts(label, model, steps, launches, n, res, in_pad)
        paths[label] = dict(launches=launches, shapes=shapes, stamps=n,
                            steps=steps, res=res)
        return first

    log("default: requests routed through diffusiontexturepainting_torch."
        "serving.wire.handle_request_bytes")
    model = TorchConditionalInpainter(resolution=RES, device="cuda")
    log(f"default: model built in {model.init_seconds:.1f} s (full SD-1.5 "
        f"width, random weights, {model.dtype}, {model.config}); unet "
        f"{sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M "
        "params")
    drive("default", model, STEPS, RES)
    weights = model.state_dicts()

    twin = TorchConditionalInpainter(resolution=RES, config=safe_twin_config(),
                                     device="cuda", weights=weights)
    log(f"twin: built from the default model's state_dict in "
        f"{twin.init_seconds:.1f} s")
    twin_first = drive("twin", twin, TWIN_STEPS, RES)
    compare_stamps("twin", first_stamp_at(model, TWIN_STEPS), twin_first,
                   f"the default and the safe twin at {TWIN_STEPS} steps")

    # the same requests at the same counters, the switch set as the JAX
    # package's tests set it
    twin.request_counter = 0
    conv3x3_mod._IN_PAD = True
    try:
        inpad_first = drive("twin_inpad", twin, TWIN_STEPS, RES, in_pad=True)
    finally:
        conv3x3_mod._IN_PAD = False
    compare_stamps("twin_inpad", inpad_first, twin_first,
                   "the safe twin with _IN_PAD on and off")

    launches, shapes = resnet_bodies_phase(
        twin, paths["twin"]["shapes"]["conv3x3"], paths["twin"]["stamps"])
    paths["resnet_bodies"] = dict(launches=launches, shapes=shapes, stamps=1,
                                  steps=1, res=RES)
    del twin
    release()

    serve_phase(model)
    launches, shapes, n = session_phase(model)
    check_counts("session", model, FEW_STEPS, launches, n)
    paths["session"] = dict(launches=launches, shapes=shapes, stamps=n,
                            steps=FEW_STEPS, res=RES)
    del model
    release()

    envelope = TorchConditionalInpainter(resolution=ENVELOPE_RES,
                                         device="cuda", weights=weights)
    log(f"envelope: default configuration at {ENVELOPE_RES}^2 built from "
        f"the same state_dict in {envelope.init_seconds:.1f} s")
    drive("envelope", envelope, FEW_STEPS, ENVELOPE_RES)
    del envelope
    release()

    slotted = TorchConditionalInpainter(resolution=SLOTTED_RES,
                                        config=slotted_config(),
                                        device="cuda", weights=weights)
    log(f"slotted: {slotted.config} at {SLOTTED_RES}^2 built from the same "
        f"state_dict in {slotted.init_seconds:.1f} s")
    slotted_first = drive("slotted", slotted, FEW_STEPS, SLOTTED_RES)
    del slotted
    release()
    default512 = TorchConditionalInpainter(resolution=SLOTTED_RES,
                                           device="cuda", weights=weights)
    default512.set_brush(requests()[0])
    compare_stamps("slotted", first_stamp_at(default512, FEW_STEPS,
                                             SLOTTED_RES), slotted_first,
                   f"the default and the slotted configuration at "
                   f"{SLOTTED_RES}^2 / {FEW_STEPS} steps")
    del default512, weights
    release()

    launches, shapes = attn_arms_phase(gen)
    paths["attn_arms"] = dict(launches=launches, shapes=shapes, stamps=1,
                              steps=FEW_STEPS, res=ENVELOPE_RES)
    release()
    launches, shapes = slotted_arm_phase(
        gen, paths["slotted"]["shapes"]["flash_attention_slotted"],
        paths["slotted"]["stamps"])
    paths["slotted_arm"] = dict(launches=launches, shapes=shapes, stamps=1,
                                steps=FEW_STEPS, res=SLOTTED_RES)
    release()

    launches, shapes = pv_product_phase(gen)
    paths["pv_product"] = dict(launches=launches, shapes=shapes, stamps=1,
                               steps=0, res=0)
    launches, shapes = conv_arms_phase(
        gen, paths["default"]["shapes"]["gn_conv_stream"],
        paths["default"]["stamps"])
    paths["conv_arms"] = dict(launches=launches, shapes=shapes, stamps=1,
                              steps=STEPS, res=RES)
    release()

    record = kernels_phase(gen, paths)

    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "diffusiontexturepainting_tpu", "tornado",
                        "PIL"))
    if loaded:
        raise AssertionError(f"the run imported {loaded}")
    log("no jax: neither jax, nor diffusiontexturepainting_tpu, nor tornado, "
        "nor PIL in sys.modules")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
