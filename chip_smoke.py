#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own lines; any failure raises (nonzero exit):
  1. device    the card's name and power limit (nvidia-smi);
  2. build     nvcc builds every kernel from csrc/, in parallel, seconds
               printed; ptxas's registers and spills, none allowed in the
               bf16 K2/K8/K13 kernel (csrc/flash_attention_sm90.cu), the
               bf16 K9 kernel (csrc/conv_sm90.cu), the bf16 K1/K5, K4, K6,
               K7, K10 and T12 kernels (csrc/gn_conv_sm90.cu), the bf16 K3
               kernel
               (csrc/ff_geglu_sm90.cu), the bf16 T10 kernel
               (csrc/pv_product_sm90.cu) or the bf16 T11 kernel
               (csrc/window_taps_sm90.cu);
  3. probe     each kernel against its plain version at a few shapes,
               K2 at its four launched head dims (40, 80, 160, 512) and a
               ragged length, the 16384-token streaming attentions (K8)
               and a ragged hd-512 one, the slotted attentions of 256^2 and
               512^2 (K13), K9 at the default stamp's three shapes and
               ragged and odd ones, K1/K5 at ragged shapes (Cin 96 ->
               Cout 40 on 4x4 images at batch 3, odd H and W, the VAE's
               Cout 8 and 3 heads) and on the split concat conv's weight
               halves read in place, and the spatial moments (K14) among
               them, K6 and K7 at ragged shapes, K12a and K11 at ragged
               shapes TMA can describe (bf16) and at Cin 3 and 9 and Cout
               130 (fp32), K12b at ragged shapes and a UNet 4x4 level,
               K10 and T12 (bf16: the affine mode of csrc/gn_conv_sm90.cu)
               at odd H and W, Cin 8 and 40, Cout 130, a 1x1 image, several
               images a tile (K10: the 4x4 level at batch 3 with temb; T12
               also without bias), Cin 3 and 9 in fp32 only, T12 at the TPU
               tool's shapes, T11's four reads at the TPU tool's shapes
               (reps 24) and at ragged ones (Cin 3 in fp32 only); K9,
               K1/K5, K14, K6, K7, K12b, K10, T12 (under the plan's and a
               forced split of K) and T11 bit-identical on replay, output
               and statistics; K6's
               statistics also against its own fp32 output before the
               rounding; T10, T4, T7, T9, T5, T2, T6 and T8 bit-identical
               on replay; the bf16 K2/K8/K13, K9, K1/K5, K3, K4, K6, K7,
               K12a, K11, K12b, K10, T10, T4, T7, T9, T2, T5, T6, T8, T11
               and T12 refuse what TMA cannot describe (ValueError, no
               launch); the fp32 entries of csrc/conv3x3.cu, conv_staged.cu's
               SAME, UP and GN entries (fp32 K12a, K11, K12b and K10), T10's
               (attn_transposed.cu), T4's, T6's, T7's and T8's
               (attn_layouts.cu), T2's, T5's and T9's (attn_arms.cu) and
               T11's and T12's (conv_arms.cu) refuse bf16;
  4. default   the served configuration (PipelineConfig(): every fused
               switch on): full-width SD-1.5 (seeded random weights, bf16)
               at 256^2 / 20 DDIM steps: one NEW_BRUSH_IMAGE and three
               NEW_STAMP requests as wire bytes through the port's request
               handler (serving/wire.py), plus a replay of the first stamp
               that must be bit-identical, each reply checked; then each
               kernel's launches in that run against the count derived from
               the configuration;
  4b. cfg     --mesh model=3 (parallel/cfg_shard.py): the default
               configuration with its UNet's three guidance branches on
               three cards (cuda:0 three times on a one-card machine, the
               case logged), through the handler as the default path
               (256^2 / 20, a replay byte-equal), then a DeepCache-2 stamp
               and a 256^2 / 4 session STAMP_AT: each byte-equal to the
               same stamp with its UNet evaluated a branch at a time on
               cuda:0, each within SELF_MEAN_DIFF / SELF_MAX_DIFF of the
               ordinary model's, each kernel launched as three batch-1
               UNet evals a model call give; both models' stamp walls;
  5. twin      the same for the "safe twin" (every fused switch off, module
               legs only), built from the default model's state_dict, at
               4 DDIM steps; then the first stamps of the two
               configurations at equal steps, compared in u8;
  5b. twin_inpad
               the twin again with the port's _IN_PAD switch set (the
               in-kernel-padding kernels K12a/b take every call of K7/K4;
               bf16 K12a runs K7's kernel and K12b K4's, counted apart),
               as phase 4; its first stamp byte-equal to the twin's;
  5c. resnet_bodies
               the 22 resnets of one UNet eval of the twin at 256^2 (batch
               3, their inputs captured from the module legs), each as two
               gn_silu_conv3x3 calls (K10; in bf16 K14's sums, then the
               affine mode of csrc/gn_conv_sm90.cu), held against the module
               leg in bf16 and fp32; and K11 (conv3x3_stream; in bf16 K7's kernel,
               counted apart) as often as the twin ran K7, at each of its K7
               shapes that pass the JAX package's streaming_plan shape test;
  6. server    the port's server (serving/server.py) on loopback around
               the default model: GET /health, then a NEW_BRUSH_IMAGE, a
               NEW_BRUSH_PROMPT and a NEW_STAMP over a websocket, each reply
               byte-equal to the request handler's at the same request
               counter; then the model's StageTimer table (utils/
               profiling.py: brush-encode, stamp xN, stamp u8 xN; wall and
               device ms a stage);
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
  6b2. engine  the engine (core/engine.py), through which every phase
               here serves its stamps, session stamps, batches and brush
               encodes (a CUDA graph a point, captured at its first call or
               warm-up and replayed; the counters add a capture's launches
               at each replay): at each ENGINE_POINTS point (the default
               model at 256^2/20, 512^2/4, 1024^2/4, DeepCache 2 at
               256^2/20, FSSF at 512^2/4; the safe twin, the f32 final
               step and EulerA at 256^2/4) the warm-up's capture seconds
               and pool bytes, served stamps (replays) alternated with the
               eager stamp function (eager_stamps), wall median and
               quartiles of each, one replay's device ms, each busy share,
               the first stamp after the warm-up against the later ones;
               three requests of changing cfg, tg, tg_steps, pad, brush and
               counter through the one program, each byte-equal to the
               eager stamp on its arguments, their launches
               expected_per_stamp each; batches of 1 to 4 at 256^2/20
               through the service against the eager stamp.batched, byte
               for byte; a session's STAMP_AT acks, eager beside graph,
               both canvases byte-equal to the host oracle. The checkpoint
               phase holds a program captured before reload_params against
               the reloaded weights;
  6c. schedulers
               the default configuration with each of the other schedulers
               (DPM++, EulerA, LMS, PNDM), built from the default model's
               state_dict: one 256^2 / 20 NEW_STAMP through the request
               handler, the reply checked, the kernels' launches against
               the configuration at the scheduler's model calls (PNDM 21),
               the stamp against the safe twin's with the same scheduler at
               the same request counter, compared in u8; EulerA's twice at
               one counter, byte-equal;
  6d. checkpoint
               the default model saved in the JAX package's npz format to
               a temporary directory (weights/loader.py; its bytes and
               seconds), a model built from it: every state_dict entry bit
               for bit and a NEW_STAMP byte-equal at the same request
               counter; a model seeded otherwise, reload_params from it:
               the same bytes; then the entry point as a user starts it,
               in processes of its own: `serving.run --checkpoint_dir DIR
               --scheduler EulerA --warmup-points 256x20`, the same seeded
               weights with --no-warmup and no checkpoint, each one's first
               NEW_STAMP (over the websocket of the first, over POST
               /inpaint of the second) byte-equal, walls side by side, and
               a --mock server with no card visible; every process stopped;
               the directory removed;
  6d2. convert the reference's released artifacts written from the default
               model's weights (the UNet as a diffusers-named .bin, the VAE
               as an AutoencoderKL .safetensors of F16 tensors in the old
               attention names, a seeded rank-4 attn-procs LoRA over every
               UNet attention projection, image_encoder.pth with an
               OpenAI-named CLIP tower, a seeded CLIPTextModel-named text
               tower in fp16), converted by `python -m
               diffusiontexturepainting_torch.weights.convert` in a process
               of its own (seconds and bytes a component); a model seeded
               otherwise reload_params from the result: every state_dict
               entry bit for bit the written weights after their float32 /
               F16 round trip with the LoRA merged, a NEW_STAMP (256^2 / 4)
               byte-equal to a model given those weights directly and
               unlike the base model's, the default path's launches; the
               text tower from load_text_encoder, bit for bit, through
               encode_prompt in bf16 on the card against fp32 on the CPU
               (TEXT_MAX_ERR, TEXT_MEAN_ERR); the phase within
               CONVERT_MAX_S;
  6d3. client  the painting client (client/) on the default model: a UV
               sphere of 65,024 faces (256 longitudes x 128 bands, one UV
               atlas) through the port's save_obj / load_obj; the
               rasterizer's kernel (csrc/raster.cu) against rasterize_plain
               on the arguments of a TexturePainter stamp's 256^2 view and
               its 1024^2 back-projection at three brush positions, one
               across the UV seam: face_idx and the features byte-equal,
               kernel and plain CUDA-event ms beside the bound; then a
               full-width 256^2/20 TexturePainter stroke (six BrushStroke
               stamps, an Overpaint and an Erase stamp, an undo), each
               update painting texels and leaving the rest byte-equal,
               Erase leaving zeros, the undo restoring the texture
               byte-equal, the model's launches against 7 stamps and the
               rasterizer's 2 a stamp (counted from 0), render / generate /
               backproject / update ms a stamp; then the port's server in
               this process, 2 TexturePainter stamps over the port's
               WebsocketConditionalInpainter (a NEW_BRUSH_IMAGE, then a
               NEW_STAMP whose painted region comes back within a level)
               and a CanvasStrokePainter stroke of 8 STAMP_ATs without
               waiting and one FETCH_CANVAS, the canvas byte-equal outside
               the stamps, the painted band within a level, the stamped
               region painted; the phase's seconds;
  6e. deep_cache
               DeepCache at full width through the request handler, as
               phase 4 (the replay bit-identical, replies checked, each
               kernel's launches against the stamp's schedule of full and
               shallow model calls): interval 2 on the default model at
               256^2 / 20 steps, the FSSF pattern on a default model at
               512^2 / 4; each first stamp's mean and max u8 distance to
               the exact schedule's, a full and a shallow UNet eval's ms;
               a stroke session under FSSF at 256^2 / 4 (the session's
               requests), its fetched canvas byte-equal to the host oracle;
  6f. f32      --f32-final-step at 256^2 / 20 (the last model call on the
               fp32 module legs over the bf16 weights upcast) and
               --f32-components unet at 256^2 / 4, as phase 4 with the fp32
               twins' launches (K7, K4, K2; K1, K3, K14, K4, K2) checked
               apart from the bf16 ones; each first stamp's distance to the
               all-fp32-UNet stamp beside the bf16 stamp's, at 20 and 4
               steps; then `serving.run --deep-cache-interval 2
               --f32-final-step --warmup-points 256x20x2` in a process of
               its own, its first websocket reply byte-equal to the
               in-process model's;
  6g. run_flags
               servers assembled by serving/run.py build_server on
               loopback: a cold one (--no-warmup) and a warmed one
               (--warmup-points 256x4,512x4: the warm-up seconds), each
               one's first NEW_STAMP over HTTP POST /inpaint, walls side by
               side, byte-equal; POST /inpaint byte-equal to the request
               handler, 400 for BEGIN_SESSION; --debug_dir's files;
               --profile-dir's trace of a websocket NEW_STAMP naming the
               port's kernels (namespace dtp) among its CUDA events;
  6h. train    training (training/train.py) at full SD-1.5 width, random
               frozen towers, bf16: 8 seeded 512^2 textures written with
               the port's PNG writer; main() for 4 steps at 256^2, batch 2,
               checkpoints at 2 and 4, then resumed from the latest to 6:
               the logged loss and grad_norm finite, every LoRA up factor
               non-zero at step 2 and 6, no serving kernel launched (the
               step runs in ops.conv3x3.conv_impl("plain"), the JAX
               trainer's design); the validation grid (a DDIM-20 stamp on
               the merged weights) called directly: its shape, its result
               panel not flat, K7, K4 and K2 launched; the export served a
               NEW_STAMP through the request handler, checked as phase 4;
               a tiny fp32 step on the card (no TF32, cuDNN deterministic)
               against the CPU: loss and grad_norm within rtol 1e-4, the
               trainables within rtol 1e-4 / atol 1e-6 but for at most
               0.5% of elements (Adam's eps regime), each within lr / 2;
               one step's s/step, samples/s, host batch prep seconds and
               peak memory at batch 2, and train.main's samples/s end to
               end at the JAX default 32, on 32 textures; the
               committed JPEG fixtures (tests/fixtures/jpeg) decoded on the
               host, each to its manifest's sha256 of Pillow's decode, the
               640^2 baseline and progressive ones timed, and copied beside
               the PNG textures, so that main() trains on both kinds (the
               reads counted by kind);
  6h2. ddp     data-parallel training: main() with --mesh_data 2 at full
               width, 256^2, bf16, global batch 4, 2 steps, a checkpoint at
               2, then the export; on one card the two ranks share cuda:0
               over gloo, on two or more each has its own card over NCCL
               (logged); the ranks' trainables bitwise equal (their sha256,
               all-gathered), one export and one checkpoint set, written by
               rank 0, no serving kernel launched in a rank; against the
               same argv with --mesh_data 1: each step's loss and grad_norm
               within DDP_LOSS_RTOL / DDP_GNORM_RTOL, the trainables within
               DDP_MAX_LR lr and at most DDP_FLIP_SHARE of them beyond
               lr / 2; then model_axis: the one-rank argv with
               --mesh_model 2 (two ranks, the frozen towers sharded over
               them: gloo sharing cuda:0, or NCCL on two cards), each
               step's loss and grad_norm, the trainables and the export
               bitwise equal to the one-rank run's, each rank's frozen
               tower bytes at rest and peak memory;
  6i. batched  concurrent painters (--mesh data=1 --max-batch 4) on the
               default model: one batch of 4 requests of mixed settings and
               brushes at 256^2 / 20 and at 1024^2 / 4 through the service
               (serving/parallel_model.py), each kernel's launches against
               one stamp's plus the launches a split over the batch added
               (LaunchCounter.split: the encoder's 1024^2 K5 calls at batch
               8 overflow the grid's y limit), each request's mean and max
               u8 distance to itself alone (within SELF_MEAN_DIFF and
               SELF_MAX_DIFF) with the painted region byte-equal, and a
               planted mix-up of the slots' settings that those limits
               must catch; the batch's wall and peak memory (the batch's
               and a lone request's programs captured first), the split K5
               shape against its plain version; then `serving.run --mesh
               data=1 --max-batch 4` (the default 3 ms window) in a
               process of its own: stamps/s at 1, 2 and 4 concurrent
               clients at 256^2 / 20 and 512^2 / 4, each client painting
               for THROUGHPUT_SECONDS or THROUGHPUT_STAMPS stamps, with
               the batches' sizes from /health (batches above 1 required
               with 2 and 4 clients), two concurrent stroke sessions each
               byte-equal to its own host oracle;
  6j. data_mesh
               --mesh data=2 on two cards (cuda:0 twice on a one-card
               machine, logged): the batched phase's batch of 4 at 256^2 /
               20 as two shares of 2, each request byte-equal to its pair
               batched on one card, each kernel launched as two batches of
               two; two stroke sessions pinned to the two slots painting
               three STAMP_ATs each at once from two threads, each canvas
               byte-equal to its stamps replayed one at a time on cuda:0;
  7. envelope  the default configuration at 1024^2 / 4 DDIM steps (the
               engine envelope: 16384-token attention through K8), as
               phase 4, with its peak device memory;
  8. slotted   slotted_config() (head-slotted self-attention, K13) at
               512^2 / 4 steps, as phase 4; its first stamp against the
               default configuration's at 512^2 / 4, compared in u8;
  9a. attn_arms
               eight arms of the attention kernels through the A/B entry
               point's functions (diffusiontexturepainting_torch.tools.
               attn_variants): the softmax arms T2 no-max (safe) and T5
               unpadded no-max (heads split by one copy pass) (bf16 on the
               one-pass mode of csrc/flash_attention_sm90.cu against the
               static shift, head-major; T5 T2's launch on the copies),
               T3 chunked at 64-key chunks (bf16 on the chunked mode of
               csrc/flash_attention_sm90.cu: the max per 64-column half of
               a 128-key tile, K2's own launch at hd 160) and T9 (P V with
               the fp32 p; bf16 on the one-pass mode of
               csrc/flash_attention_sm90.cu, p as bf16 hi + lo), the
               head-layout arms T6 (heads read in place, head-major blocks:
               bf16 T2's safe launch) and T8 (head fastest: bf16 that launch
               on the head-fastest grid) and T7 (all heads in one block;
               bf16 on the one-pass all-heads mode of
               csrc/flash_attention_sm90.cu), and T1 (the exact row-max
               softmax; bf16 on the chunked mode in one chunk of every
               key), at the 1024^2 / 4 stamp's three UNet self-attention
               shapes, each launched as often as that stamp launches K8/K2
               there (20 a shape), each output against the attention()
               route's, and T3 at the route's K/V tile equal to it bit for
               bit, T5, T6 and T8 equal to T2 and T2 to T7 on T9's
               head-major grid bit for bit; the
               clamp probe (raw logits above 83: the clamped arms equal
               their plain versions and differ from the exact softmax of K8,
               which rounds q as the arms do; T3 and T1 equal it) and the
               underflow probe (every exp2 underflows: zeros from the safe
               arms, no NaN); the overflow probe (base-2 logits above
               shift + 128 in some query rows: T2 unclamped, with either p,
               non-finite in exactly the rows and heads its plain version
               is, T2 safe and T5 finite); the P precision probe (T9's,
               T7's and T2's path outputs and T2 with bf16 p at the hd-160
               shape against float64 evaluations with p unrounded, with
               bf16(p) and with bf16(exp2(bf16(s - shift))), rounded to
               bf16: T9 nearer the first, T7 and T2 the second, T2's bf16 p
               the third, each by P_PRECISION_MARGIN; at the hd-80
               shape, T3 at chunk 1024 with each p, the path's T3 (chunk
               64) and T1 against float64 evaluations of the running-max
               softmax under each chunk and p: each output nearer its own
               than the neighbours a kernel that mistook its chunk or its
               p would compute, by the same margin);
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
               the conv arms at every shape at which the default 256^2 /
               20 stamp launches K5 with its prologue, as often as one
               stamp launches K5 there: T12 (pipelined:
               conv3x3_VALID(silu(pad(x)*a + c)) + b; bf16 on the affine
               mode of csrc/gn_conv_sm90.cu) on seeded images of
               those shapes, against its plain version and, away from the
               border, against K5; T11 (conv_window_taps; bf16 on
               csrc/window_taps_sm90.cu) on the same images cut into row
               windows of 8 rows with halo, each of its four tap reads,
               against its plain version, `shifted` also against K11 on
               the image;
  9. kernels   each kernel against its plain version at every shape any
               path launched it at, in bf16 and fp32 (TF32 off),
               statistics included; CUDA-event times of the kernel, its
               plain version and the one PyTorch call that computes the
               same function where there is one (for K1/K5 and K9 the conv
               alone), at the shapes of the path it is reported for, beside
               its bound (K2, K3, K4, K6, K9, K1, K5 and K14 also at the
               envelope path's; K1/K5, K14, K3, K4, K6, K7, K12a, K11,
               K12b, K10, T4, T10, T11, T12 and the attention arms also in
               CUDA-graph device time, with their family member's; K12a
               and K11 beside K7 and K12b beside K4 at the same shapes,
               equal to it bit for bit in bf16; T10 also
               beside a chain of PV_ITERS torch.baddbmm calls, as many
               products);
 10. no jax    the run imported neither JAX, nor the JAX package, nor
               tornado, nor PIL.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record: the 27 kernels of the pallas_call sites, then
the rasterizer (csrc/raster.cu, the client phase's; no pallas_call).
"""

from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import threading
import time
from collections import Counter
from contextlib import nullcontext

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
CARD = [""]  # the card's name and power limit, as CARD_QUERY prints them
RES, STEPS, TWIN_STEPS = 256, 20, 4
ENVELOPE_RES, SLOTTED_RES, FEW_STEPS = 1024, 512, 4
# train.main's steps at batch 32 in the train phase's end-to-end run (3:
# the samples/s of steps 2-3; 6 before the ddp phase joined the smoke)
E2E_STEPS = 3
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
    # bf16 (the paths' and the timed type): K7's kernel (K12b: K4's),
    # counted apart; fp32 runs conv_staged.cu
    "conv3x3_inpad": "csrc/gn_conv_sm90.cu",
    "upsample2x_conv3x3_inpad": "csrc/gn_conv_sm90.cu",
    "conv3x3_stream": "csrc/gn_conv_sm90.cu",
    # bf16: K14's sums, then the affine mode; fp32 runs conv_staged.cu
    "gn_silu_conv3x3": "csrc/gn_conv_sm90.cu",
    # bf16; fp32 runs attn_arms.cu
    "nomax_attention": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_arms.cu
    "chunked_attention": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_arms.cu
    "nomax_unpadded": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_arms.cu
    "pvt_attention": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_layouts.cu
    "nomax_4d": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_layouts.cu
    "nomax_allheads": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_layouts.cu
    "nomax_laneslice": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_layouts.cu
    "slotted_kernel_call": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_transposed.cu
    "sublane_attention": "csrc/flash_attention_sm90.cu",
    # bf16; fp32 runs attn_transposed.cu
    "pv_product": "csrc/pv_product_sm90.cu",
    # bf16; fp32 runs conv_arms.cu
    "conv_window_taps": "csrc/window_taps_sm90.cu",
    # bf16 (the affine mode); fp32 runs conv_arms.cu
    "pipelined": "csrc/gn_conv_sm90.cu",
}
# the arms of the attn_arms path (the softmax arms, then the head-layout
# arms) and the slotted-input arm of the slotted_arm path
ARMS = ("nomax_attention", "chunked_attention", "nomax_unpadded",
        "pvt_attention", "nomax_4d", "nomax_allheads", "nomax_laneslice",
        "sublane_attention")
SLOTTED_ARM = "slotted_kernel_call"
# the arms that read the heads in place on T2-safe's launch in bf16: T6 on
# its head-major grid, T8 on the head-fastest one
IN_PLACE_ARMS = ("nomax_4d", "nomax_laneslice")
# the exact row-max arms: no clamp, no static shift
EXACT_ARMS = ("chunked_attention", "sublane_attention")
# T9 (p unrounded into P V), T7 and T2 (bf16(p)) and T2 with bf16 p
# (bf16(exp2(bf16(s - shift)))), and T3 and T1 (the chunk of the running
# max, p's precision): each output's mean distance to its own function's
# float64 evaluation times this is at most its distance to each
# neighbour's (the emulations read about 400 apart for T9 and T7)
P_PRECISION_MARGIN = 16.0
# The overflow probe's query rows whose base-2 logits pass shift + 128:
# every OVERFLOW_EVERY-th, q there OVERFLOW_GAIN times its own key row
OVERFLOW_EVERY, OVERFLOW_GAIN = 7, 64.0
# T3's chunk in the chunk probe: the TPU tool's default
CHUNK_PROBE_BK = 1024
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
# same shapes, timed beside each kernel that has one.
FAMILY_IS = {
    "conv3x3_inpad": "K7 (conv3x3, _IN_PAD off: in bf16 the PLAIN mode of "
                     "gn_conv_sm90.cu)",
    "conv3x3_stream": "K7 (conv3x3, _IN_PAD off: in bf16 the PLAIN mode of "
                      "gn_conv_sm90.cu)",
    "upsample2x_conv3x3_inpad": "K4 (upsample2x_conv3x3, _IN_PAD off: in "
                                "bf16 the upsample mode of gn_conv_sm90.cu)",
    "gn_silu_conv3x3": "K14 + gn_affine_from_stats + K1 (gn_conv_resident "
                       "with the residual; the time embedding not added)",
    **{name: "K8 at (3, 16384, 320), K2 at the other two shapes (the "
             "attention() route)" for name in ARMS
       if name not in IN_PLACE_ARMS},
    "nomax_4d": "T2 safe (nomax_attention, safe=True: in bf16 the same "
                "launch of flash_attention_sm90.cu's one-pass mode)",
    "nomax_laneslice": "T2 safe (nomax_attention, safe=True: in bf16 the "
                       "same CTAs of flash_attention_sm90.cu's one-pass "
                       "mode on the head-major grid)",
    SLOTTED_ARM: "K13 (flash_attention_slotted) on the same data in the "
                 "(B, L, h*128) layout",
    TAPS: "K11 (conv3x3_stream; a Cout off 8 zero-padded and dropped) on "
          "the image the windows were cut from, "
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
# their library call's and their family member's: the kernels this round
# of work redesigned
DEVICE_TIMED = ("gn_conv_resident", "gn_conv_stream", "spatial_moments",
                "ff_geglu", "upsample2x_conv3x3", "upconv_stream", "conv3x3",
                "conv3x3_inpad", "conv3x3_stream",
                "upsample2x_conv3x3_inpad", SLOTTED_ARM, PV, TAPS,
                "nomax_allheads", "pvt_attention", "sublane_attention",
                "chunked_attention", "nomax_attention", "nomax_unpadded",
                *IN_PLACE_ARMS, "gn_silu_conv3x3", PIPE)
# Kernels whose family member (FAMILY_IS) runs the same launch in bf16
# (T8: the same CTAs on another grid): their outputs must equal its bit for
# bit (T3 where its chunk is the K/V tile of the bucket, with fp32 p:
# K8/K2's launch; family_exact).
FAMILY_EXACT = ("conv3x3_inpad", "conv3x3_stream",
                "upsample2x_conv3x3_inpad", "chunked_attention",
                *IN_PLACE_ARMS)
# the sources whose ptxas report must show no spill
NO_SPILL = ("flash_attention_sm90", "conv_sm90", "gn_conv_sm90",
            "ff_geglu_sm90", "pv_product_sm90", "window_taps_sm90")
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


def family_exact(kind, shape_key):
    """Whether a FAMILY_EXACT kernel runs its family member's launch at
    `shape_key`: always, but for T3, which does where its chunk is a one-tile
    chunk with fp32 p (chunked_sm90_plan's `online`)."""
    if kind not in FAMILY_EXACT:
        return False
    if kind != "chunked_attention":
        return True
    from diffusiontexturepainting_torch.ops import attention_variants

    (B, Lq, D), (_, Lk, _), heads, bk, bf16_p = shape_key
    return attention_variants.chunked_sm90_plan(
        D // heads, Lq, B * heads, Lk, bk, bf16_p)["online"]


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
        # K11 with a weight whose Cout is off 8 zero-padded (bf16 K11
        # refuses it), the padded channels dropped
        wk, zero = gn_conv.pad_cout(
            w33, torch.zeros(n, dtype=dtype, device="cuda"))
        return (lambda: conv_variants.conv_window_taps(xwin, w, read, W=W,
                                                       reps=reps),
                lambda: conv_variants.plain_conv_window_taps(
                    xwin, w, read, W=W, reps=reps),
                (lambda: F.conv2d(xc, wc)) if is_conv else None,
                (lambda: conv3x3.conv3x3_stream(image, wk, zero)[..., :n])
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
        # the family: T2 safe for the in-place arms; else K8 or K2 (one
        # launch, the same bits) as attention() routes the call, K2 where
        # it routes it to the plain matmuls
        route = attention.attention_route(q_shape[1], k_shape[1],
                                          q_shape[2] // heads, dtype)
        base = (attention.flash_attention_streaming if route == "streaming"
                else attention.flash_attention)
        if kind in IN_PLACE_ARMS:
            base = functools.partial(attention_variants.nomax_attention,
                                     safe=True)
        return (lambda: wrapper(q, k, v, heads, **options),
                lambda: plain(q, k, v, heads, **options),
                sdpa(q, k, v, heads),
                lambda: base(q, k, v, heads))
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
    (None where no PyTorch call computes the function) and, for the
    kernels with a family member, family_ms (FAMILY_IS) when `timed`; for
    FAMILY_EXACT in bf16, family_max_abs_diff (0, or it raises)."""
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
    if family_exact(kind, shape_key) and dtype == torch.bfloat16:
        d = (got.float() - family().float()).abs().max().item()
        if d != 0.0:
            raise AssertionError(f"{name}: differs from its family member "
                                 f"({FAMILY_IS[kind]}) by {d:.3e}")
        out["family_max_abs_diff"] = d
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
                              ("composition", composition),
                              ("family", family)):
                if fn is not None:
                    out[f"{field}_device_ms"] = graph_ms(fn, calls=10,
                                                         tries=3)
    return out


def unet_eval_launches(ucfg, lat, dtype, kind="full"):
    """Launches of each kernel in one UNet eval (the CFG batch of 3) of
    configuration `ucfg` in `dtype` at latent size `lat`: kind "full" (the
    whole UNet: forward, forward_full) or "shallow" (forward_shallow: the
    outermost down level's resnets and transformers, the outermost up
    level's and the head, against the cache). Self-attention goes to K2,
    K8 or K13 by the routing rules; cross-attention (14 tokens) is plain."""
    from diffusiontexturepainting_torch.ops.attention import (
        attention_route,
        slotted_self_attention_fits,
    )

    n_u, L = len(ucfg.block_out_channels), ucfg.layers_per_block
    fused = ucfg.fused_resnet
    out = Counter()
    if kind == "full":
        plain, skip = n_u * L + 2, n_u * (L + 1)  # down path and mid; up
        # (level, self-attentions there): each level's transformers, the
        # mid block's at the deepest level
        sites = [(i, 2 * L + 1) for i in range(n_u) if ucfg.attn_down[i]]
        sites.append((n_u - 1, 1))
        out["upsample2x_conv3x3"] = n_u - 1
    else:
        plain, skip = L, L + 1
        sites = [(0, 2 * L + 1)] if ucfg.attn_down[0] else []
    transformers = sum(calls for _, calls in sites)
    out["conv3x3"] = 0 if fused else 2 * (plain + skip)
    # an up-path resnet's un-concatenated input: three K1 calls, two
    # statistics passes
    out["gn_conv_resident"] = 2 * plain + 3 * skip if fused else 0
    out["ff_geglu"] = transformers if ucfg.fused_ff else 0
    # statistics passes: each fused resnet's input parts, or, where the
    # transformers fold their GroupNorm without a resnet's statistics,
    # each transformer's input
    out["spatial_moments"] = (plain + 2 * skip if fused else transformers
                              if ucfg.fused_norm else 0)
    kernel = {"flash": "flash_attention",
              "streaming": "flash_attention_streaming", "plain": None}
    for level, calls in sites:
        length = (lat >> level) ** 2
        hd = ucfg.block_out_channels[level] // ucfg.num_attention_heads
        if ucfg.fused_attn and slotted_self_attention_fits(length, length,
                                                           hd):
            out["flash_attention_slotted"] += calls
            continue
        name = kernel[attention_route(length, length, hd, dtype)]
        if name:
            out[name] += calls
    return out


def vae_launches(config, vcfg, lat, part, dtype):
    """Launches of each kernel in one VAE encode (`part` "encoder", batch
    2) or decode ("decoder") of a stamp at latent size `lat`, with the
    configuration's legs, in `dtype`."""
    from diffusiontexturepainting_torch.ops.attention import attention_route

    n_v, Lv = len(vcfg.block_out_channels), vcfg.layers_per_block
    out = Counter()
    if part == "encoder":
        resnets, fused = n_v * Lv + 2, config.fused_vae_encoder
        if fused:
            out["downsample_conv3x3_stats"] = n_v - 1
    else:
        resnets, fused = n_v * (Lv + 1) + 2, config.fused_vae_decoder
        out["upconv_stream" if fused else "upsample2x_conv3x3"] = n_v - 1
    if fused:  # the stem or conv_in, then two GN-convs a resnet
        out["gn_conv_stream"] = 2 * resnets + 1
        out["spatial_moments"] = 2  # the stem and the mid block
    else:
        out["conv3x3"] = 2 * resnets
    # the mid block's attention, one head at the latent size
    route = attention_route(lat * lat, lat * lat, vcfg.block_out_channels[-1],
                            dtype)
    if route != "plain":
        out["flash_attention" if route == "flash"
            else "flash_attention_streaming"] += 1
    return out


def _dtype_name(module):
    return str(next(module.parameters()).dtype).removeprefix("torch.")


def expected_launches(model, res, steps):
    """{(kernel, dtype name): launches} of one stamp of `model` at `res`
    and `steps`, from its configuration and the schedule of its stamp
    function (stamp.schedule: the scheduler's model calls, PNDM steps + 1,
    each exact or full, shallow, or the f32 final step's eval on
    final_unet), plus the VAE encode and decode in their dtypes."""
    import torch

    lat = res // 8
    u_dt = next(model.unet.parameters()).dtype
    parts = []
    for kind in model._stamp_fn(steps).schedule:
        if kind == "final":
            parts.append((unet_eval_launches(model.final_unet.cfg, lat,
                                             torch.float32), "float32"))
        else:
            parts.append((unet_eval_launches(
                model.unet.cfg, lat, u_dt,
                "shallow" if kind == "shallow" else "full"),
                str(u_dt).removeprefix("torch.")))
    for part in ("encoder", "decoder"):
        vae = getattr(model, f"vae_{part}")
        parts.append((vae_launches(model.config, vae.cfg, lat, part,
                                   next(vae.parameters()).dtype),
                      _dtype_name(vae)))
    out = Counter()
    for counts, dt in parts:
        for name, n in counts.items():
            out[name, dt] += n
    return out


def attention_launches(model, res, steps):
    """Launches of K2, K8 and K13 in one stamp of `model` at `res` whose
    UNet runs `steps` full evals, all in model.dtype: the UNet's
    self-attentions per eval and level, and the VAE's two mid-block
    attentions (encoder and decoder, at the latent size)."""
    lat = res // 8
    out = Counter()
    counts = [(unet_eval_launches(model.unet.cfg, lat, model.dtype), steps)]
    counts += [(vae_launches(model.config, model.vae_encoder.cfg, lat, part,
                             model.dtype), 1)
               for part in ("encoder", "decoder")]
    for c, times in counts:
        for name, n in c.items():
            if name.startswith("flash") and n:
                out[name] += n * times
    return out


def expected_per_stamp(model, res, steps, in_pad=False, dtype=None):
    """Launches of each kernel in one stamp of `model` (expected_launches),
    of every dtype or of `dtype` ("float32": the FMA twins) alone; `in_pad`:
    under the _IN_PAD switch, K12a/b take K7's and K4's calls."""
    out = {name: 0 for name in SOURCES}
    for (name, dt), n in expected_launches(model, res, steps).items():
        if dtype is None or dt == dtype:
            out[name] += n
    if in_pad:
        out["conv3x3_inpad"] += out.pop("conv3x3")
        out["upsample2x_conv3x3_inpad"] += out.pop("upsample2x_conv3x3")
        out["conv3x3"] = out["upsample2x_conv3x3"] = 0
    return out


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
                 in_pad=False, dtypes=None):
    """Each kernel's launches in `n_stamps` stamps against
    expected_per_stamp; with `dtypes` ({kernel: {dtype name: launches}}),
    the fp32 launches (the FMA twins) against its fp32 part too."""
    want = {k: n_stamps * v for k, v in
            expected_per_stamp(model, res, steps, in_pad).items()}
    want32 = {k: n_stamps * v for k, v in
              expected_per_stamp(model, res, steps, in_pad,
                                 "float32").items()}
    for name in want:
        got32 = None if dtypes is None else dtypes[name].get("float32", 0)
        log(f"{label} counts: {name}: {launches[name]} launches in "
            f"{n_stamps} stamps, expected {want[name]} "
            f"({want[name] // n_stamps} per stamp)"
            + ("" if got32 is None else
               f"; fp32 {got32}, expected {want32[name]}"))
        if launches[name] != want[name]:
            raise AssertionError(f"{label}: {name}: {launches[name]} "
                                 f"launches, expected {want[name]}")
        if got32 is not None and got32 != want32[name]:
            raise AssertionError(f"{label}: {name}: {got32} fp32 launches, "
                                 f"expected {want32[name]}")


def launch_dtypes():
    """{kernel: {dtype name: launches}} since the counters' last reset."""
    return {c.name: dict(c.dtypes) for c in counters()}


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


def compare_stamps(label, ours, theirs, what, exact=False,
                   bound=MAX_MEAN_DIFF):
    """The two first stamps within `bound` u8 levels on average (None: no
    bound, a distance printed), or byte-equal where `exact`."""
    diff = abs(ours.astype(int) - theirs.astype(int))
    log(f"{label}: first stamps of {what}: mean |diff| {diff.mean():.3f} u8 "
        f"levels, max {diff.max()}, {(diff == 0).mean():.4f} exact, "
        f"{(diff <= 4).mean():.4f} within 4, {(diff <= 16).mean():.4f} "
        "within 16")
    if exact and diff.max() != 0:
        raise AssertionError(f"{label}: {what} are not byte-equal")
    if bound is not None and not diff.mean() <= bound:
        raise AssertionError(f"{label}: {what} differ by {diff.mean():.3f} "
                             "levels on average")
    return diff


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


SCHEDULERS = ("DPM++", "EulerA", "LMS", "PNDM")


def scheduler_phase(weights):
    """For each of SCHEDULERS, the default configuration and its safe twin
    with that scheduler, built from `weights`: one 256^2 / STEPS NEW_STAMP
    of each at request counter 2 through the request handler, the
    default's launches checked at the scheduler's model calls; EulerA's
    stamp again at the same counter, byte-equal. Returns {name: wall s}."""
    import dataclasses

    import torch

    from diffusiontexturepainting_torch.core.config import (
        PipelineConfig,
        safe_twin_config,
    )
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    from diffusiontexturepainting_torch.serving import wire

    R, handle = wire.RequestType, wire.handle_request_bytes
    brush, canvas = requests()
    req = wire.encode_request(R.NEW_STAMP, canvas, **settings(STEPS))
    walls = {}
    for name in SCHEDULERS:
        config = dataclasses.replace(PipelineConfig(), scheduler=name)
        model = TorchConditionalInpainter(RES, config=config, device="cuda",
                                          weights=weights)
        model.set_brush(brush)
        sched = model._stamp_fn(STEPS).scheduler
        torch.cuda.synchronize()
        for c in counters():
            c.reset()
        model.request_counter = 1
        tic = time.perf_counter()
        reply = handle(model, req)
        walls[name] = time.perf_counter() - tic
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in counters()}
        stamp = check_reply(reply, R.RETURN_STAMP, RES, canvas)
        log(f"schedulers: {name}: {sched.num_iterations()} model calls, "
            f"NEW_STAMP {walls[name] * 1e3:.1f} ms wall ({RES}^2, {STEPS} "
            f"steps, {model.dtype}; {CARD[0]})")
        check_counts(f"schedulers {name}", model, STEPS, launches, 1)
        if sched.stochastic:
            model.request_counter = 1
            if handle(model, req) != reply:
                raise AssertionError(f"schedulers: {name}: the same request "
                                     "counter gave other bytes")
            log(f"schedulers: {name}: the stamp again at the same request "
                "counter (its step noise drawn again): byte-equal")
        del model
        twin = TorchConditionalInpainter(RES, config=safe_twin_config(config),
                                         device="cuda", weights=weights)
        twin.set_brush(brush)
        twin.request_counter = 1
        twin_stamp = check_reply(handle(twin, req), R.RETURN_STAMP, RES,
                                 canvas)
        compare_stamps(f"schedulers {name}", stamp, twin_stamp,
                       f"the default and the safe twin with {name} at "
                       f"{STEPS} steps")
        del twin
        release()
    return walls


def checkpoint_phase(model):
    """`model` saved in the JAX package's format; a model built from the
    checkpoint and one seeded otherwise reloaded from it, each against
    `model`: state_dicts bit for bit, NEW_STAMP bytes at one counter."""
    import os
    import shutil
    import tempfile

    import torch

    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.weights.loader import (
        save_pipeline_params)

    R, handle = wire.RequestType, wire.handle_request_bytes
    brush, canvas = requests()
    req = wire.encode_request(R.NEW_STAMP, canvas, **settings(FEW_STEPS))

    def first_reply(m):
        m.set_brush(brush)
        m.request_counter = 1
        return handle(m, req)

    want = first_reply(model)
    directory = tempfile.mkdtemp(prefix="dtp_checkpoint_")
    try:
        tic = time.perf_counter()
        nbytes = save_pipeline_params(directory, model.state_dicts())
        save_s = time.perf_counter() - tic
        on_disk = sum(os.path.getsize(os.path.join(directory, f))
                      for f in os.listdir(directory))
        log(f"checkpoint: saved {nbytes} bytes of float32 arrays "
            f"({on_disk} on disk, {len(os.listdir(directory))} npz) in "
            f"{save_s:.1f} s")
        loaded = TorchConditionalInpainter(RES, device="cuda",
                                           checkpoint_dir=directory)
        log(f"checkpoint: a model built from it in "
            f"{loaded.init_seconds:.1f} s")
        ours, theirs = model.state_dicts(), loaded.state_dicts()
        for name, sd in ours.items():
            for k, v in sd.items():
                if not torch.equal(theirs[name][k], v):
                    raise AssertionError(f"checkpoint: {name}.{k} differs "
                                         "after the bf16 -> fp32 -> bf16 "
                                         "round trip")
        if first_reply(loaded) != want:
            raise AssertionError("checkpoint: the loaded model's stamp "
                                 "differs")
        del loaded
        log(f"checkpoint: every state_dict entry bit for bit; NEW_STAMP "
            f"({RES}^2, {FEW_STEPS} steps) byte-equal at the same request "
            "counter")
        other = TorchConditionalInpainter(RES, device="cuda",
                                          weights_seed=1)
        if first_reply(other) == want:
            raise AssertionError("checkpoint: a model seeded otherwise "
                                 "gave the same stamp")
        # the stamp above captured its program on the seed-1 weights
        fn = other._stamp_fn(FEW_STEPS)
        prog = other.engine.programs[fn.program_key(RES, 1)]
        replays = prog.replays
        tic = time.perf_counter()
        other.reload_params(directory)
        reload_s = time.perf_counter() - tic
        if first_reply(other) != want:
            raise AssertionError("checkpoint: reload_params gave another "
                                 "stamp")
        log(f"checkpoint: reload_params into a model seeded otherwise in "
            f"{reload_s:.1f} s; its NEW_STAMP byte-equal ({CARD[0]})")
        if (other.engine.programs[fn.program_key(RES, 1)] is not prog
                or prog.replays != replays + 1):
            raise AssertionError("engine: the stamp after reload_params was "
                                 "not a replay of the program captured "
                                 "before it")
        args = engine_stamp_args(other, RES, FEW_STEPS, 5, ENGINE_REQUESTS[1])
        graph_against_eager("reload", fn(*args), fn.eager(*args))
        log("engine: reload_params kept the program captured on the old "
            "weights; its replay byte-equal to the model built from the "
            "checkpoint and to the eager stamp of the reloaded weights")
        del other
        release()
        cli_phase(directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    release()
    return dict(bytes=nbytes, save_s=save_s, reload_s=reload_s)


# --- the reference's released artifacts, written from the port's
# state_dicts: the convert phase's inputs (tests/test_torch_port_convert.py
# builds its files with the same functions) ---

CONVERT_LORA_RANK = 4
CONVERT_LORA_SCALE = 0.75
CONVERT_MAX_S = 120.0  # the convert phase's time, files and models included
# the text tower in bf16 on the card against its fp32 evaluation on the CPU
# (the last hidden state, LayerNorm'd: about unit scale)
TEXT_MAX_ERR = 0.25
TEXT_MEAN_ERR = 0.03
VAE_OLD_ATTENTION = (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                     ("to_out.0", "proj_attn"))


def torch_layout(sd):
    """A port state_dict in torch's layouts, fp32 on the CPU: conv weights
    (kH, kW, Cin, Cout) -> (Cout, Cin, kH, kW)."""
    return {k: (v.permute(3, 2, 0, 1) if v.dim() == 4 else v).float().cpu()
            .contiguous() for k, v in sd.items()}


def autoencoder_kl(encoder_sd, decoder_sd, old_attention=False):
    """The VAE's halves as one diffusers AutoencoderKL state_dict;
    `old_attention`: the mid-block attentions under the older names
    (query, key, value, proj_attn)."""
    sd = {**torch_layout(encoder_sd), **torch_layout(decoder_sd)}
    if old_attention:
        for k in list(sd):
            for new, old in VAE_OLD_ATTENTION:
                part = f".attentions.0.{new}."
                if part in k:
                    sd[k.replace(part, f".attentions.0.{old}.")] = sd.pop(k)
    return sd


def openai_visual(tower, prefix="clip.visual"):
    """The port's CLIP tower (vision_model.*, torch layouts) under OpenAI
    CLIP's visual names, q, k and v as one in_proj."""
    import torch

    v = "vision_model."
    out = {f"{prefix}.class_embedding": tower[v + "embeddings.class_embedding"],
           f"{prefix}.positional_embedding":
               tower[v + "embeddings.position_embedding.weight"],
           f"{prefix}.conv1.weight":
               tower[v + "embeddings.patch_embedding.weight"]}
    layers = {int(k.split(".")[3]) for k in tower
              if k.startswith(v + "encoder.layers.")}
    for part in ("weight", "bias"):
        out[f"{prefix}.ln_pre.{part}"] = tower[f"{v}pre_layrnorm.{part}"]
        out[f"{prefix}.ln_post.{part}"] = tower[f"{v}post_layernorm.{part}"]
        for i in sorted(layers):
            src = f"{v}encoder.layers.{i}."
            dst = f"{prefix}.transformer.resblocks.{i}."
            out[f"{dst}attn.in_proj_{part}"] = torch.cat(
                [tower[f"{src}self_attn.{p}.{part}"]
                 for p in ("q_proj", "k_proj", "v_proj")])
            for a, b in (("self_attn.out_proj", "attn.out_proj"),
                         ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
                out[f"{dst}{b}.{part}"] = tower[f"{src}{a}.{part}"]
    return out


def image_encoder_file(patch_sd, clip="openai"):
    """image_encoder.pth's state_dict from the port's patch encoder, its CLIP
    tower in OpenAI naming (with keys the converter does not read: the
    visual projection and logit_scale), in Hugging Face naming ("hf": the
    pre-LayerNorm as pre_layrnorm, "hf_layernorm": as pre_layernorm), or
    left out (None)."""
    import torch

    sd = torch_layout(patch_sd)
    tower = {k[len("clip."):]: sd.pop(k) for k in list(sd)
             if k.startswith("clip.")}
    if clip == "openai":
        sd.update(openai_visual(tower))
        hidden = tower["vision_model.post_layernorm.weight"].shape[0]
        sd["clip.visual.proj"] = torch.full((hidden, 8), 0.5)
        sd["clip.logit_scale"] = torch.tensor(4.6052)
    elif clip in ("hf", "hf_layernorm"):
        for k, t in tower.items():
            if clip == "hf_layernorm":
                k = k.replace("pre_layrnorm", "pre_layernorm")
            sd["clip." + k] = t
    elif clip is not None:
        raise ValueError(clip)
    return sd


def lora_attn_procs(unet_sd, rank, seed):
    """A seeded diffusers attn-procs LoRA over every attention projection of
    the UNet (attn1 and attn2; to_q, to_k, to_v, to_out): down (rank, in)
    ~ N(0, 1) / rank, up (out, rank) ~ N(0, 0.02^2)."""
    import re

    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, w in unet_sd.items():
        m = re.match(r"(.*\.attn[12])\.(to_[qkv]|to_out)(\.0)?\.weight$", k)
        if m is None:
            continue
        pre = f"{m.group(1)}.processor.{m.group(2)}_lora."
        out[pre + "down.weight"] = torch.randn(
            (rank, w.shape[1]), generator=gen) / rank
        out[pre + "up.weight"] = torch.randn((w.shape[0], rank),
                                             generator=gen) * 0.02
    return out


def text_encoder_file(text_sd):
    """A Hugging Face CLIPTextModel state_dict from the port's text tower,
    with the position_ids buffer older transformers versions save (the
    converter does not read it)."""
    import torch

    sd = torch_layout(text_sd)
    n = sd["text_model.embeddings.position_embedding.weight"].shape[0]
    sd["text_model.embeddings.position_ids"] = torch.arange(n)[None]
    return sd


def write_safetensors(path, sd, dtype):
    """`sd` as a .safetensors file of F16 or F32 tensors: an 8-byte
    little-endian header length, the JSON header, the little-endian data."""
    import struct

    import torch

    kind, le = {torch.float16: ("F16", "<f2"),
                torch.float32: ("F32", "<f4")}[dtype]
    header, blobs, offset = {}, [], 0
    for k, v in sd.items():
        b = v.to(dtype).contiguous().numpy().astype(le).tobytes()
        header[k] = {"dtype": kind, "shape": list(v.shape),
                     "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def text_ids(rng, cfg, n=2):
    """(n, max_length) seeded token ids: BOS, random tokens, EOS padding."""
    ids = rng.integers(0, cfg.vocab_size - 2, (n, cfg.max_length))
    ids[:, 0] = cfg.bos_token_id
    ids[:, 20:] = cfg.eos_token_id
    return ids


def convert_phase(model):
    """The reference's artifacts written from `model`'s weights (a .bin UNet,
    an F16 .safetensors VAE in the old attention names, a rank-4 attn-procs
    LoRA, image_encoder.pth with an OpenAI-named CLIP tower, a seeded
    CLIPTextModel-named text tower in fp16), converted by `python -m
    diffusiontexturepainting_torch.weights.convert` in a process of its own;
    a model seeded otherwise reload_params from the result: every
    state_dict entry bit for bit the written weights after their float32 /
    F16 round trip with the LoRA merged (numpy, fp32, as the converter
    computes it), a NEW_STAMP byte-equal to a model given those weights
    directly, the default path's launches; the text tower from
    load_text_encoder on the card in bf16 against the CPU in fp32."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diffusiontexturepainting_torch.core.config import (
        COMPONENTS,
        CLIPTextConfig,
    )
    from diffusiontexturepainting_torch.models.clip_text import (
        CLIPTextEncoder,
        encode_prompt,
    )
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.weights.loader import (
        load_text_encoder)
    from diffusiontexturepainting_torch.weights.random_init import (
        random_state_dict)

    phase_tic = time.perf_counter()
    R, handle = wire.RequestType, wire.handle_request_bytes
    brush, canvas = requests()
    req = wire.encode_request(R.NEW_STAMP, canvas, **settings(FEW_STEPS))
    root = tempfile.mkdtemp(prefix="dtp_convert_")
    src, out = os.path.join(root, "reference"), os.path.join(root, "ckpt")
    os.makedirs(src)
    try:
        sds = model.state_dicts()
        tcfg = CLIPTextConfig()
        text = CLIPTextEncoder(tcfg).eval()
        text_sd = random_state_dict(text, torch.Generator().manual_seed(5))
        lora = lora_attn_procs(sds["unet"], CONVERT_LORA_RANK, seed=0)
        files = {"unet": "unet.bin", "vae": "vae.safetensors",
                 "lora": "pytorch_lora_weights.bin",
                 "image-encoder": "image_encoder.pth",
                 "text-encoder": "text_encoder.bin"}
        paths = {k: os.path.join(src, f) for k, f in files.items()}
        tic = time.perf_counter()
        torch.save(torch_layout(sds["unet"]), paths["unet"])
        torch.save(lora, paths["lora"])
        write_safetensors(paths["vae"], autoencoder_kl(
            sds["vae_encoder"], sds["vae_decoder"], old_attention=True),
            torch.float16)
        torch.save(image_encoder_file(sds["patch_encoder"], "openai"),
                   paths["image-encoder"])
        torch.save({k: v.half() if v.is_floating_point() else v
                    for k, v in text_encoder_file(text_sd).items()},
                   paths["text-encoder"])
        log(f"convert: wrote the reference's artifacts in "
            f"{time.perf_counter() - tic:.1f} s: " + ", ".join(
                f"{f} {os.path.getsize(paths[k])} bytes"
                for k, f in files.items()))

        # what the files hold, as the converter reads them back (float32),
        # the LoRA merged in fp32 numpy
        f16 = lambda sd: {k: v.float().half().float().cpu()
                          for k, v in sd.items()}
        want = {"unet": {k: v.float().cpu() for k, v in sds["unet"].items()},
                "vae_encoder": f16(sds["vae_encoder"]),
                "vae_decoder": f16(sds["vae_decoder"]),
                "patch_encoder": {k: v.float().cpu()
                                  for k, v in sds["patch_encoder"].items()}}
        for k in [k for k in lora if k.endswith(".down.weight")]:
            block, target = k[:-len(".down.weight")].split(".processor.")
            name = f"{block}.{target[:-len('_lora')]}"
            name += ".0.weight" if name.endswith("to_out") else ".weight"
            up = lora[k.replace(".down.", ".up.")].numpy()
            delta = (up @ lora[k].numpy()).astype(np.float32)
            want["unet"][name] = torch.from_numpy(
                want["unet"][name].numpy() + CONVERT_LORA_SCALE * delta)
        want_text = f16(text_sd)

        cmd = [sys.executable, "-m",
               "diffusiontexturepainting_torch.weights.convert",
               "--unet", paths["unet"], "--vae", paths["vae"],
               "--lora", paths["lora"], "--lora-scale",
               str(CONVERT_LORA_SCALE), "--image-encoder",
               paths["image-encoder"], "--text-encoder",
               paths["text-encoder"], "--out", out]
        tic = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        convert_s = time.perf_counter() - tic
        if proc.returncode != 0:
            raise AssertionError(f"convert: the converter exited with "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            log(f"convert: {line}")
        log(f"convert: the converter process took {convert_s:.1f} s "
            f"({CARD[0]})")
        missing = [n for n in COMPONENTS + ("text_encoder",)
                   if not os.path.exists(os.path.join(out, f"{n}.npz"))]
        if missing:
            raise AssertionError(f"convert: no {missing} in {out}")
        shutil.rmtree(src)

        served = TorchConditionalInpainter(RES, device="cuda",
                                           weights_seed=2)
        tic = time.perf_counter()
        served.reload_params(out)
        reload_s = time.perf_counter() - tic
        got = served.state_dicts()
        for name in COMPONENTS:
            if set(got[name]) != set(want[name]):
                raise AssertionError(f"convert: {name}'s names differ")
            for k, v in got[name].items():
                if not torch.equal(v.cpu(), want[name][k].to(v.dtype)):
                    raise AssertionError(f"convert: {name}.{k} is not the "
                                         "written weight")
        log(f"convert: reload_params in {reload_s:.1f} s; every state_dict "
            "entry bit for bit the written weights (float32 / F16 round "
            f"trip, LoRA rank {CONVERT_LORA_RANK} x {CONVERT_LORA_SCALE} "
            f"merged into {len(lora) // 2} projections)")
        direct = TorchConditionalInpainter(RES, device="cuda", weights=want)

        def first_reply(m, count=False):
            m.set_brush(brush)
            m.request_counter = 1
            torch.cuda.synchronize()
            for c in counters():
                c.reset()
            reply = handle(m, req)
            torch.cuda.synchronize()
            return reply, {c.name: c.launches for c in counters()}

        reply, launches = first_reply(served)
        check_reply(reply, R.RETURN_STAMP, RES, canvas)
        check_counts("convert", served, FEW_STEPS, launches, 1)
        if first_reply(direct)[0] != reply:
            raise AssertionError("convert: the converted model's NEW_STAMP "
                                 "differs from the directly loaded one's")
        if first_reply(model)[0] == reply:
            raise AssertionError("convert: the merged LoRA left the stamp "
                                 "as the base model's")
        log(f"convert: NEW_STAMP ({RES}^2, {FEW_STEPS} steps) byte-equal to "
            "a model given the expected weights directly; not the base "
            "model's (the LoRA merged)")
        del served, direct, got
        release()

        sd = load_text_encoder(out, module=text)
        for k, v in sd.items():
            if not torch.equal(v, want_text[k]):
                raise AssertionError(f"convert: text_encoder {k} is not the "
                                     "written weight")
        text.load_state_dict(sd)
        card = CLIPTextEncoder(tcfg).to("cuda", torch.bfloat16).eval()
        card.load_state_dict(sd)
        rng = np.random.default_rng(0)
        prompt, negative = text_ids(rng, tcfg), text_ids(rng, tcfg, 1)
        tic = time.perf_counter()
        emb = encode_prompt(card, prompt, negative)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - tic) * 1e3
        ref = encode_prompt(text, prompt, negative, dtype=torch.float32)
        err = (emb.float().cpu() - ref).abs()
        log(f"convert: text tower (load_text_encoder, every entry bit for "
            f"bit): encode_prompt {tuple(emb.shape)} {emb.dtype} on the card "
            f"in {card_ms:.1f} ms against fp32 on the CPU: max |err| "
            f"{err.max():.4f} (tol {TEXT_MAX_ERR}), mean {err.mean():.5f} "
            f"(tol {TEXT_MEAN_ERR})")
        if not (torch.isfinite(emb).all() and err.max() <= TEXT_MAX_ERR
                and err.mean() <= TEXT_MEAN_ERR):
            raise AssertionError("convert: the text tower on the card is "
                                 "off its CPU evaluation")
        del card
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    phase_s = time.perf_counter() - phase_tic
    log(f"convert: phase done in {phase_s:.1f} s (limit {CONVERT_MAX_S:.0f} "
        f"s; {CARD[0]})")
    if phase_s > CONVERT_MAX_S:
        raise AssertionError(f"convert: the phase took {phase_s:.1f} s")
    return dict(convert_s=convert_s, reload_s=reload_s, phase_s=phase_s)


# The client phase: the painting client (client/) on the card at the size
# users paint: a UV sphere of CLIENT_SPHERE (longitudes, latitude bands),
# 65,024 faces, painted into a CLIENT_TEX^2 texture with a brush of
# half-width CLIENT_RADIUS (the sphere's radius 1); the rasterizer's three
# brush positions (hit = normal), the first across the UV seam (longitude
# 0, the +x side)
CLIENT_SPHERE = (256, 128)
CLIENT_TEX = 1024
CLIENT_RADIUS = 0.25
CLIENT_POSITIONS = ((1.0, 0.0, 0.0), (0.3, 0.5, 0.81), (-0.6, -0.2, -0.77))
# the stroke: CLIENT_STAMPS stamps along the equator from longitude
# CLIENT_START (radians), each move a chord of CLIENT_STEP_OVER radii (one
# stamp a move)
CLIENT_STAMPS, CLIENT_START, CLIENT_STEP_OVER = 6, -0.6, 1.02
# the canvas stroke: a session canvas (H, W) with a painted band, 8
# STAMP_ATs at two a radius along a row
CLIENT_CANVAS = (384, 768)
CLIENT_BAND = 96
CLIENT_CANVAS_STAMPS = 8
# csrc/raster.cu's operations a covered pixel (centre, three edge
# functions, three divisions, z), for the operations side of its bound
RASTER_OPS_A_PIXEL = 31


def client_sphere(directory):
    """The UV sphere written with the port's save_obj and read back with
    load_obj."""
    import os

    from diffusiontexturepainting_torch.client import mesh_io

    path = os.path.join(directory, "sphere.obj")
    mesh_io.save_obj(path, mesh_io.make_uv_sphere(*CLIENT_SPHERE))
    mesh = mesh_io.load_obj(path)
    want = 2 * CLIENT_SPHERE[0] * (CLIENT_SPHERE[1] - 1)
    if mesh.faces.shape != (want, 3):
        raise AssertionError(f"client: the sphere has {mesh.faces.shape} "
                             f"faces, expected {want}")
    return mesh, os.path.getsize(path)


def raster_bound(args, face_idx):
    """(seconds, by) of one rasterize call, from what this call's data
    needs: the mask (F bytes); the xy corners of every face the mask keeps
    (a face must be read to learn that it is degenerate); the z corners of
    the kept faces that are finite and not degenerate; the features of the
    faces that own a pixel; each output written once (H x W x (C + 1)
    4-byte values). The kernel's 64-bit keys are its own scratch and not
    counted. Against RASTER_OPS_A_PIXEL fp32 operations a covered pixel."""
    import torch

    from diffusiontexturepainting_torch.ops import raster

    height, width, feats, _, fvi, valid = args
    F, _, C = feats.shape
    mask = (torch.ones(F, dtype=torch.bool, device=fvi.device)
            if valid is None else valid.to(torch.bool))
    live = mask & (raster.face_areas(fvi).abs() >= raster.MIN_AREA) \
        & torch.isfinite(fvi).flatten(1).all(dim=1)
    owners = torch.unique(face_idx[face_idx >= 0]).numel()
    bytes_ = ((F if valid is not None else 0) + int(mask.sum()) * 3 * 2 * 4
              + int(live.sum()) * 3 * 4 + owners * 3 * C * 4
              + height * width * (C + 1) * 4)
    ops = RASTER_OPS_A_PIXEL * int((face_idx >= 0).sum())
    t_bytes, t_ops = bytes_ / PEAK_BYTES, ops / PEAK_FLOPS["float32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def captured_rasterize(fn):
    """fn() with client/render.py's rasterize calls recorded: returns
    (fn's result, [the calls' arguments])."""
    from diffusiontexturepainting_torch.client import render

    calls, inner = [], render.rasterize

    def recording(*args):
        calls.append(args)
        return inner(*args)

    render.rasterize = recording
    try:
        return fn(), calls
    finally:
        render.rasterize = inner


def raster_against_plain(painter):
    """The kernel against rasterize_plain on the arguments the painter's
    stamp render and back-projection give it at CLIENT_POSITIONS: face_idx
    and the features byte-equal; each one's CUDA-event ms, and the bound.
    Returns a dict of the per-stamp means and the worst differences."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.client import render
    from diffusiontexturepainting_torch.ops import raster

    sums = Counter()
    for k, p in enumerate(CLIENT_POSITIONS):
        hit = np.asarray(p, np.float32) / np.linalg.norm(p)
        cam = painter.make_camera(hit, hit, None, CLIENT_RADIUS)

        def stamp_geometry():
            res = render.render_view(cam, painter.mesh,
                                     texture=painter.texture)
            stamp = torch.ones(res["face_idx"].shape + (4,), device="cuda")
            return render.backproject_texture(painter.mesh, res["proj_mesh"],
                                              res["face_idx"], stamp,
                                              painter.texture_width)

        _, calls = captured_rasterize(stamp_geometry)
        if len(calls) != 2:
            raise AssertionError(f"client: {len(calls)} rasterize calls at "
                                 f"position {k}, expected 2")
        for what, args in zip(("view", "backprojection"), calls):
            out, idx = raster.rasterize(*args)
            pout, pidx = raster.rasterize_plain(*args)
            torch.cuda.synchronize()
            mismatch = int((idx != pidx).sum())
            err = (out - pout).abs().max().item()
            bits = torch.equal(out.view(torch.int32), pout.view(torch.int32))
            log(f"client: rasterize {what} at position {k} "
                f"({args[0]}x{args[1]}, {args[2].shape[0]} faces, "
                f"{int(args[5].sum())} valid, {int((idx >= 0).sum())} "
                f"pixels covered): face_idx mismatches {mismatch}, features "
                f"max|kernel - plain| {err:.3e}, bit-equal {bits}")
            if mismatch or not bits:
                raise AssertionError(f"client: the rasterize kernel differs "
                                     f"from rasterize_plain ({what}, "
                                     f"position {k}): {mismatch} face_idx, "
                                     f"features {err:.3e}")
            ms = cuda_ms(lambda: raster.rasterize(*args))
            pms = cuda_ms(lambda: raster.rasterize_plain(*args), max_iters=3)
            b_s, by = raster_bound(args, idx)
            log(f"client: rasterize {what} at position {k}: {ms:.4f} ms "
                f"kernel, {pms:.4f} ms plain, bound {b_s * 1e3:.4f} ms "
                f"({by}) ({CARD[0]})")
            sums[f"{what}_ms"] += ms / len(CLIENT_POSITIONS)
            sums[f"{what}_plain_ms"] += pms / len(CLIENT_POSITIONS)
            sums[f"{what}_bound_ms"] += b_s * 1e3 / len(CLIENT_POSITIONS)
            sums[f"by_{by}"] += b_s
            sums["max_abs_err"] = max(sums["max_abs_err"], err)
    return sums


def check_update(painter, before, update, mode):
    """One stamp's texture update: texels painted (alpha > 0), every other
    texel byte-equal to `before`; Erase leaves zeros, the others the update
    clipped to 1."""
    import torch

    mask = update[..., 3:4] > 0
    painted = int(mask.sum())
    if not painted:
        raise AssertionError(f"client: a {mode} stamp painted no texel")
    keep = ~mask.expand_as(before)
    if not torch.equal(painter.texture[keep], before[keep]):
        raise AssertionError(f"client: a {mode} stamp changed texels "
                             "outside its update")
    want = (torch.zeros_like(before) if mode == "ERASE"
            else update.clamp(max=1.0))
    inside = mask.expand_as(before)
    if not torch.equal(painter.texture[inside], want[inside]):
        raise AssertionError(f"client: a {mode} stamp's texels are not its "
                             "update")
    return painted


def client_stroke(painter):
    """CLIENT_STAMPS stamps of a BrushStroke along the equator, one
    Overpaint stamp and one Erase stamp on it, then an undo; each update
    checked (check_update). Returns the stamps' count."""
    import math

    import numpy as np
    import torch

    from diffusiontexturepainting_torch.client.brush import BrushStroke
    from diffusiontexturepainting_torch.client.painter import BrushMode

    modes = []
    inner = painter.stamp

    def checked(hit, normal, prev_point=None, radius=None):
        before = painter.texture.clone()
        update = inner(hit, normal, prev_point=prev_point, radius=radius)
        modes.append(painter.mode.name)
        n = check_update(painter, before, update, painter.mode.name)
        log(f"client: stamp {len(modes)} ({painter.mode.name}): {n} texels "
            "updated, the rest byte-equal")
        return update

    painter.stamp = checked
    try:
        # chord c = 2 sin(a / 2) on the unit sphere: one stamp a move
        step = 2 * math.asin(min(1.0, CLIENT_STEP_OVER * CLIENT_RADIUS / 2))
        points = []
        for k in range(CLIENT_STAMPS):
            a = CLIENT_START + k * step
            points.append(np.array([math.cos(a), 0.0, math.sin(a)],
                                   np.float32))
        stroke = BrushStroke(painter, radius=CLIENT_RADIUS)
        stroke.begin(points[0], points[0])
        for p in points[1:]:
            if stroke.move(p, p) != 1:
                raise AssertionError("client: a stroke move emitted other "
                                     "than one stamp")
        stroke.end()
        mid = points[CLIENT_STAMPS // 2]
        painter.mode = BrushMode.OVERPAINT
        painter.begin_stroke()
        painter.stamp(mid, mid, prev_point=points[0], radius=CLIENT_RADIUS)
        painter.mode = BrushMode.ERASE
        before_erase = painter.texture.clone()
        painter.begin_stroke()
        painter.stamp(mid, mid, prev_point=points[0], radius=CLIENT_RADIUS)
        if not painter.undo() or not torch.equal(painter.texture,
                                                 before_erase):
            raise AssertionError("client: undo did not restore the texture "
                                 "from before the Erase stamp")
        log("client: undo restored the texture byte-equal")
        painter.mode = BrushMode.INPAINT
    finally:
        painter.stamp = inner
    want = ["INPAINT"] * CLIENT_STAMPS + ["OVERPAINT", "ERASE"]
    if modes != want:
        raise AssertionError(f"client: stamps {modes}, expected {want}")
    return len(modes)


def timer_line(timer, stages):
    """'stage wall ms (device ms)' means of a StageTimer's stages."""
    import statistics

    device = timer.device_records()
    return ", ".join(
        f"{s} {statistics.fmean(timer.records[s]):.1f} ms wall"
        + (f" ({statistics.fmean(device[s]):.1f} device)" if s in device
           else "") for s in stages)


def websocket_client(model, mesh, texture, brush):
    """The port's server in this process around `model`: 2 TexturePainter
    stamps over WebsocketConditionalInpainter (the first sends the deferred
    NEW_BRUSH_IMAGE, the second a NEW_STAMP whose painted region must come
    back within a level), then a CanvasStrokePainter stroke of
    CLIENT_CANVAS_STAMPS STAMP_ATs without waiting and one fetch. Returns
    the rasterize launches of the 2 stamps, counted from 0 just before
    them."""
    import numpy as np

    from diffusiontexturepainting_torch.client.canvas_painter import (
        CanvasStrokePainter)
    from diffusiontexturepainting_torch.client.painter import TexturePainter
    from diffusiontexturepainting_torch.client.websocket_model import (
        WebsocketConditionalInpainter)
    from diffusiontexturepainting_torch.ops import raster
    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.serving.model_base import (
        float01_to_uint8)
    from diffusiontexturepainting_torch.serving.server import create_server

    server = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.socket.getsockname()[1]
        client = WebsocketConditionalInpainter(
            f"ws://127.0.0.1:{port}/websocket/", resolution=RES)
        client.set_brush(brush)
        sent, replies = [], []
        send, generate_raw = client.ws.send, client.generate_raw

        def recording_send(frame):
            sent.append(wire.RequestType(frame[0]).name)
            send(frame)

        def recording(canvas, **s):
            raw = generate_raw(canvas, **s)
            replies.append((canvas, raw))
            return raw

        client.ws.send, client.generate_raw = recording_send, recording
        painter = TexturePainter(client, mesh, texture_width=CLIENT_TEX,
                                 texture=texture, device="cuda")
        raster.rasterize_launches.reset()
        for a in (-0.3, -0.3 + CLIENT_RADIUS):
            hit = np.array([np.cos(a), 0.0, np.sin(a)], np.float32)
            before = painter.texture.clone()
            update = painter.stamp(hit, hit, radius=CLIENT_RADIUS)
            check_update(painter, before, update, "INPAINT")
        launches = raster.rasterize_launches.launches
        if sent != ["NEW_BRUSH_IMAGE", "NEW_STAMP"] or len(replies) != 2:
            raise AssertionError(f"client: the websocket stamps sent {sent}, "
                                 "not a NEW_BRUSH_IMAGE, then a NEW_STAMP")
        canvas, raw = replies[1]
        canvas_u8 = float01_to_uint8(canvas)
        painted = canvas_u8[..., 3] == 255
        got = float01_to_uint8(raw)
        diff = np.abs(got[painted].astype(int)
                      - canvas_u8[..., :3][painted].astype(int)).max(
                          initial=0)
        log(f"client: websocket TexturePainter: 2 stamps, the NEW_STAMP's "
            f"painted region ({int(painted.sum())} pixels) within {diff} "
            f"levels; {timer_line(painter.timer, ('render', 'generate', 'backproject', 'update'))}")
        if diff > 1 or not painted.any():
            raise AssertionError(f"client: the painted region came back "
                                 f"{diff} levels off")

        H, W = CLIENT_CANVAS
        start = np.zeros((H, W, 4), np.uint8)
        start[:CLIENT_BAND, :, :3], start[:CLIENT_BAND, :, 3] = 64, 255
        cp = CanvasStrokePainter(client, canvas=start, stamps_per_radius=2)
        step = RES / 4  # the radius over two stamps a radius
        x, y = RES * 0.625, H / 2
        tic = time.perf_counter()
        n = cp.begin_stroke(x, y)
        n += cp.move(x + step * (CLIENT_CANVAS_STAMPS - 1) + 1, y)
        cp.end_stroke()
        enqueued = time.perf_counter() - tic
        final = cp.texture  # FETCH_CANVAS: synchronizes the stroke
        wall = time.perf_counter() - tic
        cp.close()
        client.close()
        if n != CLIENT_CANVAS_STAMPS:
            raise AssertionError(f"client: the canvas stroke fired {n} "
                                 "stamps")
        # the stamps' windows: rows y0.., columns x0..x1 (they overlap);
        # each writes inside its 1-pixel edge mask, so their union's
        # interior is painted and the rest of the canvas untouched
        y0, x0 = int(y) - RES // 2, int(x) - RES // 2
        x1 = int(x + step * (CLIENT_CANVAS_STAMPS - 1)) + RES // 2
        outside = np.ones((H, W), bool)
        outside[y0:y0 + RES, x0:x1] = False
        window = np.zeros((H, W), bool)
        window[y0 + 1:y0 + RES - 1, x0 + 1:x1 - 1] = True
        if not np.array_equal(final[outside], start[outside]):
            raise AssertionError("client: the canvas changed outside the "
                                 "stamps")
        band = window.copy()
        band[CLIENT_BAND:] = False
        drift = np.abs(final[band].astype(int) - start[band]).max(initial=0)
        fresh = window.copy()
        fresh[:CLIENT_BAND] = False
        if drift > 1 or not (final[fresh][:, 3] == 255).all() \
                or final[fresh][:, :3].std() < 1.0:
            raise AssertionError(f"client: the canvas stroke: painted band "
                                 f"{drift} levels off, or the stamped "
                                 "region not painted")
        log(f"client: CanvasStrokePainter over the websocket: "
            f"{CLIENT_CANVAS_STAMPS} STAMP_ATs enqueued in "
            f"{enqueued * 1e3:.1f} ms, the stroke with its FETCH_CANVAS "
            f"{wall * 1e3:.1f} ms wall ({H}x{W} canvas, {RES}^2/{STEPS}); "
            f"painted band within {drift} levels, the stamped region "
            f"painted, the rest byte-equal ({CARD[0]})")
    finally:
        server.shutdown()
        thread.join(timeout=60)
    return launches


def client_phase(model):
    """The painting client on the card (client/): the rasterizer's kernel
    against its plain version at the painter's shapes on a 65,024-face UV
    sphere; a full-width TexturePainter stroke (BrushStroke, then Overpaint,
    Erase and undo) over `model`, every update checked, the model's and the
    rasterizer's launches counted from 0; then over the loopback websocket
    (websocket_client). Returns the rasterizer's kernels-line record."""
    import shutil
    import tempfile

    import torch

    from diffusiontexturepainting_torch.client.painter import TexturePainter
    from diffusiontexturepainting_torch.ops import raster

    phase_tic = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dtp_client_")
    try:
        mesh, obj_bytes = client_sphere(root)
    finally:
        shutil.rmtree(root)
    log(f"client: UV sphere {CLIENT_SPHERE[0]} x {CLIENT_SPHERE[1]}: "
        f"{mesh.faces.shape[0]} faces, {mesh.vertices.shape[0]} vertices, "
        f"through save_obj / load_obj ({obj_bytes} bytes) in "
        f"{time.perf_counter() - phase_tic:.1f} s")
    brush = requests()[0]
    model.set_brush(brush)
    painter = TexturePainter(model, mesh, texture_width=CLIENT_TEX,
                             device="cuda")
    sums = raster_against_plain(painter)

    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    raster.rasterize_launches.reset()
    painter.timer.records.clear()
    tic = time.perf_counter()
    stamps = client_stroke(painter)
    torch.cuda.synchronize()
    stroke_s = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    check_counts("client", model, STEPS, launches, stamps - 1)
    raster_launches = raster.rasterize_launches.launches
    if raster_launches != 2 * stamps:
        raise AssertionError(f"client: rasterize launched "
                             f"{raster_launches} times in {stamps} stamps, "
                             f"expected {2 * stamps}")
    log(f"client: TexturePainter at {RES}^2/{STEPS} on {CLIENT_TEX}^2: "
        f"{stamps} stamps in {stroke_s:.2f} s; per stamp "
        f"{timer_line(painter.timer, ('render', 'generate', 'backproject', 'update'))}"
        f"; rasterize {raster_launches} launches ({CARD[0]})")

    ws_launches = websocket_client(model, mesh, painter.texture, brush)
    if ws_launches != 4:
        raise AssertionError(f"client: rasterize launched {ws_launches} "
                             "times in the 2 websocket stamps, expected 4")
    log(f"client: rasterize {ws_launches} launches in the 2 websocket "
        "stamps (counted from 0)")
    phase_s = time.perf_counter() - phase_tic
    log(f"client: phase done in {phase_s:.1f} s ({CARD[0]})")
    return {
        "name": "rasterize", "route": "cuda",
        "source": "diffusiontexturepainting_torch/csrc/raster.cu",
        "replaces": "diffusiontexturepainting_tpu/ops/raster.py:24",
        "replaces_is": "no pallas_call: the JAX client's dense XLA "
                       "rasterize, and kaolin's CUDA rasterizer in the "
                       "reference client",
        "path": "client", "launches": raster_launches,
        "launches_by_path": {"client": raster_launches,
                             "client_ws": ws_launches},
        "max_abs_err": float(sums["max_abs_err"]), "face_idx_mismatches": 0,
        "ms": sums["view_ms"] + sums["backprojection_ms"],
        "plain_ms": sums["view_plain_ms"] + sums["backprojection_plain_ms"],
        "bound_ms": sums["view_bound_ms"] + sums["backprojection_bound_ms"],
        "bound_by": ("operations" if sums["by_operations"]
                     > sums["by_bytes"] else "bytes"),
        "library_ms": None,
        "ms_is": f"kernel time a stamp: the {RES}^2 view and the "
                 f"{CLIENT_TEX}^2 back-projection on the {mesh.faces.shape[0]}"
                 f"-face sphere, the mean over {len(CLIENT_POSITIONS)} brush "
                 "positions",
        "ms_by_pass": {k: sums[f"{k}_ms"] for k in ("view",
                                                    "backprojection")},
        "plain_ms_by_pass": {k: sums[f"{k}_plain_ms"]
                             for k in ("view", "backprojection")},
        "phase_s": phase_s}


RUN_ENTRY = [sys.executable, "-m",
             "diffusiontexturepainting_torch.serving.run", "--host",
             "127.0.0.1"]


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def health(port, proc, deadline):
    """The /health JSON of the server process `proc` on `port`, polled
    until time.perf_counter() passes `deadline`."""
    import urllib.request

    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"cli: the server on {port} exited "
                                 f"with {proc.returncode}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.5)
    raise AssertionError(f"cli: no /health on {port} in time")


def stop(procs):
    for proc in procs:
        proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def cli_phase(directory):
    """The entry point as a user starts it, in processes of its own:
    `python -m diffusiontexturepainting_torch.serving.run --checkpoint_dir
    DIR --scheduler EulerA --warmup-points 256x20` (DIR holding the seeded
    random weights), the same without the checkpoint and with --no-warmup
    (cold, the same weights), and `--mock` with no card visible. Each
    torch server's first NEW_STAMP, over the websocket of the first and
    over POST /inpaint of the second: byte-equal, walls side by side. Every
    process is stopped before this returns."""
    import os

    import numpy as np
    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.serving import wire

    R = wire.RequestType
    _, canvas = requests()
    req = wire.encode_request(R.NEW_STAMP, canvas, **settings(STEPS))
    root = os.path.dirname(os.path.abspath(__file__))
    flags = [["--checkpoint_dir", directory, "--scheduler", "EulerA",
              "--warmup-points", f"{RES}x{STEPS}"],
             ["--scheduler", "EulerA", "--no-warmup"],
             ["--mock"]]
    want_info = ["torch-sd15-inpaint default EulerA",
                 "torch-sd15-inpaint default EulerA (random weights)", "mock"]
    procs, logs = [], []
    try:
        ports = [free_port() for _ in flags]
        tic = time.perf_counter()
        for k, port in enumerate(ports):
            env = dict(os.environ)
            if flags[k] == ["--mock"]:
                env["CUDA_VISIBLE_DEVICES"] = ""
            logs.append(open(os.path.join(directory, f"cli{k}.log"), "w+"))
            procs.append(subprocess.Popen(
                RUN_ENTRY + ["--port", str(port)] + flags[k], cwd=root,
                env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        infos = [health(p, proc, tic + 600)["model"]
                 for p, proc in zip(ports, procs)]
        ready = time.perf_counter() - tic
        if infos != want_info:
            raise AssertionError(f"cli: /health said {infos}")
        with connect(f"ws://127.0.0.1:{ports[0]}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            t0 = time.perf_counter()
            ws.send(req)
            warmed = ws.recv(timeout=600)
            warmed_s = time.perf_counter() - t0
        check_reply(warmed, R.RETURN_STAMP, RES, canvas)
        t0 = time.perf_counter()
        status, cold = Served.post_to(ports[1], req)
        cold_s = time.perf_counter() - t0
        if status != 200 or cold != warmed:
            raise AssertionError(f"cli: the cold server's POST /inpaint "
                                 f"({status}) differs from the warmed "
                                 "server's websocket reply")
        status, mocked = Served.post_to(ports[2], wire.encode_request(
            R.NEW_STAMP, np.zeros((RES, RES, 4), np.uint8)))
        if status != 200 or mocked[0] != R.RETURN_STAMP:
            raise AssertionError(f"cli: the mock answered {status}")
        log(f"cli: `serving.run --checkpoint_dir DIR --scheduler EulerA "
            f"--warmup-points {RES}x{STEPS}`, `serving.run --scheduler "
            "EulerA --no-warmup` (the same seeded weights) and `serving.run "
            f"--mock` (no card visible) answered /health {ready:.1f} s after "
            f"they were started; the first NEW_STAMP ({RES}^2, {STEPS} "
            f"steps, EulerA) of each torch server, fresh processes with the "
            f"kernels built on disk: warmed over the websocket "
            f"{warmed_s * 1e3:.1f} ms, cold over POST /inpaint "
            f"{cold_s * 1e3:.1f} ms wall, byte-equal; the mock's reply over "
            f"POST {len(mocked)} bytes ({CARD[0]})")
    except Exception:
        for f in logs:
            f.seek(0)
            log(f"cli: {f.name}: " + f.read()[-3000:])
        raise
    finally:
        stop(procs)
        for f in logs:
            f.close()


class Served:
    """A server of serving/run.py build_server(argv) in a thread."""

    def __init__(self, argv):
        from diffusiontexturepainting_torch.serving.run import build_server

        self.server = build_server(["--host", "127.0.0.1", "--port", "0"]
                                   + argv)
        self.model = self.server.model
        self.port = self.server.socket.getsockname()[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, body):
        return Served.post_to(self.port, body)

    @staticmethod
    def post_to(port, body):
        """(status, body) of an HTTP POST /inpaint to the local `port`."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/inpaint", body=body)
        resp = conn.getresponse()
        out = resp.status, resp.read()
        conn.close()
        return out

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=60)
        del self.model, self.server
        release()


def run_flags_phase():
    """Servers assembled by run.py's build_server: cold against warmed
    first stamps, POST /inpaint against the handler, --debug_dir and
    --profile-dir."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.serving.server import (
        SESSION_OVER_HTTP)

    R = wire.RequestType
    brush, canvas = requests()
    stamp_req = wire.encode_request(R.NEW_STAMP, canvas,
                                    **settings(FEW_STEPS))
    firsts, walls = {}, {}
    for label, argv in (("cold", ["--no-warmup"]),
                        ("warmed", ["--warmup-points", "256x4,512x4"])):
        served = Served(argv)
        try:
            startup = ", ".join(
                f"{k} {v / 2**30:.2f} GiB" if k.endswith("pool_bytes")
                else f"{k} {v:.2f} s"
                for k, v in served.server.startup.items())
            log(f"run_flags: {label} server built: {startup}")
            tic = time.perf_counter()
            status, firsts[label] = served.post(stamp_req)
            walls[label] = time.perf_counter() - tic
            if status != 200:
                raise AssertionError(f"run_flags: {label}: POST /inpaint "
                                     f"answered {status}")
            check_reply(firsts[label], R.RETURN_STAMP, RES, canvas)
        finally:
            served.close()
    if firsts["cold"] != firsts["warmed"]:
        raise AssertionError("run_flags: the warmed server's first stamp "
                             "differs from the cold server's")
    log(f"run_flags: first NEW_STAMP over POST /inpaint ({RES}^2, "
        f"{FEW_STEPS} steps): cold {walls['cold'] * 1e3:.1f} ms, warmed "
        f"{walls['warmed'] * 1e3:.1f} ms wall, byte-equal ({CARD[0]}; one "
        "process, the kernels already built)")

    scratch = tempfile.mkdtemp(prefix="dtp_run_flags_")
    debug_dir = os.path.join(scratch, "debug")
    profile_dir = os.path.join(scratch, "profile")
    served = Served(["--no-warmup", "--debug_dir", debug_dir,
                     "--profile-dir", profile_dir])
    try:
        model = served.model
        for raw in (wire.encode_request(R.NEW_BRUSH_IMAGE, brush,
                                        **settings(FEW_STEPS)), stamp_req):
            counter = model.request_counter
            status, body = served.post(raw)
            model.request_counter = counter
            if status != 200 or body != wire.handle_request_bytes(model,
                                                                  raw):
                raise AssertionError(f"run_flags: POST /inpaint type {raw[0]}"
                                     f" ({status}) differs from the handler")
        status, body = served.post(wire.encode_begin_session(
            np.zeros((RES, RES, 4), np.uint8)))
        if status != 400 or json.loads(body) != {"error": SESSION_OVER_HTTP}:
            raise AssertionError(f"run_flags: BEGIN_SESSION over POST: "
                                 f"{status} {body[:200]!r}")
        log("run_flags: POST /inpaint NEW_BRUSH_IMAGE and NEW_STAMP "
            "byte-equal to wire.handle_request_bytes at the same request "
            f"counter; BEGIN_SESSION -> 400 {body.decode()}")
        dumped = sorted(f.split("_", 1)[1] for f in os.listdir(debug_dir))
        if dumped != ["brush_brush.npy", "stamp_canvas.npy",
                      "stamp_result.npy"]:
            raise AssertionError(f"run_flags: --debug_dir holds {dumped}")
        log(f"run_flags: --debug_dir: {sorted(os.listdir(debug_dir))}")
        # one step: the profiler's cost grows with the events traced
        with connect(f"ws://127.0.0.1:{served.port}/websocket/",
                     max_size=None, open_timeout=60) as ws:
            tic = time.perf_counter()
            ws.send(wire.encode_request(R.NEW_STAMP, canvas, **settings(1)))
            check_reply(ws.recv(timeout=600), R.RETURN_STAMP, RES, canvas)
            traced_s = time.perf_counter() - tic
        traces = os.listdir(profile_dir)
        if len(traces) != 1:
            raise AssertionError(f"run_flags: --profile-dir holds {traces}")
        trace = os.path.join(profile_dir, traces[0])
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = Counter(e["name"] for e in events
                          if e.get("cat") == "kernel")
        # the port's kernels live in namespace dtp (csrc/*.cu): "dtp::" in
        # a demangled name, "3dtp" in a mangled one
        ours = {k: n for k, n in kernels.items()
                if "dtp::" in k or "3dtp" in k}
        if not ours:
            raise AssertionError("run_flags: the trace names no dtp:: kernel"
                                 f" among {len(kernels)}: "
                                 + ", ".join(sorted(kernels)[:8]))
        log(f"run_flags: --profile-dir: {traces[0]}, "
            f"{os.path.getsize(trace)} bytes, the traced NEW_STAMP (1 step) "
            f"{traced_s * 1e3:.1f} ms wall; {sum(kernels.values())} kernel "
            f"events, {sum(ours.values())} of the port's: "
            + ", ".join(f"{k[:60]} x{n}" for k, n in sorted(ours.items())))
    finally:
        served.close()
        shutil.rmtree(scratch, ignore_errors=True)
    return walls


# The batched phase (`--mesh data=1 --max-batch 4`): four requests of
# mixed settings, (cfg_weight, tg_weight, tg_steps as a share of the steps,
# context_pad, painted rows as a share of the canvas), each with its own
# brush, as one batch at each of BATCH_POINTS; then a serving.run process
# at its default window with 1, 2 and 4 concurrent clients at each of
# THROUGHPUT_POINTS, each client sending NEW_STAMPs in a row until it has
# THROUGHPUT_STAMPS replies or THROUGHPUT_SECONDS have passed, and two
# concurrent stroke sessions.
BATCH = 4
BATCH_SETTINGS = [(2.0, 1.0, 1.0, 150, 0.25), (3.0, 0.5, 0.5, 40, 0.375),
                  (1.5, 0.0, 0.0, 0, 0.125), (2.5, 1.0, 0.25, 300, 0.5)]
BATCH_POINTS = ((RES, STEPS), (ENVELOPE_RES, FEW_STEPS))
THROUGHPUT_POINTS = ((RES, STEPS), (SLOTTED_RES, FEW_STEPS))
THROUGHPUT_CLIENTS = (1, 2, 4)
THROUGHPUT_STAMPS = 30
THROUGHPUT_SECONDS = 20.0
# A batched request against itself alone (the kernels' plans follow the
# batch, so bf16 sums in another order): at most SELF_MEAN_DIFF u8 levels
# on average and SELF_MAX_DIFF at any pixel. Sound batches read 0.32-0.59
# and max 4-8 on an H100 (PERF.md); a request given its neighbour's
# settings must break one of the two (the smoke plants that each run).
SELF_MEAN_DIFF = 2.0
SELF_MAX_DIFF = 32
# the per-request settings a planted mix-up moves one slot along
SLOT_SETTINGS = ("cfg_weight", "tg_weight", "tg_steps", "context_pad")
BATCHED_STROKES = [[(0, 0, False), (96, 40, True), (300, 200, False)],
                   [(256, 256, False), (40, 300, False), (500, -8, True)]]


def batched_payloads(svc, sessions, res, steps):
    """One NEW_STAMP payload of each session at BATCH_SETTINGS, as the
    service's submit builds it, with the next counters."""
    import numpy as np

    rng = np.random.default_rng(res)
    out = []
    for s, (cfg, tgw, tgs, pad, rows) in zip(sessions, BATCH_SETTINGS):
        canvas = np.zeros((res, res, 4), np.uint8)
        n = int(rows * res)
        canvas[:n, :, :3] = rng.integers(0, 256, (n, res, 3))
        canvas[:n, :, 3] = 255
        steps_, cfg_w, tg_w, tg_steps, pad = svc.base._settings(dict(
            steps=steps, cfg_weight=cfg, tg_weight=tgw,
            tg_steps=int(tgs * steps), context_pad=pad))
        out.append(dict(canvas=canvas, image=s.image, brush=s._brush,
                        cond=s._cond, uncond=s._uncond,
                        counter=svc.next_counter(), cfg_weight=cfg_w,
                        tg_weight=tg_w, tg_steps=tg_steps, context_pad=pad))
    return out


def batched_phase(model):
    """The default model's batched stamps (serving/parallel_model.py, one
    batch of BATCH at each of BATCH_POINTS): each kernel's launches in one
    batch against one stamp's (expected_per_stamp) plus the launches a
    split over the batch added (LaunchCounter.split), each request's mean
    and max |diff| against itself alone (a batch of one at its counter)
    within SELF_MEAN_DIFF and SELF_MAX_DIFF with the painted region
    byte-equal, and at 256^2 the planted mix-up those limits must catch
    (planted_mixup); the wall of the batch and of the four alone, peak
    memory; the split K5 shape against its plain version.
    Then the server process (batched_serving_process). Returns the 256^2
    batch's (launches, shapes)."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving.parallel_model import (
        make_parallel_service)

    svc = make_parallel_service(RES, "data=1", max_batch=BATCH, model=model)
    rng = np.random.default_rng(7)
    sessions = [svc.new_session() for _ in range(BATCH)]
    for s in sessions:
        s.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    result = None
    for res, steps in BATCH_POINTS:
        label = f"batched {res}^2/{steps}"
        payloads = batched_payloads(svc, sessions, res, steps)
        # the batch's and a lone request's programs captured (and their
        # launches not counted) before the timed run
        svc._run_batch((res, steps), payloads)
        svc._run_batch((res, steps), payloads[:1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters():
            c.reset()
        tic = time.perf_counter()
        batch = svc._run_batch((res, steps), payloads)
        wall = time.perf_counter() - tic
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {c.name: c.launches for c in counters()}
        split = {c.name: c.split for c in counters()}
        shapes = {c.name: dict(c.shapes) for c in counters()}
        want = expected_per_stamp(model, res, steps)
        for name in want:
            if launches[name] != want[name] + split[name]:
                raise AssertionError(
                    f"{label}: {name}: {launches[name]} launches, one "
                    f"stamp's {want[name]} + {split[name]} split")
        log(f"{label}: one batch of {BATCH} launched each kernel as often "
            f"as one stamp: " + ", ".join(
                f"{n} {launches[n]}" + (f" (= {want[n]} + {split[n]} "
                                        "split over the batch)"
                                        if split[n] else "")
                for n in want if launches[n]))
        solo_wall, alone = 0.0, []
        for k, (p, got) in enumerate(zip(payloads, batch)):
            tic = time.perf_counter()
            alone.append(svc._run_batch((res, steps), [p])[0])
            solo_wall += time.perf_counter() - tic
            painted = p["canvas"][..., 3] == 255
            diff = np.abs(got.astype(int) - alone[k].astype(int))
            log(f"{label}: request {k} (cfg {p['cfg_weight']}, tg "
                f"{p['tg_weight']} for {p['tg_steps']} calls, pad "
                f"{p['context_pad']}): against itself alone mean |diff| "
                f"{diff.mean():.4f} u8 levels, max {diff.max()}, "
                f"{(diff == 0).mean():.4f} exact; painted region "
                f"{'byte-equal' if not diff[painted].any() else 'DIFFERS'}")
            if diff[painted].any():
                raise AssertionError(f"{label}: request {k}'s painted "
                                     "region differs from itself alone")
            if not (diff.mean() <= SELF_MEAN_DIFF
                    and diff.max() <= SELF_MAX_DIFF):
                raise AssertionError(
                    f"{label}: request {k} is {diff.mean():.3f} levels "
                    f"(max {diff.max()}) from itself alone, above "
                    f"{SELF_MEAN_DIFF} (max {SELF_MAX_DIFF})")
            check_reply(wire_reply(got), RETURN_STAMP, res, p["canvas"])
        if (res, steps) == (RES, STEPS):
            planted_mixup(svc, (res, steps), label, payloads, alone)
        log(f"{label}: batch wall {wall * 1e3:.1f} ms, the {BATCH} requests "
            f"alone {solo_wall * 1e3:.1f} ms ({BATCH / wall:.3f} against "
            f"{BATCH / solo_wall:.3f} stamps/s); peak device memory of the "
            f"batch {peak:.2f} GiB ({CARD[0]})")
        if split["gn_conv_stream"]:
            key = max(shapes["gn_conv_stream"], key=lambda k: math.prod(
                k[0]))
            r = compare("gn_conv_stream", key, torch.bfloat16,
                        torch.Generator(device="cuda").manual_seed(1))
            log(f"{label}: K5 at {key} (split over the batch): max_abs_err "
                f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}); err/tol "
                f"{r['err_over_tol']:.3f}" + self_note(r))
        if result is None:
            result = launches, shapes
        del batch
        release()
    svc.worker.shutdown()
    return result


def planted_mixup(svc, key, label, payloads, alone):
    """The batch again with each slot given its neighbour's settings
    (SLOT_SETTINGS), as a batch that crossed them between slots would
    compute: each request against itself alone must break SELF_MEAN_DIFF
    or SELF_MAX_DIFF, or those limits could not see such a fault."""
    import numpy as np

    crossed = [dict(p, **{k: payloads[(i + 1) % len(payloads)][k]
                          for k in SLOT_SETTINGS})
               for i, p in enumerate(payloads)]
    for k, (got, want) in enumerate(zip(svc._run_batch(key, crossed),
                                        alone)):
        diff = np.abs(got.astype(int) - want.astype(int))
        caught = (diff.mean() > SELF_MEAN_DIFF
                  or diff.max() > SELF_MAX_DIFF)
        log(f"{label}: planted mix-up, request {k} with request "
            f"{(k + 1) % len(payloads)}'s settings: against itself alone "
            f"mean |diff| {diff.mean():.4f} u8 levels, max {diff.max()}: "
            + ("caught" if caught else "NOT CAUGHT"))
        if not caught:
            raise AssertionError(f"{label}: the limits {SELF_MEAN_DIFF} / "
                                 f"{SELF_MAX_DIFF} miss request {k}'s "
                                 "planted mix-up")


RETURN_STAMP = 4  # wire.RequestType.RETURN_STAMP


def wire_reply(stamp):
    """A RETURN_STAMP reply of `stamp`, for check_reply."""
    from diffusiontexturepainting_torch.serving import wire

    return wire.encode_response(RETURN_STAMP, stamp)


def batched_serving_process():
    """`serving.run --mesh data=1 --max-batch 4` (its default window) in a
    process of its own: 1, 2 and 4 concurrent clients at each of
    THROUGHPUT_POINTS, each with its own brush, sending NEW_STAMPs in a row
    until it has THROUGHPUT_STAMPS replies or THROUGHPUT_SECONDS have
    passed, after one untimed stamp of every client together (which
    captures the batch size's program): stamps/s, beside it the NEW_STAMP
    batches' sizes and their mean wait for peers from /health (previews
    and the untimed stamps left out; batches above 1 required with 2 and 4
    clients); two concurrent stroke
    sessions on 512^2 canvases, every STAMP_AT returning its pixels, each
    fetched canvas byte-equal to its own host oracle built from those
    pixels. The process is stopped before this returns."""
    import os
    import tempfile

    import numpy as np
    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.pipeline import session
    from diffusiontexturepainting_torch.serving import wire

    R = wire.RequestType
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    logf = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        RUN_ENTRY + ["--port", str(port), "--mesh", "data=1", "--max-batch",
                     str(BATCH), "--warmup-points",
                     ",".join(f"{r}x{s}" for r, s in THROUGHPUT_POINTS)],
        cwd=root, stdout=logf, stderr=subprocess.STDOUT)
    url = f"ws://127.0.0.1:{port}/websocket/"

    def clients(n, fn, action=None):
        out, errors = [None] * n, []
        barrier = threading.Barrier(n, action=action)

        def go(i):
            try:
                with connect(url, max_size=None, open_timeout=60) as ws:
                    out[i] = fn(i, ws, barrier)
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        return out

    try:
        tic = time.perf_counter()
        info = health(port, proc, tic + 600)
        log(f"batched: `serving.run --mesh data=1 --max-batch {BATCH}` "
            f"answered /health in {time.perf_counter() - tic:.1f} s: "
            f"{info}")
        for res, steps in THROUGHPUT_POINTS:
            for n in THROUGHPUT_CLIENTS:
                before = []  # /health at each barrier: the last is read
                canvases = [requests(res)[1] for _ in range(n)]

                def paint(i, ws, barrier):
                    rng = np.random.default_rng(100 + i)
                    ws.send(wire.encode_request(
                        R.NEW_BRUSH_IMAGE, rng.integers(
                            0, 256, (300, 400, 3), dtype=np.uint8),
                        **settings(steps, res)))
                    # the preview is the model's resolution's
                    check_reply(ws.recv(timeout=600), R.RETURN_PREVIEW, RES)
                    # one stamp of every client together, untimed: the
                    # batch size's program is captured at its first batch
                    barrier.wait(timeout=600)
                    ws.send(wire.encode_request(
                        R.NEW_STAMP, canvases[i], **settings(steps, res)))
                    check_reply(ws.recv(timeout=600), R.RETURN_STAMP, res,
                                canvases[i])
                    barrier.wait(timeout=600)
                    t0 = time.perf_counter()
                    done = 0
                    while (done < THROUGHPUT_STAMPS and time.perf_counter()
                           - t0 < THROUGHPUT_SECONDS):
                        ws.send(wire.encode_request(
                            R.NEW_STAMP, canvases[i],
                            **settings(steps, res)))
                        check_reply(ws.recv(timeout=600), R.RETURN_STAMP,
                                    res, canvases[i])
                        done += 1
                    return t0, time.perf_counter(), done

                spans = clients(n, paint, lambda: before.append(health(
                    port, proc, time.perf_counter() + 60)))
                wall = (max(e for _, e, _ in spans)
                        - min(s for s, _, _ in spans))
                stamps = sum(d for _, _, d in spans)
                after = health(port, proc, time.perf_counter() + 60)
                sizes = {k: v - before[-1]["batches"].get(k, 0)
                         for k, v in after["batches"].items()
                         if v - before[-1]["batches"].get(k, 0)}
                waits = {k: after["batch_waits"][k]
                         - before[-1]["batch_waits"][k]
                         for k in ("batches", "ms")}
                log(f"batched: {res}^2/{steps}, {n} concurrent client(s), "
                    f"NEW_STAMPs {[d for _, _, d in spans]}: "
                    f"{stamps / wall:.3f} stamps/s ({wall:.3f} s wall); "
                    f"batches by requests {sizes}, each waiting "
                    f"{waits['ms'] / max(waits['batches'], 1):.1f} ms for "
                    f"peers on average ({CARD[0]})")
                if n > 1 and not any(int(k) > 1 for k in sizes):
                    raise AssertionError(f"batched: {n} concurrent clients "
                                         "never shared a batch")
        canvas = np.zeros((SESSION_CANVAS, SESSION_CANVAS, 4), np.uint8)
        canvas[:SESSION_CANVAS // 4, :, :3] = 90
        canvas[:SESSION_CANVAS // 4, :, 3] = 255

        def stroke(i, ws, barrier):
            def ask(req):
                ws.send(req)
                return ws.recv(timeout=600)

            s = settings(FEW_STEPS)
            rng = np.random.default_rng(200 + i)
            check_reply(ask(wire.encode_request(
                R.NEW_BRUSH_IMAGE, rng.integers(0, 256, (RES, RES, 3),
                                                dtype=np.uint8), **s)),
                R.RETURN_PREVIEW, RES)
            if wire.decode_ack(ask(wire.encode_begin_session(
                    canvas, **s))) != (R.RETURN_ACK, 0):
                raise AssertionError("batched: BEGIN_SESSION not acked")
            barrier.wait(timeout=600)
            oracle = canvas
            for x0, y0, op in BATCHED_STROKES[i]:
                crop = check_reply(ask(wire.encode_stamp_at(
                    x0, y0, True, op, **s)), R.RETURN_STAMP, RES)
                oracle = session.host_stamp_update(oracle, crop, x0, y0)
            ask(wire.encode_erase_at(100, 100, False))
            oracle = session.host_erase_update(oracle, RES, 100, 100)
            kind, fetched = wire.decode_response(
                ask(wire.encode_fetch_canvas()))
            ask(wire.encode_end_session())
            return kind, np.array(fetched), oracle

        for k, (kind, fetched, oracle) in enumerate(clients(2, stroke)):
            if kind != R.RETURN_CANVAS or not np.array_equal(fetched,
                                                             oracle):
                raise AssertionError(f"batched: session {k}'s canvas "
                                     "differs from its host oracle")
        log("batched: two concurrent stroke sessions on "
            f"{SESSION_CANVAS}^2 canvases ({len(BATCHED_STROKES[0])} "
            "STAMP_ATs and an ERASE_AT each): each fetched canvas "
            "byte-equal to its own host oracle")
    except Exception:
        logf.seek(0)
        log("batched: server log: " + logf.read()[-3000:])
        raise
    finally:
        stop([proc])
        logf.close()


# The engine phase: each served point's captured program against the eager
# stamp function, (label, configuration, resolution, steps, DeepCache spec)
ENGINE_POINTS = (
    ("default 256^2/20", "default", RES, STEPS, None),
    ("default 512^2/4", "default", SLOTTED_RES, FEW_STEPS, None),
    ("default 1024^2/4", "default", ENVELOPE_RES, FEW_STEPS, None),
    ("DeepCache 2 256^2/20", "default", RES, STEPS, 2),
    ("FSSF 512^2/4", "default", SLOTTED_RES, FEW_STEPS, "FSSF"),
    ("safe twin 256^2/4", "twin", RES, FEW_STEPS, None),
    ("f32 final step 256^2/4", "f32_final", RES, FEW_STEPS, None),
    ("EulerA 256^2/4", "EulerA", RES, FEW_STEPS, None),
)
# three requests in a row through one program: (cfg, tg_weight, the share
# of the steps under texture guidance, context pad, brush seed)
ENGINE_REQUESTS = [(2.0, 1.0, 1.0, 150, 0), (3.5, 0.5, 0.5, 9, 1),
                   (1.25, 0.0, 0.0, 1, 2)]
# timed stamps of each path (eager, graph) at each point, alternated
ENGINE_STAMPS = 7


def engine_model(kind, weights):
    """A full-width model of the engine phase's configuration `kind`, from
    the default model's state_dict."""
    import dataclasses

    from diffusiontexturepainting_torch.core.config import (
        PipelineConfig,
        safe_twin_config,
    )
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    config = {"twin": safe_twin_config(),
              "f32_final": dataclasses.replace(PipelineConfig(),
                                               f32_final_step=True),
              "EulerA": dataclasses.replace(PipelineConfig(),
                                            scheduler="EulerA")}[kind]
    return TorchConditionalInpainter(RES, config=config, device="cuda",
                                     weights=weights)


def engine_stamp_args(model, res, steps, counter, request):
    """The stamp function's arguments of `request` (ENGINE_REQUESTS) at
    `counter`, the brush of its seed set on the model first."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving.model_base import (
        crop_resize_square)

    cfg, tgw, tgf, pad, seed = request
    rng = np.random.default_rng(100 + seed)
    model.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    brush = model._brush
    if res != model.resolution():
        brush = torch.from_numpy(crop_resize_square(
            model.image, res).astype(np.float32)[None]).cuda()
    canvas = np.zeros((1, res, res, 4), np.uint8)
    n = res // (3 + seed)
    canvas[:, :n, :, :3] = rng.integers(0, 256, (1, n, res, 3))
    canvas[:, :n, :, 3] = 255
    enc, init, step = model.draws(counter, res, steps)
    return (torch.from_numpy(canvas).cuda(), brush, model._cond,
            model._uncond, enc, init, cfg, tgw, int(tgf * steps), pad, step)


def graph_against_eager(label, got, want):
    """A replay's (raw, composited) byte-equal to the eager stamp's: the
    same kernels and plans on the same arguments."""
    import numpy as np

    for what, g, w in zip(("raw", "composited"), got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if not np.array_equal(g, w):
            diff = np.abs(g.astype(int) - w.astype(int))
            raise AssertionError(
                f"engine: {label}: {what} replay against eager: mean "
                f"|diff| {diff.mean():.4f}, max {diff.max()}: not "
                "byte-equal")


def engine_point(label, model, res, steps):
    """One point: warm-up (its capture's seconds and pool bytes), timed
    served stamps (graph) alternated with the eager stamp function, one
    replay's device ms, three requests of changing settings, brushes and
    counters through the one program, each against the eager stamp on the
    same arguments, and their launches against expected_per_stamp."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.profile_stamp import (
        eager_stamps,
        replay_ms,
    )

    counter = model.request_counter
    point = (res, steps)
    warm = model.warmup([point])[point]
    fn = model._stamp_fn(steps)
    captured = model.engine.captures[fn.program_key(res, 1)]
    prog = model.engine.programs[fn.program_key(res, 1)]
    _, canvas = requests(res)
    s = settings(steps, res)

    def timed():
        torch.cuda.synchronize()
        tic = time.perf_counter()
        model.generate_u8(canvas, **s)
        return (time.perf_counter() - tic) * 1e3

    first = timed()
    walls = {"eager": [], "graph": []}
    for _ in range(ENGINE_STAMPS + 1):  # the first pair warms the eager path
        with eager_stamps(model):
            walls["eager"].append(timed())
        walls["graph"].append(timed())
    walls = {k: v[1:] for k, v in walls.items()}
    device = replay_ms(prog)
    model.request_counter = counter
    q = {k: np.percentile(v, [25, 50, 75]) for k, v in walls.items()}
    log(f"engine: {label}: warm-up {warm:.2f} s; the program's eager pass "
        f"and capture {captured['seconds']:.2f} s (at its first call: "
        + ("this warm-up" if point in model.warmup_captures else "earlier")
        + f"), the pool {captured['pool_bytes'] / 2**30:.2f} GiB reserved "
        "after it; stamp wall ms "
        + "; ".join(f"{k} median {m:.1f} (p25 {a:.1f}, p75 {b:.1f}), busy "
                    f"{device / m:.3f}" for k, (a, m, b) in q.items())
        + f"; one replay {device:.2f} ms of device time; the first stamp "
        f"after the warm-up {first:.1f} ms against the later ones' median "
        f"{q['graph'][1]:.1f} ({CARD[0]})")

    cases = [engine_stamp_args(model, res, steps, counter + 1 + k, r)
             for k, r in enumerate(ENGINE_REQUESTS)]
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    replays = prog.replays
    got = [fn(*args) for args in cases]
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters()}
    if prog.replays != replays + len(cases):
        raise AssertionError(f"engine: {label}: the requests did not "
                             "replay the point's program")
    check_counts(f"engine {label}", model, steps, launches, len(cases), res,
                 dtypes=launch_dtypes())
    for args, g in zip(cases, got):
        graph_against_eager(label, g, fn.eager(*args))
    if all(np.array_equal(got[0][1].cpu(), g[1].cpu()) for g in got[1:]):
        raise AssertionError(f"engine: {label}: three requests gave one "
                             "stamp")
    log(f"engine: {label}: three requests (cfg, tg_weight, tg_steps, pad, "
        "brush, counter changed) through one program, each byte-equal to "
        "the eager stamp function on its arguments")
    return dict(label=label, capture_s=captured["seconds"],
                pool_bytes=captured["pool_bytes"],
                eager_ms=float(q["eager"][1]), graph_ms=float(q["graph"][1]),
                device_ms=device, first_ms=first)


def engine_batches(model):
    """B = 1..4 at 256^2/20 through the service (_run_batch, on its
    worker's function), each batch's program captured at its first batch,
    against the same batch through the eager stamp.batched; each batch's
    launches against one stamp's plus the split ones."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving.parallel_model import (
        make_parallel_service)

    svc = make_parallel_service(RES, "data=1", max_batch=BATCH, model=model)
    rng = np.random.default_rng(11)
    sessions = [svc.new_session() for _ in range(BATCH)]
    for sess in sessions:
        sess.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    key = (RES, STEPS)
    fn = model._stamp_fn(STEPS)
    try:
        for B in range(1, BATCH + 1):
            payloads = batched_payloads(svc, sessions[:B], RES, STEPS)
            torch.cuda.synchronize()
            for c in counters():
                c.reset()
            tic = time.perf_counter()
            got = svc._run_batch(key, payloads)
            first = time.perf_counter() - tic
            launches = {c.name: c.launches for c in counters()}
            split = {c.name: c.split for c in counters()}
            want = expected_per_stamp(model, RES, STEPS)
            bad = [n for n in want if launches[n] != want[n] + split[n]]
            if bad:
                raise AssertionError(f"engine: batch of {B}: launches of "
                                     f"{bad} off one stamp's")
            tic = time.perf_counter()
            svc._run_batch(key, payloads)
            replay = time.perf_counter() - tic
            svc.engine.stamp_fn = lambda steps: model._stamp_fn(steps).eager
            try:
                tic = time.perf_counter()
                eager = svc._run_batch(key, payloads)
                eager_s = time.perf_counter() - tic
            finally:
                del svc.engine.stamp_fn
            for k, (g, w) in enumerate(zip(got, eager)):
                if not np.array_equal(g, w):
                    diff = np.abs(g.astype(int) - w.astype(int))
                    raise AssertionError(
                        f"engine: batch of {B}, request {k}: replay against "
                        f"eager mean |diff| {diff.mean():.4f}, max "
                        f"{diff.max()}")
            captured = model.engine.captures[fn.program_key(RES, B)]
            log(f"engine: batch of {B} at {RES}^2/{STEPS} through the "
                f"service: every request byte-equal to the eager "
                f"stamp.batched; launches one stamp's; capture "
                f"{captured['seconds']:.2f} s, pool "
                f"{captured['pool_bytes'] / 2**30:.2f} GiB; wall with the "
                f"capture {first * 1e3:.1f} ms, replayed {replay * 1e3:.1f} "
                f"ms, eager {eager_s * 1e3:.1f} ms ({CARD[0]})")
    finally:
        svc.worker.shutdown()


def engine_session(model):
    """The session phase's requests through the handler twice at the same
    counters, served by the engine and under eager_stamps: the STAMP_ATs
    without pixels enqueued with host syncs made an error, their ack ms
    side by side; both fetched canvases byte-equal to the host oracle."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.profile_stamp import eager_stamps
    from diffusiontexturepainting_torch.serving import wire

    handle = wire.handle_request_bytes
    canvas, reqs = session_requests()
    n_free = sum(not px for _, _, px, _ in SESSION_STAMPS)
    counter = model.request_counter
    model._stamp_fn(FEW_STEPS)
    acks, fetched = {}, {}
    for path in ("eager", "graph", "eager", "graph"):
        model.request_counter = counter
        ctx = eager_stamps(model) if path == "eager" else nullcontext()
        with ctx:
            handle(model, reqs[0])
            torch.cuda.synchronize()
            times = []
            for raw in reqs[1:1 + n_free]:
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    handle(model, raw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                times.append((time.perf_counter() - t0) * 1e3)
            replies = [handle(model, raw) for raw in reqs[1 + n_free:]]
        acks.setdefault(path, []).extend(times)
        fetched[path] = wire.decode_response(replies[-2])[1]
    want, _, _ = session_oracle(model, canvas, counter + 1)
    model.request_counter = counter + len(SESSION_STAMPS)
    for path, got in fetched.items():
        if not np.array_equal(got, want):
            raise AssertionError(f"engine: the {path} session's canvas "
                                 "differs from the host oracle")
    log("engine: session STAMP_AT acks without pixels (two strokes each), "
        + "; ".join(f"{p} " + ", ".join(f"{a:.1f}" for a in v) + " ms "
                    f"(median {np.median(v):.1f})" for p, v in acks.items())
        + f"; both canvases byte-equal to the host oracle ({CARD[0]})")
    return {p: float(np.median(v)) for p, v in acks.items()}


def engine_phase(model, weights):
    """The engine (core/engine.py) on the card: every ENGINE_POINTS point
    (engine_point), batches of 1 to 4 (engine_batches), a session's acks
    (engine_session); the reload is checked in checkpoint_phase, where the
    checkpoint is."""
    t_phase = time.perf_counter()
    rows = []
    for label, kind, res, steps, spec in ENGINE_POINTS:
        if kind == "default":
            m = model
            m.set_deep_cache(spec or 1)
        else:
            m = engine_model(kind, weights)
        try:
            rows.append(engine_point(label, m, res, steps))
        finally:
            if m is model:
                m.set_deep_cache(1)
            else:
                del m
                release()
    engine_batches(model)
    acks = engine_session(model)
    log("engine: summary " + json.dumps(dict(points=rows, session_ack_ms=acks,
                                             card=CARD[0])))
    log(f"engine: phase done in {time.perf_counter() - t_phase:.1f} s")


def unet_eval_ms(model, res, kind):
    """CUDA-event ms of one UNet eval of `model` at `res` (the CFG batch of
    3, t 500, seeded inputs): "full" (forward_full), "shallow"
    (forward_shallow on that eval's cache) or "final" (final_unet, fp32)."""
    import torch

    lat = res // 8
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.inference_mode():
        x = torch.randn((3, lat, lat, 9), generator=gen, device="cuda")
        t = torch.full((3,), 500.0, device="cuda")
        ctx = torch.randn((3, 14, model.unet.cfg.cross_attention_dim),
                          generator=gen, device="cuda")
        _, cache = model.unet.forward_full(x, t, ctx)
        fn = {"full": lambda: model.unet.forward_full(x, t, ctx),
              "shallow": lambda: model.unet.forward_shallow(x, t, ctx,
                                                            cache),
              "final": lambda: model.final_unet(x, t, ctx)}[kind]
        return cuda_ms(fn, budget_s=1.0)


def deep_cache_session(model):
    """The session's requests (session_requests: STAMP_ATs, one with
    pixels, an erase, FETCH_CANVAS) through the request handler at the
    model's operating point; the fetched canvas byte-equal to the host
    oracle, whose per-request stamps run the same schedule at the same
    counters. Returns (launches, shapes, dtypes, stamps)."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving import wire

    canvas, reqs = session_requests()
    counter = model.request_counter
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    replies = [wire.handle_request_bytes(model, raw) for raw in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    shapes = {c.name: dict(c.shapes) for c in counters()}
    dtypes = launch_dtypes()
    fetched = wire.decode_response(replies[-2])[1]
    want, _, _ = session_oracle(model, canvas, counter + 1)
    model.request_counter = counter + len(SESSION_STAMPS)
    if not np.array_equal(fetched, want):
        raise AssertionError(f"deep_cache: the session's canvas differs from"
                             f" the host oracle in "
                             f"{int((fetched != want).sum())} bytes")
    log(f"deep_cache: a stroke session ({len(SESSION_STAMPS)} STAMP_ATs, "
        f"an erase, FETCH_CANVAS) under DeepCache "
        f"{model.config.deep_cache_interval} at {RES}^2 / {FEW_STEPS} steps "
        f"in {wall * 1e3:.1f} ms; the fetched {canvas.shape} canvas "
        "byte-equal to the host oracle")
    return launches, shapes, dtypes, len(SESSION_STAMPS)


def deep_cache_phase(model, weights, drive, paths):
    """DeepCache through the request handler at full width: interval 2 on
    the default model at 256^2 / 20 (set_deep_cache), the FSSF pattern on a
    default model at 512^2 / 4 built from `weights`; each path as phase 4
    (replay bit-identical, replies checked, launches against the schedule),
    its first stamp's distance to the exact one, a full and a shallow UNet
    eval's ms; then an FSSF stroke session on the 256^2 model."""
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    brush, _ = requests()

    def point(label, m, steps, res, spec):
        m.set_brush(brush)
        m.set_deep_cache(1)
        exact = first_stamp_at(m, steps, res)
        m.set_deep_cache(spec)
        m.request_counter = 0  # run_path's counters start from 0
        first = drive(label, m, steps, res)
        log(f"{label}: model calls of a stamp: "
            + " ".join(m._stamp_fn(steps).schedule))
        compare_stamps(label, first, exact, f"DeepCache {spec} and the "
                       f"exact schedule at {res}^2 / {steps} steps",
                       bound=None)
        full, shallow = (unet_eval_ms(m, res, k) for k in ("full",
                                                           "shallow"))
        log(f"{label}: UNet eval at {res}^2 (batch 3): full "
            f"{full:.2f} ms, shallow {shallow:.2f} ms (CUDA events, eager; "
            f"{CARD[0]})")

    tic = time.perf_counter()
    try:
        point("deep_cache", model, STEPS, RES, 2)
        model.set_deep_cache("FSSF")
        launches, shapes, dtypes, n = deep_cache_session(model)
        check_counts("deep_cache_session", model, FEW_STEPS, launches, n,
                     dtypes=dtypes)
        paths["deep_cache_session"] = dict(
            launches=launches, shapes=shapes, dtypes=dtypes, stamps=n,
            steps=FEW_STEPS, res=RES)
    finally:
        model.set_deep_cache(1)
    m512 = TorchConditionalInpainter(SLOTTED_RES, device="cuda",
                                     weights=weights)
    point("deep_cache_fssf", m512, FEW_STEPS, SLOTTED_RES, "FSSF")
    del m512
    release()
    log(f"deep_cache: phase done in {time.perf_counter() - tic:.1f} s")


def f32_phase(model, weights, drive):
    """The f32 operating points at full width: --f32-final-step at 256^2
    / 20 and --f32-components unet at 256^2 / 4, each as phase 4 with the
    fp32 twins' launches checked apart; each first stamp's distance to the
    all-fp32-UNet stamp beside the bf16 stamp's; the final fp32 eval's ms;
    then serving.run with --deep-cache-interval 2 --f32-final-step
    --warmup-points 256x20x2 in a process of its own, its first websocket
    reply byte-equal to the in-process model's."""
    import torch

    from diffusiontexturepainting_torch.core.config import PipelineConfig
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    tic = time.perf_counter()
    brush, _ = requests()
    final = TorchConditionalInpainter(
        RES, config=PipelineConfig(f32_final_step=True), device="cuda",
        weights=weights)
    final_first = drive("f32_final_step", final, STEPS, RES)
    f32unet = TorchConditionalInpainter(
        RES, device="cuda", weights=weights,
        dtype_overrides={"unet": torch.float32})
    f32_first = drive("f32_unet", f32unet, FEW_STEPS, RES)
    log(f"f32: UNet eval at {RES}^2 (batch 3): bf16 full "
        f"{unet_eval_ms(model, RES, 'full'):.2f} ms, fp32 final step "
        f"{unet_eval_ms(final, RES, 'final'):.2f} ms, fp32 UNet "
        f"{unet_eval_ms(f32unet, RES, 'full'):.2f} ms (CUDA events, eager; "
        f"{CARD[0]})")
    refs = {FEW_STEPS: f32_first}
    f32unet.set_brush(brush)
    refs[STEPS] = first_stamp_at(f32unet, STEPS)
    del f32unet
    release()
    for steps in (STEPS, FEW_STEPS):
        for m in (model, final):
            m.set_brush(brush)
        ours = {"bf16": first_stamp_at(model, steps),
                "f32 final step": (final_first if steps == STEPS
                                   else first_stamp_at(final, steps))}
        for what, stamp in ours.items():
            compare_stamps("f32", stamp, refs[steps], f"the {what} stamp "
                           f"and the all-fp32-UNet stamp at {RES}^2 / "
                           f"{steps} steps", bound=None)
    cli_operating_point(final)
    del final
    release()
    log(f"f32: phase done in {time.perf_counter() - tic:.1f} s")


def cli_operating_point(model):
    """`serving.run --deep-cache-interval 2 --f32-final-step
    --warmup-points 256x20x2` in a process of its own (the seeded random
    weights `model` was built from); its first NEW_STAMP over the websocket
    byte-equal to `model`'s (f32_final_step, DeepCache 2 set, the neutral
    brush) at the same request counter. The process is stopped before this
    returns."""
    import os
    import tempfile

    import numpy as np
    from websockets.sync.client import connect

    from diffusiontexturepainting_torch.serving import wire

    R = wire.RequestType
    _, canvas = requests()
    req = wire.encode_request(R.NEW_STAMP, canvas, **settings(STEPS))
    flags = ["--deep-cache-interval", "2", "--f32-final-step",
             "--warmup-points", f"{RES}x{STEPS}x2"]
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    logf = tempfile.TemporaryFile("w+")
    tic = time.perf_counter()
    proc = subprocess.Popen(RUN_ENTRY + ["--port", str(port)] + flags,
                            cwd=root, stdout=logf, stderr=subprocess.STDOUT)
    try:
        info = health(port, proc, tic + 600)["model"]
        ready = time.perf_counter() - tic
        with connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            t0 = time.perf_counter()
            ws.send(req)
            got = ws.recv(timeout=600)
            wall = time.perf_counter() - t0
        check_reply(got, R.RETURN_STAMP, RES, canvas)
        model.set_deep_cache(2)
        model.set_brush(np.full((RES, RES, 3), 0.5, np.float32))
        model.request_counter = 0
        want = wire.handle_request_bytes(model, req)
        if got != want:
            raise AssertionError("cli: the serving.run process's reply "
                                 "differs from the in-process model's")
        log(f"cli: `serving.run {' '.join(flags)}` ({info}) answered "
            f"/health {ready:.1f} s after it was started; its first "
            f"NEW_STAMP ({RES}^2, {STEPS} steps: "
            + " ".join(model._stamp_fn(STEPS).schedule)
            + f") over the websocket {wall * 1e3:.1f} ms wall, byte-equal "
            f"to the in-process model's ({CARD[0]})")
    except Exception:
        logf.seek(0)
        log("cli: serving.run log: " + logf.read()[-3000:])
        raise
    finally:
        stop([proc])
        logf.close()
        model.set_deep_cache(1)


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


def p_precision(got, q, k, v, heads, shift=32.0):
    """mean |got - bf16(o)| over got's elements for three float64
    evaluations o of the shifted softmax on got's bf16 inputs (q pre-scaled
    and rounded as the kernels do; s clamped at shift + 88), a head at a
    time: p unrounded into P V (T9's function), then bf16(p) (T7's and
    T2's), both with l the unrounded p's sum + 1e-30; then p =
    bf16(exp2(bf16(s - shift))) into P V with l the sum of those p + 1e-30
    (T2's with bf16 p). Returns (to_fp32_p, to_bf16_p, to_bf16_exp2)."""
    import torch

    from diffusiontexturepainting_torch.ops import attention_variants as av

    bf16 = torch.bfloat16
    qs, kh, vh = av._heads(q, k, v, heads)
    hd = qs.shape[-1]
    dist = [0.0, 0.0, 0.0]
    for h in range(heads):
        s = qs[:, h].double() @ kh[:, h].double().transpose(-1, -2)
        d = torch.clamp_max(s, shift + 88.0) - shift
        p = torch.exp2(d)
        l = p.sum(-1, keepdim=True) + 1e-30
        pb = torch.exp2(d.to(bf16).double()).to(bf16).double()
        g = got[..., h * hd:(h + 1) * hd].double()
        for i, (pp, ll) in enumerate(((p, l), (p.to(bf16).double(), l),
                                      (pb, pb.sum(-1, keepdim=True)
                                       + 1e-30))):
            o = ((pp @ vh[:, h].double()) / ll).to(bf16).double()
            dist[i] += (g - o).abs().sum().item()
    return tuple(x / got.numel() for x in dist)


def overflow_inputs(B, L, D, gen, device="cuda"):
    """bf16 q, k, v (B, L, D) and the query rows `hot`: standard normal but
    in every OVERFLOW_EVERY-th query row, where q is OVERFLOW_GAIN times
    the key row of the same index. There each head's base-2 logit against
    that key is at least ~170 for any head dim (|k|^2 of about hd times
    hd^-0.5 log2(e) times the gain), above shift + 128 = 160, so T2 without
    its clamp overflows; elsewhere the logits stay within about 8 of 0."""
    import torch

    q, k, v = (torch.randn((B, L, D), generator=gen, device=device)
               for _ in range(3))
    hot = torch.zeros(L, dtype=torch.bool, device=device)
    hot[::OVERFLOW_EVERY] = True
    q[:, hot] = OVERFLOW_GAIN * k[:, hot]
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), hot


def nonfinite_heads(out, heads):
    """(B, L, heads) bool: the (image, row, head) whose output holds a
    value that is not finite."""
    B, L, D = out.shape
    return (~out.isfinite()).view(B, L, heads, D // heads).any(-1)


def chunk_precision(outs, q, k, v, heads, evals):
    """mean |got - bf16(o)| over got's elements, for each got of `outs`
    and each float64 evaluation o of `evals`, on the bf16 inputs (q
    pre-scaled and rounded as the kernels do), a head at a time. An
    evaluation (width, bf16_p) is the running-max softmax with m (from
    -1e30) updated once per `width` keys (None: every key at once, the
    exact row max): p = exp2(s - m), or bf16(exp2(bf16(s - m))) with
    bf16_p; l the sum of those p and O the sum of bf16(p) v, both rescaled
    by exp2(m - m_new) at each update; o = O / l. T3 at chunk bk is (bk,
    bf16_p), the halves (64, bf16_p), T1 (None, False), K13's pass (None,
    True). Returns dist[output][evaluation]."""
    import torch

    from diffusiontexturepainting_torch.ops import attention_variants as av

    bf16, f64 = torch.bfloat16, torch.float64
    qs, kh, vh = av._heads(q, k, v, heads)
    hd, lk = qs.shape[-1], kh.shape[2]
    dist = [[0.0] * len(evals) for _ in outs]
    for h in range(heads):
        s = qs[:, h].double() @ kh[:, h].double().transpose(-1, -2)
        vd = vh[:, h].double()
        for e, (width, bf16_p) in enumerate(evals):
            w = width or lk
            m = torch.full(s.shape[:-1] + (1,), -1e30, dtype=f64,
                           device=s.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(s.shape[:-1] + (hd,), dtype=f64,
                              device=s.device)
            for j in range(0, lk, w):
                sj = s[..., j:j + w]
                m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
                d = sj - m_new
                p = (torch.exp2(d.to(bf16).double()).to(bf16).double()
                     if bf16_p else torch.exp2(d))
                corr = torch.exp2(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(bf16).double() @ vd[:, j:j + w]
                m = m_new
            o = (acc / l).to(bf16).double()
            for i, got in enumerate(outs):
                g = got[..., h * hd:(h + 1) * hd].double()
                dist[i][e] += (g - o).abs().sum().item()
    return [[d / got.numel() for d in row] for row, got in zip(dist, outs)]


def chunk_probe_cases(lk, bkv):
    """The chunk probe's evaluations and, a case each, (T3's bk or None
    for T1, bf16_p, its own evaluation's index, the neighbours' indices):
    T3 at CHUNK_PROBE_BK with bf16 p against fp32 p, the tile's max and
    one chunk of every key; with fp32 p the same the other way round; at
    64 (the attn_arms path's chunk) against the tile's max and bf16 p; T1
    against bf16 p (K13's arithmetic) and the tile's max. bkv: the K/V
    tile at this shape, lk its keys (several chunks of CHUNK_PROBE_BK)."""
    c = CHUNK_PROBE_BK
    evals = [(c, True), (c, False), (bkv, True), (None, True), (bkv, False),
             (None, False), (64, False), (64, True)]
    at = {e: i for i, e in enumerate(evals)}
    cases = [(c, True, at[c, True],
              [at[c, False], at[bkv, True], at[None, True]]),
             (c, False, at[c, False],
              [at[c, True], at[bkv, False], at[None, False]]),
             (64, False, at[64, False], [at[bkv, False], at[64, True]]),
             (None, False, at[None, False], [at[None, True],
                                            at[bkv, False]])]
    assert lk % c == 0 and lk > c and bkv == 128
    return evals, cases


def attn_arms_phase(gen):
    """The softmax arms through the A/B entry point's functions at the
    1024^2/4 stamp's three UNet self-attention shapes, ARM_LAUNCHES calls of
    each arm a shape, with the counts set to 0 just before and read just
    after; each output against the attention() route's (K8/K2), T5 and T2
    bit for bit against T2 and T7 on T9's head-major grid; then the P
    precision probe on T9's, T7's and T2's outputs and T2 with bf16 p at
    the hd-160 shape, the chunk probe, and the clamp, underflow and
    overflow probes. Returns (launches, shapes)."""
    import torch

    from diffusiontexturepainting_torch.ops import attention
    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.ops import conv_variants as cv
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
            # T3 at the route's K/V tile with fp32 p is K8/K2's launch
            bkv = attention.sm90_plan(q.shape[-1] // heads, q.shape[1],
                                      q.shape[0] * heads)["bkv"]
            if not torch.equal(av.chunked_attention(q, k, v, heads, bk=bkv),
                               base):
                raise AssertionError(f"attn_arms: chunked_attention bk {bkv} "
                                     f"at {label} differs from the {route} "
                                     "route's bits")
            log(f"attn_arms: chunked_attention bk {bkv} (the {route} route's "
                f"K/V tile) at {label}: equal to the route bit for bit")
            # T5 is T2's safe launch on the split heads (one head, B*h
            # images, the same bucket), T6 that launch on the heads in
            # place, T8 T6's CTAs on the head-fastest grid, and T2's launch
            # that of T7's head-major probe
            t2 = outs["nomax_attention"]
            same = ("nomax_unpadded",) + IN_PLACE_ARMS
            if not (all(torch.equal(outs[name], t2) for name in same)
                    and torch.equal(av._nomax_allheads(q, k, v, heads,
                                                       head_major=True),
                                    t2)):
                raise AssertionError(
                    f"attn_arms: at {label} {', '.join(same)}, "
                    "nomax_attention (safe) and nomax_allheads on the "
                    "head-major grid are not one launch's bits")
            log(f"attn_arms: {', '.join(same)} at {label} equal to "
                "nomax_attention (safe) bit for bit, and nomax_attention to "
                "nomax_allheads on T9's head-major grid")
            for name, got in outs.items():
                err, tol = _err_tol(got, base)
                if not torch.isfinite(got).all() or not err <= tol:
                    raise AssertionError(f"attn_arms: {name} at {label}: "
                                         f"err {err:.3e} > tol {tol:.3e} "
                                         f"against {route}")
                log(f"attn_arms: {name} ({ARM_PATH_ROWS[name]}) at {label} "
                    f"{tuple(q.shape)}: max|diff| {err:.3e} against the "
                    f"{route} route (tol {tol:.3e}); err/tol {err / tol:.3f}")

        # P precision: T9's p enters P V unrounded (hi + lo), T7's and T2's
        # as bf16(p), T2's bf16 p is bf16(exp2(bf16(s - shift))); within
        # chip_smoke's tolerance they are one function, so each is held
        # nearer its own float64 evaluation than the other p's
        (label, _, _, _, heads), (q, k, v), outs = max(
            zip(shapes, inputs, firsts), key=lambda c: c[0][3] // c[0][4])
        evals = ("fp32-p", "bf16-p", "bf16-exp2")
        t2_bf16p = tool.row_call("nomax/bf16p", q, k, v, heads)
        for name, got, own, other in (
                ("pvt_attention", outs["pvt_attention"], 0, 1),
                ("nomax_allheads", outs["nomax_allheads"], 1, 0),
                ("nomax_attention", outs["nomax_attention"], 1, 2),
                ("nomax_attention bf16p", t2_bf16p, 2, 1)):
            dist = p_precision(got, q, k, v, heads)
            near = ", ".join(f"{dist[i]:.3e} to the {e} evaluation"
                             for i, e in enumerate(evals))
            if not P_PRECISION_MARGIN * dist[own] <= dist[other]:
                raise AssertionError(
                    f"attn_arms: P precision probe {name} at {label}: mean "
                    f"|diff| {near}")
            log(f"attn_arms: P precision probe {name} at {label} "
                f"{tuple(q.shape)}: mean|diff| {near} (its own, "
                f"{evals[own]}, {P_PRECISION_MARGIN:g}x nearer than "
                f"{evals[other]}, as it must)")
        del t2_bf16p

        # T3's chunk and p, T1's p: within chip_smoke's tolerance T3 at any
        # chunk with either p, the halves, K8/K2's online pass and T1 are
        # one function, so each output is held nearer its own float64
        # evaluation than each neighbour's, at the shortest shape with
        # several chunks of CHUNK_PROBE_BK keys
        (label, _, _, _, heads), (q, k, v), outs = min(
            (c for c in zip(shapes, inputs, firsts)
             if c[0][2] > CHUNK_PROBE_BK), key=lambda c: c[0][2])
        hd = q.shape[-1] // heads
        bkv = attention.sm90_plan(hd, q.shape[1], q.shape[0] * heads)["bkv"]
        evals, cases = chunk_probe_cases(k.shape[1], bkv)
        gots = [outs["sublane_attention"] if bk is None
                else outs["chunked_attention"] if bk == 64
                else av.chunked_attention(q, k, v, heads, bk=bk,
                                          bf16_p=bf16_p)
                for bk, bf16_p, _, _ in cases]
        dists = chunk_precision(gots, q, k, v, heads, evals)
        for (bk, bf16_p, own, others), dist in zip(cases, dists):
            name = ("sublane_attention" if bk is None else
                    f"chunked_attention bk {bk}" + (" bf16p" if bf16_p
                                                    else ""))
            near = {str(evals[i]): f"{dist[i]:.3e}" for i in others}
            if not all(P_PRECISION_MARGIN * dist[own] <= dist[i]
                       for i in others):
                raise AssertionError(
                    f"attn_arms: chunk probe {name} at {label}: mean |diff| "
                    f"{dist[own]:.3e} to its own evaluation {evals[own]}, "
                    f"to the neighbours {near}")
            log(f"attn_arms: chunk probe {name} at {label} "
                f"{tuple(q.shape)}: mean|diff| {dist[own]:.3e} to its own "
                f"evaluation {evals[own]} (width, bf16 p), to the "
                f"neighbours {near} (each {P_PRECISION_MARGIN:g}x farther, "
                "as it must)")
        del inputs, firsts, base, gots

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

        # overflow: base-2 logits above shift + 128 in the hot rows. T2
        # without its clamp overflows there as on the TPU (p = +inf, l =
        # +inf, a NaN row), with fp32 or bf16 p; its clamped forms do not
        q, k, v, hot = overflow_inputs(2, 1100, 320, gen)
        for row in ("nomax", "nomax/bf16p"):
            got = nonfinite_heads(tool.row_call(row, q, k, v, 8), 8)
            want = nonfinite_heads(tool.row_call(row, q, k, v, 8,
                                                 plain=True), 8)
            if not (torch.equal(got, want) and want.any()
                    and not want[:, ~hot].any()):
                raise AssertionError(
                    f"attn_arms: overflow probe {row}: {int(got.sum())} "
                    f"non-finite (image, row, head), the plain version "
                    f"{int(want.sum())}, {int(got.ne(want).sum())} apart")
            log(f"attn_arms: overflow probe (2, 1100, 320) {row}: "
                f"{int(got.sum())} of {got.numel()} (image, row, head) "
                "non-finite, exactly the plain version's, all in the hot "
                "rows")
        for row in ("nomax-safe", "nomax-unpadded"):
            got = tool.row_call(row, q, k, v, 8)
            err, tol = _err_tol(got, tool.row_call(row, q, k, v, 8,
                                                   plain=True))
            if not (torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f"attn_arms: overflow probe {row}: "
                                     f"non-finite or {err:.3e} > {tol:.3e}")
            log(f"attn_arms: overflow probe (2, 1100, 320) {row}: finite, "
                f"{err:.3e} from its plain version (tol {tol:.3e})")
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
    from diffusiontexturepainting_torch.ops import conv_variants as cv
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
    from diffusiontexturepainting_torch.ops import conv_variants as cv

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
            # K11 on the image, a weight whose Cout is off 8 (the VAE
            # decoder's head) zero-padded as K5's is, the padding dropped
            wk, zero = gn_conv.pad_cout(
                w, torch.zeros(w.shape[3], dtype=x.dtype, device="cuda"))
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
                            x.reshape(1, B * H, W, cin), wk,
                            zero)[..., :w.shape[3]],
                        "K11 on the image")
                log(f"conv_arms: {TAPS} {read} {tuple(xwin.shape)}: "
                    f"max|diff| {msg}")
    return launches, shapes_seen


def procedural_texture(i, size):
    """A seeded (size, size, 3) uint8 texture: three interfering sinusoid
    fields at texture i's own frequencies, plus noise."""
    import numpy as np

    rng = np.random.default_rng(1000 + i)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    f = rng.uniform(0.02, 0.2, (3, 2))
    ph = rng.uniform(0, 6.3, 3)
    base = np.stack([128 + 90 * np.sin(x * f[c, 0] + ph[c])
                     * np.cos(y * f[c, 1] - ph[c]) for c in range(3)], -1)
    noise = rng.normal(0, 12, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def train_args(tex, out, *extra, batch=2, mesh=1):
    return ["--images_path", tex, "--output_dir", out, "--resolution",
            str(RES), "--train_batch_size", str(batch),
            "--checkpointing_steps", "2", "--mixed_precision", "bf16",
            "--validation_epochs", "0", "--log_every", "1", "--device",
            "cuda", "--mesh_data", str(mesh), *extra]


# the JPEG fixtures (Pillow-written; tests/test_torch_port_jpeg.py holds
# their manifest to Pillow) and the two whose decode the train phase times
JPEG_FIXTURES = ("tests", "fixtures", "jpeg")
JPEG_TIMED = ("baseline_420_640.jpg", "progressive_640.jpg")
JPEG_REPS = 3


def jpeg_fixtures():
    """(directory, manifest) of the committed JPEG fixtures."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(here, *JPEG_FIXTURES)
    with open(os.path.join(directory, "manifest.json")) as f:
        return directory, json.load(f)


def check_jpeg_fixtures(tex):
    """Decodes every JPEG fixture on the host, holds the sha256 of each
    result to the manifest's (Pillow's decode) and copies the files into
    `tex`; returns {name: best decode ms} (JPEG_REPS runs of the timed
    ones, one of the others)."""
    import hashlib
    import os
    import shutil

    from diffusiontexturepainting_torch.training import image_io

    directory, manifest = jpeg_fixtures()
    decode_ms = {}
    for name, want in sorted(manifest.items()):
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(JPEG_REPS if name in JPEG_TIMED else 1):
            tic = time.perf_counter()
            rgb = image_io.decode_image(data)
            times.append(time.perf_counter() - tic)
        digest = hashlib.sha256(rgb.tobytes()).hexdigest()
        if digest != want["sha256"] or list(rgb.shape) != want["shape"]:
            raise AssertionError(f"train: JPEG {name}: {rgb.shape} sha256 "
                                 f"{digest}, the manifest (Pillow) "
                                 f"{want['shape']} {want['sha256']}")
        decode_ms[name] = 1e3 * min(times)
        shutil.copy(os.path.join(directory, name), os.path.join(tex, name))
    return decode_ms


def train_main(label, argv, report=None):
    """training.train.main(argv) in this process: (export dir, its step
    records, seconds); every serving counter held still across it, every
    step's loss and grad_norm finite. `report`: main's."""
    from diffusiontexturepainting_torch.training import train

    before = {c.name: c.launches for c in counters()}
    tic = time.perf_counter()
    export, steps = train.main(argv, report=report)
    secs = time.perf_counter() - tic
    after = {c.name: c.launches for c in counters()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved:
        raise AssertionError(f"train: {label}: serving kernels launched "
                             f"during the train steps: {moved}")
    for h in steps:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"train: {label}: step {h}")
        log(f"train: {label}: step {h['step']} loss {h['loss']:.5f} "
            f"grad_norm {h['grad_norm']:.5f}")
    return export, steps, secs


def up_factors_nonzero(ckpt_dir, step):
    """Every LoRA up factor of checkpoint `step` has a non-zero entry."""
    import os

    import torch

    state = torch.load(os.path.join(ckpt_dir, str(step), "state.pt"),
                       map_location="cpu", weights_only=True)
    ups = {k: v for k, v in state["params"].items() if k.endswith("/up")}
    zero = [k for k, v in ups.items() if not bool(v.abs().max() > 0)]
    if not ups or zero:
        raise AssertionError(f"train: checkpoint {step}: {len(zero)} of "
                             f"{len(ups)} LoRA up factors are zero")
    return len(ups)


def time_train_steps(trainer, dataset, batch_size, reps=2):
    """One batch prepared on this thread, one warm step, then `reps` timed
    steps on it: (host batch prep s, [step s], peak bytes). Running out of
    memory fails the phase."""
    import torch

    from diffusiontexturepainting_torch.training.trainer import (
        batch_to_device)

    it = dataset.batches(batch_size)
    tic = time.perf_counter()
    host = next(it)
    prep_s = time.perf_counter() - tic
    batch = batch_to_device(host, "cuda")
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            tic = time.perf_counter()
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - tic)
        if not (math.isfinite(float(m["loss"]))
                and math.isfinite(float(m["grad_norm"]))):
            raise AssertionError(f"train: batch {batch_size}: not finite")
        return prep_s, times, torch.cuda.max_memory_allocated()
    finally:
        del batch
        release()


def tiny_step_card_vs_cpu():
    """One fp32 step of the tiny models on the card (no TF32 in cuDNN or
    matmul, cuDNN deterministic: set here, the previous settings restored
    after) and on the CPU, from the same weights, factors, batch and
    draws: (loss, grad_norm) of each, the trainables' largest difference
    and the share outside rtol 1e-4 / atol 1e-6."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.models.lora import init_lora_params
    from diffusiontexturepainting_torch.training import train, trainer as tr
    from diffusiontexturepainting_torch.weights.random_init import (
        complete_weights)

    cfg = tr.TrainConfig(resolution=64, seed=3)
    built = {d: train.build_models(True, d, torch.float32)
             for d in ("cpu", "cuda")}
    weights = {n: {k: v.cpu() for k, v in sd.items()} for n, sd in
               complete_weights(built["cpu"], None, 3).items()}
    lora = init_lora_params(built["cpu"]["unet"], cfg.lora_rank,
                            torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    image = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mask = (rng.random((2, 64, 64, 1)) < 0.4).astype(np.float32)
    s = built["cpu"]["patch_encoder"].cfg.clip.image_size
    batch = {"image": image, "mask": mask, "masked_image": image * (1 - mask),
             "cond_patches": rng.standard_normal((2, 14, s, s, 3)).astype(
                 np.float32), "drop_cond": np.array([0.0, 1.0], np.float32)}
    draws = tr.make_draws(2, (8, 8), cfg.num_train_timesteps,
                          torch.Generator().manual_seed(5), "cpu")
    out = {}
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = (True, False,
                                                                False)
    try:
        for dev, models in built.items():
            for name, m in models.items():
                m.load_state_dict(weights[name])
            t = tr.Trainer(cfg, models, weights, dev, torch.float32,
                           lora={n: {k: v.to(dev) for k, v in f.items()}
                                 for n, f in lora.items()})
            m = t.train_step(tr.batch_to_device(batch, dev),
                             {k: v.to(dev) for k, v in draws.items()})
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {k: v.detach().cpu() for k, v in t.params.items()})
    finally:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved
    worst, loose, total = 0.0, 0, 0
    for k, want in out["cpu"][2].items():
        diff = (out["cuda"][2][k] - want).abs()
        worst = max(worst, float(diff.max()))
        loose += int((diff > 1e-6 + 1e-4 * want.abs()).sum())
        total += want.numel()
    return out["cuda"][:2], out["cpu"][:2], worst, loose, total, cfg


def train_phase():
    """Training at full SD-1.5 width on the card (random frozen towers,
    bf16): a folder of textures written with the port's PNG writer,
    training.train.main for 4 steps with checkpoints, resumed from the
    latest to step 6, the serving counters still throughout; the validation
    grid on the resumed weights (its stamp's kernels launched); the export
    served through the request handler; a tiny fp32 step against the CPU;
    the step's time and memory at batch 2, and train.main's samples/s at
    32 over E2E_STEPS steps. Returns the numbers."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    from diffusiontexturepainting_torch.serving import wire
    from diffusiontexturepainting_torch.training import image_io, train
    from diffusiontexturepainting_torch.training.dataset import (
        AugmentedTextures)

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dtp_train_")
    try:
        tex, out = os.path.join(root, "textures"), os.path.join(root, "run")
        os.makedirs(tex)
        for i in range(8):
            image_io.write_png(os.path.join(tex, f"tex{i}.png"),
                               procedural_texture(i, 512))
        decode_s = {}
        for kind in (0, None):  # unfiltered, and each row's filter picked
            data = image_io.encode_png(procedural_texture(0, 512), kind)
            tic = time.perf_counter()
            for _ in range(5):
                image_io.decode_png(data)
            decode_s[kind] = (time.perf_counter() - tic) / 5
        log(f"train: PNG decode of a 512^2 RGB texture on the host: "
            f"{1e3 * decode_s[None]:.1f} ms with the writer's adaptive "
            f"filters (as the textures here), {1e3 * decode_s[0]:.1f} ms "
            "unfiltered")
        jpeg_ms = check_jpeg_fixtures(tex)
        log(f"train: every JPEG fixture decoded on the host to its "
            f"manifest's sha256 (Pillow's decode), ms: "
            + ", ".join(f"{k} {v:.1f}" for k, v in jpeg_ms.items())
            + f"; the 640^2 4:2:0 baseline {jpeg_ms[JPEG_TIMED[0]]:.1f} ms "
            f"and progressive {jpeg_ms[JPEG_TIMED[1]]:.1f} ms (best of "
            f"{JPEG_REPS}), beside the PNG's above ({CARD[0]})")
        # the textures read while main trains, by extension
        reads = Counter()
        read = image_io.read_image_rgb

        def counted_read(path):
            reads[os.path.splitext(str(path))[1].lower()] += 1
            return read(path)

        image_io.read_image_rgb = counted_read
        try:
            _, steps, secs = train_main("4 steps", train_args(
                tex, out, "--max_train_steps", "4"))
            if [h["step"] for h in steps] != [1, 2, 3, 4]:
                raise AssertionError(f"train: steps {steps}")
            ckpt = os.path.join(out, "checkpoints")
            n_up = up_factors_nonzero(ckpt, 2)
            log(f"train: 4 steps at full width, {RES}^2, batch 2, bf16 in "
                f"{secs:.1f} s with checkpoints 2 and 4 and the export; all "
                f"{n_up} LoRA up factors non-zero at step 2; serving "
                "counters still")
            export, steps, secs = train_main("resumed", train_args(
                tex, out, "--max_train_steps", "6",
                "--resume_from_checkpoint", "latest"))
        finally:
            image_io.read_image_rgb = read
        if not reads[".jpg"] or not reads[".png"]:
            raise AssertionError(f"train: textures read by kind: "
                                 f"{dict(reads)}; JPEG and PNG expected")
        log(f"train: textures read while training, by kind: {dict(reads)}")
        if [h["step"] for h in steps] != [5, 6]:
            raise AssertionError(f"train: resumed run's steps {steps}")
        if train.checkpoint_steps(ckpt) != [2, 4, 6]:
            raise AssertionError(f"train: checkpoints "
                                 f"{train.checkpoint_steps(ckpt)}")
        up_factors_nonzero(ckpt, 6)
        log(f"train: resumed from step 4 to 6 in {secs:.1f} s; checkpoints "
            f"{train.checkpoint_steps(ckpt)}")

        # (c) the validation grid on the resumed weights, called directly
        args = train.build_argparser().parse_args(train_args(
            tex, out, "--resume_from_checkpoint", "latest"))
        run = train.prepare(args)
        if run.trainer.step != 6:
            raise AssertionError(f"train: prepare resumed at "
                                 f"{run.trainer.step}")
        for c in counters():
            c.reset()
        tic = time.perf_counter()
        grid = train._validation_grid(6, run.trainer, run.models,
                                      run.dataset)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - tic
        launched = {c.name: c.launches for c in counters() if c.launches}
        if grid.shape != (RES, 4 * RES, 3) or grid.dtype != np.uint8:
            raise AssertionError(f"train: grid {grid.shape} {grid.dtype}")
        if grid[:, 3 * RES:].std() < 1.0:
            raise AssertionError("train: the grid's result panel is flat")
        for name in ("conv3x3", "upsample2x_conv3x3", "flash_attention"):
            if not launched.get(name):
                raise AssertionError(f"train: the validation stamp launched "
                                     f"no {name}: {launched}")
        log(f"train: validation grid {grid.shape} uint8 in {val_s:.1f} s "
            f"(DDIM 20 at {RES}^2); launches {launched}")

        # (f) one step's time and memory at batch 2, and train.main end to
        # end at the JAX default 32 (which fits: 25 GiB of 80): the
        # prefetch thread preparing batches while the steps run, a log
        # line (and its read of the loss) every step. A dataset of 32
        # textures, the first 8 those trained on.
        card = CARD[0]
        timing = {}
        many = os.path.join(root, "textures32")
        shutil.copytree(tex, many)
        for i in range(8, 32):
            image_io.write_png(os.path.join(many, f"tex{i}.png"),
                               procedural_texture(i, 512))
        data32 = AugmentedTextures(many, size=RES, seed=0)
        prep_s, times, peak = timing[2] = time_train_steps(
            run.trainer, data32, 2)
        step_s = min(times)
        log(f"train: batch 2 at {RES}^2, full width, bf16: "
            f"{step_s:.3f} s/step (of "
            f"{', '.join(f'{t:.3f}' for t in times)}), "
            f"{2 / step_s:.2f} samples/s, host batch prep "
            f"{prep_s:.2f} s, peak {peak / 2**30:.2f} GiB ({card})")
        del run
        release()
        _, steps, secs = train_main("end to end", train_args(
            many, os.path.join(root, "run32"), "--max_train_steps",
            str(E2E_STEPS), "--checkpointing_steps", "500", batch=32))
        ends = [h["time"] for h in steps]
        window = ends[-1] - ends[0]
        timing["end_to_end"] = (len(ends) - 1) * 32 / window
        log(f"train: end to end, train.main at batch 32, {RES}^2, full "
            f"width, bf16: steps 2-{E2E_STEPS} in {window:.2f} s (each "
            f"{', '.join(f'{b - a:.2f}' for a, b in zip(ends, ends[1:]))}"
            f" s), {timing['end_to_end']:.2f} samples/s; main {secs:.1f} "
            f"s with the build, the first batch and the export ({card})")

        # (d) the export served through the request handler
        R, handle = wire.RequestType, wire.handle_request_bytes
        tic = time.perf_counter()
        served = TorchConditionalInpainter(RES, device="cuda",
                                           checkpoint_dir=export)
        brush, canvas = requests()
        check_reply(handle(served, wire.encode_request(
            R.NEW_BRUSH_IMAGE, brush, **settings(FEW_STEPS))),
            R.RETURN_PREVIEW)
        check_reply(handle(served, wire.encode_request(
            R.NEW_STAMP, canvas, **settings(FEW_STEPS))), R.RETURN_STAMP,
            canvas=canvas)
        log(f"train: the export served a {RES}^2 / {FEW_STEPS}-step "
            f"NEW_STAMP through the request handler "
            f"({time.perf_counter() - tic:.1f} s with the load)")
        del served
        release()

        # (e) a tiny fp32 step on the card against the CPU
        card_m, cpu_m, worst, loose, total, cfg = tiny_step_card_vs_cpu()
        log(f"train: tiny fp32 step: card loss {card_m[0]:.7f} grad_norm "
            f"{card_m[1]:.7f}; CPU {cpu_m[0]:.7f} / {cpu_m[1]:.7f}; "
            f"trainables max|diff| {worst:.3e}, {loose} of {total} outside "
            "rtol 1e-4 / atol 1e-6")
        for a, b, what in zip(card_m, cpu_m, ("loss", "grad_norm")):
            if abs(a - b) > 1e-6 + 1e-4 * abs(b):
                raise AssertionError(f"train: tiny fp32 {what} {a} on the "
                                     f"card, {b} on the CPU")
        if worst > 0.5 * cfg.learning_rate or loose > 5e-3 * total:
            raise AssertionError(f"train: tiny fp32 trainables differ: "
                                 f"max {worst}, {loose} of {total}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"train: phase done in {time.perf_counter() - t_phase:.1f} s")
    return timing


# the ddp phase: train.main --mesh_data 2 at full width, 256^2, bf16, a
# global batch of DDP_BATCH for DDP_STEPS steps, against --mesh_data 1.
# In bf16 the two runs' UNet evaluations (batch 4 against 2 + 2) round
# differently, so each step's loss is held within DDP_LOSS_RTOL and its
# grad_norm within DDP_GNORM_RTOL; Adam's update of an element is at most
# about lr in size (|m_hat| / sqrt(v_hat) <= 1.0015 over two steps), so
# after DDP_STEPS steps no element may differ by more than DDP_MAX_LR lr,
# and at most DDP_FLIP_SHARE of the elements by more than lr / 2 (the
# elements whose gradient is near zero, where the rounding can flip an
# update's sign).
DDP_STEPS, DDP_BATCH = 2, 4
DDP_LOSS_RTOL, DDP_GNORM_RTOL = 2e-2, 5e-2
DDP_MAX_LR = 2 * DDP_STEPS * 1.0015
DDP_FLIP_SHARE = 0.05
DDP_TIMEOUT = 480  # seconds the two ranks may take before they are killed


def ddp_phase(ranks=2):
    """Data-parallel training on the card: training.train.main with
    --mesh_data `ranks` (on one card the ranks share cuda:0 over gloo; on
    as many cards as ranks each rank has its own card over NCCL), then the
    same argv with --mesh_data 1; returns the numbers."""
    import os
    import shutil
    import tempfile

    import torch

    from diffusiontexturepainting_torch.training import image_io, train

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dtp_ddp_")
    cards = torch.cuda.device_count()
    backend = "gloo" if cards < ranks else None
    case = (f"gloo, {ranks} ranks sharing {cards} card(s)" if cards < ranks
            else f"NCCL, a card a rank ({cards} visible)")
    try:
        tex = os.path.join(root, "textures")
        os.makedirs(tex)
        for i in range(4):
            image_io.write_png(os.path.join(tex, f"tex{i}.png"),
                               procedural_texture(i, 512))
        check_jpeg_fixtures(tex)
        steps = ["--max_train_steps", str(DDP_STEPS)]
        two, one = os.path.join(root, "two"), os.path.join(root, "one")
        before = {c.name: c.launches for c in counters()}
        report = {}
        tic = time.perf_counter()
        _, hist2 = train.main(train_args(tex, two, *steps, batch=DDP_BATCH,
                                         mesh=ranks),
                              backend=backend, timeout=DDP_TIMEOUT,
                              report=report)
        secs2 = time.perf_counter() - tic
        if {c.name: c.launches for c in counters()} != before:
            raise AssertionError("ddp: serving counters moved here")
        reports = report["ranks"]
        log(f"ddp: --mesh_data {ranks} ran {case}: "
            + "; ".join(f"rank {r['rank']} on {r['device']} over "
                        f"{r['backend']}" for r in reports))
        digests = {d for r in reports for d in r["digests"]}
        if [r["rank"] for r in reports] != list(range(ranks)) or len(
                digests) != 1 or any(len(r["digests"]) != ranks
                                     for r in reports):
            raise AssertionError(f"ddp: the ranks' trainables differ: "
                                 f"{reports}")
        moved = [r["launches"] for r in reports if r["launches"]]
        if moved:
            raise AssertionError(f"ddp: serving kernels launched in the "
                                 f"ranks: {moved}")
        if [r["exported"] for r in reports] != [True] + [False] * (
                ranks - 1) or [r["checkpoints"] for r in reports] != [
                    [DDP_STEPS]] + [[]] * (ranks - 1):
            raise AssertionError(f"ddp: writers {reports}")
        exports = [x for x in os.listdir(two) if x.startswith("export")]
        npz = sorted(os.listdir(os.path.join(two, "export")))
        if exports != ["export"] or len(npz) != 4 or train.checkpoint_steps(
                os.path.join(two, "checkpoints")) != [DDP_STEPS]:
            raise AssertionError(f"ddp: outputs {exports} {npz}")
        for h in hist2:
            if not (math.isfinite(h["loss"]) and
                    math.isfinite(h["grad_norm"])):
                raise AssertionError(f"ddp: step {h}")
        log(f"ddp: {ranks} ranks, {DDP_STEPS} steps at full width, {RES}^2, "
            f"global batch {DDP_BATCH}, bf16 in {secs2:.1f} s with the "
            f"spawn, the builds, checkpoint {DDP_STEPS} and the export; "
            f"the ranks' trainables bitwise equal (sha256 "
            f"{next(iter(digests))[:16]}..., all-gathered); one export "
            f"({', '.join(npz)}), written by rank 0 alone; no serving "
            f"kernel launched in either rank ({CARD[0]})")

        report1 = {}
        _, hist1, secs1 = train_main("ddp reference, one rank", train_args(
            tex, one, *steps, batch=DDP_BATCH, mesh=1), report=report1)
        for a, b in zip(hist1, hist2):
            log(f"ddp: step {a['step']}: loss {b['loss']:.6f} on {ranks} "
                f"ranks, "
                f"{a['loss']:.6f} on 1; grad_norm {b['grad_norm']:.6f} / "
                f"{a['grad_norm']:.6f}")
            if abs(b["loss"] - a["loss"]) > DDP_LOSS_RTOL * abs(a["loss"]) \
                    or abs(b["grad_norm"] - a["grad_norm"]) > (
                        DDP_GNORM_RTOL * abs(a["grad_norm"])):
                raise AssertionError(f"ddp: step {a['step']}: {ranks} "
                                     f"ranks {b}, 1 rank {a}")
        states = [torch.load(os.path.join(d, "checkpoints", str(DDP_STEPS),
                                          train.CHECKPOINT_FILE),
                             map_location="cpu", weights_only=True)
                  for d in (two, one)]
        lr = train.build_argparser().parse_args(
            train_args(tex, one)).learning_rate
        worst, flips, total = 0.0, 0, 0
        for k, want in states[1]["params"].items():
            diff = (states[0]["params"][k] - want).abs()
            worst = max(worst, float(diff.max()))
            flips += int((diff > 0.5 * lr).sum())
            total += want.numel()
        walls = [[b["time"] - a["time"] for a, b in zip(h, h[1:])]
                 for h in (hist2, hist1)]
        log(f"ddp: trainables after {DDP_STEPS} steps, {ranks} ranks "
            f"against 1: "
            f"max|diff| {worst:.3e} ({worst / lr:.3f} lr), {flips} of "
            f"{total} ({flips / total:.5f}) beyond lr/2; one rank "
            f"{secs1:.1f} s; a step after the first "
            f"{', '.join(f'{w:.3f}' for w in walls[0])} s on {ranks} "
            f"ranks, "
            f"{', '.join(f'{w:.3f}' for w in walls[1])} s on 1 "
            f"({CARD[0]})")
        if worst > DDP_MAX_LR * lr + 1e-7 or flips > DDP_FLIP_SHARE * total:
            raise AssertionError(f"ddp: {ranks} ranks against 1: max {worst}, "
                                 f"{flips} of {total} beyond lr/2")
        model_axis = model_axis_run(tex, root, steps, one, hist1, report1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"ddp: phase done in {secs:.1f} s")
    return {"case": case, "ranks_s": secs2, "one_rank_s": secs1,
            "max_diff": worst, "flip_share": flips / total,
            "step_walls": walls, "model_axis": model_axis}


# --- the multi-card paths (parallel/): each on distinct cards where the
# machine has them, else on cuda:0 repeated, the case logged


def mesh_cards(n):
    """(n devices, the case): cuda:0 .. cuda:n-1 where n cards are
    visible, else cuda:0 n times."""
    import torch

    cards = torch.cuda.device_count()
    if cards >= n:
        return [f"cuda:{i}" for i in range(n)], f"{n} distinct cards"
    return ["cuda:0"] * n, (f"cuda:0 repeated {n} times ({cards} card(s) "
                            "visible)")


def cfg_expected(model, res, steps):
    """{kernel: launches} of one CFG-sharded stamp of `model`: each model
    call three batch-1 UNet evals (a branch a card), the VAE encode and
    decode once (expected_launches counts a call's batch-3 eval once)."""
    lat = res // 8
    vae = Counter()
    for part in ("encoder", "decoder"):
        m = getattr(model, f"vae_{part}")
        vae.update(vae_launches(model.config, m.cfg, lat, part,
                                next(m.parameters()).dtype))
    out = {name: 0 for name in SOURCES}
    for (name, _), n in expected_launches(model, res, steps).items():
        out[name] += n
    return {name: 3 * (n - vae[name]) + vae[name]
            for name, n in out.items()}


def branchwise(fn):
    """fn (a UNet call on the CFG triple batch) a branch at a time, each
    at batch 1, eagerly on fn's card: the cfg phase's oracle."""
    import torch

    def call(sample, t, ctx, *cache):
        B = sample.shape[0] // 3
        outs = [fn(sample[i * B:(i + 1) * B], t[i * B:(i + 1) * B],
                   ctx[i * B:(i + 1) * B], *(c[i] for c in cache))
                for i in range(3)]
        if isinstance(outs[0], tuple):
            return (torch.cat([o[0] for o in outs]),
                    tuple(o[1] for o in outs))
        return torch.cat(outs)

    return call


def cfg_oracle(model, res, steps, counter, interval=1, canvas=None):
    """The composited stamp `model` serves at request `counter` on
    `canvas` (run_path's by default), its UNet evaluated a branch at a
    time on the lead card, eagerly, no launch counted."""
    import torch

    from diffusiontexturepainting_torch._cuda import LaunchCounter
    from diffusiontexturepainting_torch.pipeline.inpaint import make_stamp_fn

    u = model.unet
    stamp = make_stamp_fn(branchwise(u), model.vae_encoder,
                          model.vae_decoder, steps,
                          model.vae_encoder.cfg.scaling_factor,
                          model.config.scheduler,
                          deep_cache_interval=interval,
                          unet_full=branchwise(u.forward_full),
                          unet_shallow=branchwise(u.forward_shallow))
    if canvas is None:
        canvas = requests(res)[1]
    s = settings(steps, res)
    enc, init, noise = model.draws(counter, res, steps)
    with LaunchCounter.diverted():
        _, comp = stamp(torch.from_numpy(canvas)[None].to(model.device),
                        model._brush, model._cond, model._uncond, enc, init,
                        s["cfg_weight"], s["tg_weight"], s["tg_steps"],
                        s["context_pad"], noise)
    return comp.cpu().numpy()


def check_cfg_counts(label, model, res, steps, launches, n):
    want = cfg_expected(model, res, steps)
    for name, per in want.items():
        if launches[name] != n * per:
            raise AssertionError(f"{label}: {name}: {launches[name]} "
                                 f"launches in {n} stamps, three batch-1 "
                                 f"UNets a call give {n * per}")
    log(f"{label}: each kernel launched as three batch-1 UNet evals a "
        f"model call and one VAE encode and decode give, in {n} stamps: "
        + ", ".join(f"{k} {launches[k]}" for k in want if launches[k]))


def against_ordinary(label, got, ordinary, what):
    diff = abs(got.astype(int) - ordinary.astype(int))
    log(f"{label}: against {what}: mean |diff| {diff.mean():.4f} u8 "
        f"levels, max {diff.max()}, {(diff == 0).mean():.4f} exact")
    if not (diff.mean() <= SELF_MEAN_DIFF and diff.max() <= SELF_MAX_DIFF):
        raise AssertionError(f"{label}: {diff.mean():.3f} levels (max "
                             f"{diff.max()}) from {what}, above "
                             f"{SELF_MEAN_DIFF} (max {SELF_MAX_DIFF})")


def cfg_phase(weights, ordinary, ordinary_first):
    """--mesh model=3 (parallel/cfg_shard.py) at full width: the model on
    three cards (or cuda:0 three times), through the handler at 256^2/20
    (run_path: a brush, three stamps, a replay byte-equal), a DeepCache-2
    stamp at 256^2/20 and a session STAMP_AT at 256^2/4. Each stamp is
    byte-equal to the same stamp with its UNet evaluated a branch at a time
    on cuda:0 (cfg_oracle), within SELF_MEAN_DIFF / SELF_MAX_DIFF of the
    ordinary model's (`ordinary`, the default path's model, and its first
    stamp), and each kernel's launches are three batch-1 UNet evals a
    model call (cfg_expected). Returns the handler run's path record."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.parallel.mesh import make_cfg_mesh
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    t_phase = time.perf_counter()
    devices, case = mesh_cards(3)
    model = TorchConditionalInpainter(
        resolution=RES, device="cuda", weights=weights,
        cfg_mesh=make_cfg_mesh(3, devices))
    log(f"cfg: --mesh model=3 on {case}: branches on {devices}, "
        f"{len(model.cfg_unets.replicas)} UNet replica(s); built in "
        f"{model.init_seconds:.1f} s")
    first, path_launches, shapes, n = run_path("cfg", model, STEPS, RES)
    check_cfg_counts("cfg", model, RES, STEPS, path_launches, n)
    want = cfg_oracle(model, RES, STEPS, 2)
    compare_stamps("cfg", first, want, "the CFG-sharded model and its UNet "
                   "a branch at a time on cuda:0", exact=True)
    against_ordinary("cfg", first, ordinary_first,
                     "the ordinary model's first stamp")
    for kind, engine in model.cfg_unets.engines.items():
        log(f"cfg: {kind}: branch programs "
            + ", ".join(sorted({k[1] for k in engine.programs
                                if k[0] == "cfg"})))

    # DeepCache 2 at 256^2/20
    spec = model.config.deep_cache_interval
    for m in (model, ordinary):
        m.set_deep_cache(2)
    try:
        first_stamp_at(model, STEPS)  # captures full and shallow
        for c in counters():
            c.reset()
        got = first_stamp_at(model, STEPS)
        launches = {c.name: c.launches for c in counters()}
        check_cfg_counts("cfg DeepCache 2", model, RES, STEPS, launches, 1)
        compare_stamps("cfg DeepCache 2", got,
                       cfg_oracle(model, RES, STEPS, 2, interval=2),
                       "the CFG-sharded model and its UNet a branch at a "
                       "time", exact=True)
        against_ordinary("cfg DeepCache 2", got,
                         first_stamp_at(ordinary, STEPS),
                         "the ordinary model at DeepCache 2")
    finally:
        for m in (model, ordinary):
            m.set_deep_cache(spec)

    # a session STAMP_AT at 256^2/4
    blank = np.zeros((RES, 2 * RES, 4), np.uint8)
    crops = []
    for m in (model, ordinary):
        m.begin_session(blank)
        m.request_counter = 40
        for c in counters():
            c.reset()
        crops.append(m.stamp_at(0, 0, return_pixels=True,
                                **settings(FEW_STEPS)))
        if m is model:
            check_cfg_counts("cfg session", model, RES, FEW_STEPS,
                             {c.name: c.launches for c in counters()}, 1)
        m.end_session()
    compare_stamps("cfg session", crops[0],
                   cfg_oracle(model, RES, FEW_STEPS, 41,
                              canvas=blank[:, :RES].copy()),
                   "a session STAMP_AT and its UNet a branch at a time",
                   exact=True)
    against_ordinary("cfg session", crops[0], crops[1],
                     "the ordinary model's STAMP_AT")
    walls = {}
    for name, m in (("cfg", model), ("one card", ordinary)):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(3):
            first_stamp_at(m, STEPS)
        walls[name] = (time.perf_counter() - tic) / 3 * 1e3
    log(f"cfg: a 256^2/20 stamp through the handler, {walls['cfg']:.1f} "
        f"ms wall on {case}, {walls['one card']:.1f} ms on one card "
        f"({CARD[0]})")
    del model
    release()
    log(f"cfg: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=path_launches, shapes=shapes, stamps=n,
                steps=STEPS, res=RES)


def data_mesh_phase(model):
    """--mesh data=2 (serving/parallel_model.py) on two cards (or cuda:0
    twice): the batched phase's batch of four at 256^2/20 as two shares of
    two, each byte-equal to that pair batched on one card, each kernel
    launched as two batches of two launch it; then two stroke sessions,
    pinned to the two slots, painting at once from two threads, each
    canvas byte-equal to its stamps replayed one at a time on the model at
    their counters."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving.parallel_model import (
        make_parallel_service)

    t_phase = time.perf_counter()
    devices, case = mesh_cards(2)
    one = make_parallel_service(RES, "data=1", max_batch=BATCH, model=model)
    two = make_parallel_service(RES, "data=2", max_batch=BATCH, model=model,
                                devices=devices)
    rng = np.random.default_rng(7)
    sessions = [one.new_session() for _ in range(BATCH)]
    for s in sessions:
        s.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    payloads = batched_payloads(one, sessions, RES, STEPS)
    key = (RES, STEPS)
    two._run_batch(key, payloads)  # each card's batch-of-2 program
    torch.cuda.synchronize()
    for c in counters():
        c.reset()
    tic = time.perf_counter()
    got = two._run_batch(key, payloads)
    wall = time.perf_counter() - tic
    launches = {c.name: c.launches for c in counters()}
    split = {c.name: c.split for c in counters()}
    per = expected_per_stamp(model, RES, STEPS)
    for name, n in per.items():
        if launches[name] != 2 * n + split[name]:
            raise AssertionError(f"data_mesh: {name}: {launches[name]} "
                                 f"launches, two shares give {2 * n} + "
                                 f"{split[name]} split")
    tic = time.perf_counter()
    want = one._run_batch(key, payloads[:2]) + one._run_batch(key,
                                                              payloads[2:])
    wall_one = time.perf_counter() - tic
    for k, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"data_mesh: request {k} of the 2 + 2 "
                                 "batch differs from its pair on one card")
    log(f"data_mesh: --mesh data=2 on {case}: a batch of {BATCH} at "
        f"{RES}^2/{STEPS} as shares {[str(d) for d, _, _ in two.shares(BATCH)]}"
        f", each request byte-equal to its pair batched on one card; each "
        f"kernel launched as two batches of two; {wall * 1e3:.1f} ms wall "
        f"against {wall_one * 1e3:.1f} ms for the two pairs one after the "
        f"other on cuda:0 ({CARD[0]})")

    painters = [two.new_session() for _ in range(2)]
    for s in painters:
        s.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
        s.begin_session(np.zeros((RES, 2 * RES, 4), np.uint8))
    stroke = [(0, 0), (RES // 2, 0), (RES, 0)]
    errors = []

    def paint(s):
        try:
            for x, y in stroke:
                s.stamp_at(x, y, return_pixels=False, **settings(FEW_STEPS))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=paint, args=(s,)) for s in painters]
    tic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    canvases = [s.fetch_canvas() for s in painters]
    wall = time.perf_counter() - tic
    if errors:
        raise errors[0]
    for s, canvas in zip(painters, canvases):
        brush, cond, uncond = (t.to(model.device) for t in (
            s._brush, s._cond, s._uncond))
        with torch.inference_mode():
            mine = torch.zeros((RES, 2 * RES, 4), dtype=torch.uint8,
                               device=model.device)
            for (x, y), counter in zip(stroke, s.stamp_counters):
                model.stamp_into(mine, brush, cond, uncond, counter, x, y,
                                 False, False, settings(FEW_STEPS))
        if not np.array_equal(canvas, mine.cpu().numpy()):
            raise AssertionError(f"data_mesh: the session on slot {s.slot} "
                                 f"({s.device}) differs from its stamps "
                                 "replayed one at a time")
    log(f"data_mesh: two sessions on slots {[s.slot for s in painters]} "
        f"({[str(s.device) for s in painters]}) painted {len(stroke)} "
        f"STAMP_ATs each at once in {wall * 1e3:.1f} ms; each canvas "
        f"byte-equal to its stamps replayed one at a time on cuda:0")
    for svc in (one, two):
        for w in set(svc.workers.values()) | {svc.dispatcher._executor}:
            w.shutdown()
    release()
    log(f"data_mesh: phase done in {time.perf_counter() - t_phase:.1f} s")


def model_axis_run(tex, root, steps, one, hist1, report1):
    """--mesh_data 1 --mesh_model 2 (training/train.py, parallel/mesh.py
    ModelShards) beside the ddp phase's one-rank run (`one`, its step
    records and report): two ranks (gloo sharing the card, or NCCL on two
    cards), every step's loss and grad_norm, the checkpoint's trainables
    and the export bitwise equal to the one-rank run's; each rank's frozen
    tower bytes at rest and its peak."""
    import os

    import numpy as np
    import torch

    from diffusiontexturepainting_torch.training import train

    cards = torch.cuda.device_count()
    backend = "gloo" if cards < 2 else None
    case = ("gloo, 2 ranks sharing cuda:0" if cards < 2
            else "NCCL, a card a rank")
    out = os.path.join(root, "model2")
    report = {}
    tic = time.perf_counter()
    _, hist = train.main(train_args(tex, out, *steps, batch=DDP_BATCH,
                                    mesh=1) + ["--mesh_model", "2"],
                         backend=backend, timeout=DDP_TIMEOUT, report=report)
    secs = time.perf_counter() - tic
    ranks = report["ranks"]
    if [(r["data_index"], r["model_index"]) for r in ranks] != [(0, 0),
                                                               (0, 1)]:
        raise AssertionError(f"model_axis: ranks {ranks}")
    for a, b in zip(hist1, hist):
        if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
            raise AssertionError(f"model_axis: step {a['step']}: "
                                 f"{b} against one rank's {a}")
    step = train.checkpoint_steps(os.path.join(one, "checkpoints"))[-1]
    states = [torch.load(os.path.join(d, "checkpoints", str(step),
                                      train.CHECKPOINT_FILE),
                         map_location="cpu", weights_only=True)
              for d in (out, one)]
    for k, v in states[1]["params"].items():
        if not torch.equal(states[0]["params"][k], v):
            raise AssertionError(f"model_axis: trainable {k} differs from "
                                 "the one-rank run's")
    for comp in ("unet", "patch_encoder"):
        a, b = (np.load(os.path.join(d, "export", f"{comp}.npz"))
                for d in (out, one))
        if sorted(a) != sorted(b) or any(a[k].tobytes() != b[k].tobytes()
                                         for k in a):
            raise AssertionError(f"model_axis: export {comp} differs")
    whole = report1["ranks"][0]
    log(f"model_axis: --mesh_data 1 --mesh_model 2 ran {case} in "
        f"{secs:.1f} s: {len(hist)} steps' loss and grad_norm, the "
        f"trainables and the export bitwise equal to the one-rank run's; "
        f"frozen towers at rest a rank "
        + ", ".join(f"{r['frozen_bytes'] / 2**30:.3f}" for r in ranks)
        + f" GiB against {whole['frozen_bytes'] / 2**30:.3f} GiB on one "
        f"rank; peak device memory a rank "
        + ", ".join(f"{r['peak_bytes'] / 2**30:.2f}" for r in ranks)
        + f" GiB against {whole['peak_bytes'] / 2**30:.2f} GiB "
        f"(on a shared card the peak is the process's) ({CARD[0]})")
    return {"case": case, "seconds": secs,
            "frozen_bytes": [r["frozen_bytes"] for r in ranks],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "one_rank": (whole["frozen_bytes"], whole["peak_bytes"])}


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
    a q 2 bytes off 16; K12a and K11 (K7's kernel in bf16) at Cin 3, Cin 9
    and Cout 130; K12b (K4's kernel in bf16) at Cin 20, at Cout 12 and on
    an input 2 bytes off 16; T11 (csrc/window_taps_sm90.cu) at Cin 3 and on
    windows 2 bytes off 16; K10 and T12 (csrc/gn_conv_sm90.cu's affine
    mode) at Cin 3, Cin 9 and Cin 20 and on an input 2 bytes off 16, K10
    also on a residual 2 bytes off 16. Then csrc/conv3x3.cu's fp32 entries
    of K7, K4 and K6, conv_staged.cu's SAME, UP and GN entries (fp32 K12a,
    K11, K12b and K10), attn_transposed.cu's T10, attn_layouts.cu's T4 and
    conv_arms.cu's T11 and T12 called in bf16: each returns
    cudaErrorInvalidValue, and the conv entries' split plans -1."""
    import torch

    from diffusiontexturepainting_torch.ops import (
        attention,
        conv3x3,
        ff_geglu,
        gn_conv,
    )
    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.ops import conv_variants as cv

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

    def up(x, cout, stats=False, op=conv3x3.upsample2x_conv3x3):
        w = torch.randn((3, 3, x.shape[-1], cout), generator=gen,
                        device="cuda").bfloat16()
        taps = conv3x3.fold_upsample_weights(w)
        if stats:
            return lambda: gn_conv.upconv_stream(x, w, None, taps)
        return lambda: op(x, w, None, taps)
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
             "upsample2x_conv3x3_inpad Cin 20":
             up(xc, 16, op=conv3x3.upsample2x_conv3x3_inpad),
             "upsample2x_conv3x3_inpad Cout 12":
             up(xd, 12, op=conv3x3.upsample2x_conv3x3_inpad),
             "upsample2x_conv3x3_inpad x 2 bytes off 16":
             up(off, 16, op=conv3x3.upsample2x_conv3x3_inpad),
             "conv3x3 Cin 20": lambda: conv3x3.conv3x3(xc, wc, None),
             "conv3x3 Cout 12": lambda: conv3x3.conv3x3(xd, wd, None),
             "conv3x3 x 2 bytes off 16":
             lambda: conv3x3.conv3x3(off, w16, None)}
    # bf16 K12a and K11 (K7's kernel) at the staged-tile edge rows that
    # fp32 keeps: Cin 3, Cin 9, Cout 130
    for op in (conv3x3.conv3x3_inpad, conv3x3.conv3x3_stream):
        for xs, ws in (((2, 5, 7, 3), (3, 3, 3, 40)),
                       ((1, 1, 1, 9), (3, 3, 9, 24)),
                       ((1, 17, 9, 48), (3, 3, 48, 130))):
            xr = torch.randn(xs, generator=gen, device="cuda").bfloat16()
            wr = torch.randn(ws, generator=gen, device="cuda").bfloat16()
            what = f"Cout {ws[3]}" if ws[3] % 8 else f"Cin {ws[2]}"
            calls[f"{op.__name__} {what}"] = (
                lambda op=op, xr=xr, wr=wr: op(xr, wr, None))
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
    # bf16 T2 and T5 to T9 (the one-pass modes of flash_attention_sm90.cu)
    # at hd 36 and on a q 2 bytes off 16 (T5 before its copies of the heads)
    h_36 = torch.randn((2, 64, 4 * 36), generator=gen,
                       device="cuda").bfloat16()
    h_flat = torch.randn(1 + 2 * 64 * 320, generator=gen,
                         device="cuda").bfloat16()
    h_off = h_flat[1:].view(2, 64, 320)
    h_ok = h_flat[:2 * 64 * 320].view(2, 64, 320)
    for name in ("nomax_allheads", "pvt_attention", "nomax_attention",
                 "nomax_unpadded", *IN_PLACE_ARMS):
        arm = getattr(av, name)
        calls[f"{name} hd 36"] = lambda arm=arm: arm(h_36, h_36, h_36, 4)
        calls[f"{name} q 2 bytes off 16"] = (
            lambda arm=arm: arm(h_off, h_ok, h_ok, 8))
    # bf16 T11 at Cin 3 (fp32 keeps it: the probes) and on windows 2 bytes
    # off 16
    x3 = torch.rand((3, 7, 16, 3), generator=gen, device="cuda").bfloat16()
    w3t = torch.rand((9, 3, 40), generator=gen, device="cuda").bfloat16()
    xw_flat = torch.rand(1 + 2 * 5 * 16 * 16, generator=gen,
                         device="cuda").bfloat16()
    xw_off = xw_flat[1:].view(2, 5, 16, 16)
    w16t = torch.rand((9, 16, 24), generator=gen, device="cuda").bfloat16()
    for read in TAP_READS:
        calls[f"conv_window_taps {read} Cin 3"] = (
            lambda read=read: cv.conv_window_taps(
                x3, w3t.view(3, 9, 40) if read == "jointw" else w3t, read,
                W=9, reps=3))
    calls["conv_window_taps xwin 2 bytes off 16"] = (
        lambda: cv.conv_window_taps(xw_off, w16t, "shifted", W=14))
    # bf16 K10 and T12 (the affine mode) at Cin 3, 9 and 20 (fp32 keeps
    # them: the probes) and on inputs 2 bytes off 16
    for cin in (3, 9, 20):
        xa = torch.randn((2, 5, 7, cin), generator=gen,
                         device="cuda").bfloat16()
        wa = torch.randn((3, 3, cin, 40), generator=gen,
                         device="cuda").bfloat16()
        sa = torch.ones(cin, device="cuda").bfloat16()
        aa = torch.ones((2, cin), device="cuda")
        calls[f"gn_silu_conv3x3 Cin {cin}"] = (
            lambda xa=xa, wa=wa, sa=sa, cin=cin: conv3x3.gn_silu_conv3x3(
                xa, sa, sa, wa, None, num_groups=cin // (4 if cin == 20
                                                         else 3)))
        calls[f"pipelined Cin {cin}"] = (
            lambda xa=xa, wa=wa, aa=aa: cv.pipelined(xa, aa, aa, wa, None))
    r_flat = torch.randn(1 + 16 * 16 * 16, generator=gen,
                         device="cuda").bfloat16()
    s16 = torch.ones(16, device="cuda").bfloat16()
    a1 = torch.ones((1, 16), device="cuda")
    calls.update({
        "gn_silu_conv3x3 x 2 bytes off 16":
        lambda: conv3x3.gn_silu_conv3x3(off, s16, s16, w16, None,
                                        num_groups=4),
        "gn_silu_conv3x3 residual 2 bytes off 16":
        lambda: conv3x3.gn_silu_conv3x3(
            off.contiguous(), s16, s16, w16, None, None,
            r_flat[1:].view(1, 16, 16, 16), 4),
        "pipelined x 2 bytes off 16":
        lambda: cv.pipelined(off, a1, a1, w16, None)})
    counters = (attention.flash_launches, attention.flash_streaming_launches,
                attention.flash_slotted_launches,
                gn_conv.downconv_stream_launches,
                gn_conv.gn_conv_resident_launches,
                gn_conv.gn_conv_stream_launches, ff_geglu.ff_geglu_launches,
                conv3x3.upsample_launches, gn_conv.upconv_stream_launches,
                conv3x3.conv3x3_launches, conv3x3.conv3x3_inpad_launches,
                conv3x3.conv3x3_stream_launches,
                conv3x3.upsample_inpad_launches, av.pv_product_launches,
                av.slotted_launches, cv.conv_window_taps_launches,
                av.nomax_allheads_launches, av.pvt_launches,
                av.nomax_launches, av.nomax_unpadded_launches,
                av.nomax_4d_launches, av.nomax_laneslice_launches,
                conv3x3.gn_silu_conv3x3_launches, cv.pipelined_launches)
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
        "dtp_conv3x3_staged": _cuda.function(
            "conv_staged", "dtp_conv3x3_staged", conv3x3._STAGED_ARGTYPES)(
            *ptrs, 1, 8, 8, 16, 16, 1, stream),
        "dtp_upsample2x_conv3x3_staged": _cuda.function(
            "conv_staged", "dtp_upsample2x_conv3x3_staged",
            conv3x3._STAGED_ARGTYPES)(*ptrs, 1, 8, 8, 16, 16, 1, stream),
        "dtp_conv_window_taps": _cuda.function(
            "conv_arms", "dtp_conv_window_taps", cv._TAPS_ARGTYPES)(
            x8.data_ptr(), w16.data_ptr(), out.data_ptr(), 1, 6, 4, 8, 16,
            16, 0, 1, 1, stream),
        "dtp_gn_silu_conv3x3_staged": _cuda.function(
            "conv_staged", "dtp_gn_silu_conv3x3_staged",
            conv3x3._GN_STAGED_ARGTYPES)(
            x8.data_ptr(), stats.data_ptr(), s16.data_ptr(), s16.data_ptr(),
            w16.data_ptr(), None, None, None, out.data_ptr(), 1e-5, 1, 8, 8,
            16, 16, 4, 1, stream),
        "dtp_gn_conv_pipelined": _cuda.function(
            "conv_arms", "dtp_gn_conv_pipelined", cv._PIPE_ARGTYPES)(
            x8.data_ptr(), a1.data_ptr(), a1.data_ptr(), w16.data_ptr(),
            None, out.data_ptr(), 1, 8, 8, 16, 16, 1, stream),
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
            8, 8, 16, 0.1, 1, 1, stream),
        **{symbol: _cuda.function(source, symbol, av._SHIFT_ARGTYPES)(
            x8.data_ptr(), x8.data_ptr(), x8.data_ptr(), out.data_ptr(), 1,
            2, 8, 8, 8, 0.1, 32.0, 1, stream)
           for source, symbol in (("attn_arms", "dtp_pvt_attention"),
                                  ("attn_layouts", "dtp_nomax_allheads"),
                                  ("attn_arms", "dtp_nomax_unpadded"),
                                  ("attn_layouts", "dtp_nomax_4d"),
                                  ("attn_layouts", "dtp_nomax_laneslice"))},
        "dtp_nomax_attention": _cuda.function(
            "attn_arms", "dtp_nomax_attention", av._NOMAX_ARGTYPES)(
            x8.data_ptr(), x8.data_ptr(), x8.data_ptr(), out.data_ptr(), 1,
            2, 8, 8, 8, 0.1, 32.0, 1, 0, 1, stream)}
    splits = {symbol: _cuda.function("conv3x3", f"{symbol}_splits",
                                     conv3x3._SPLIT_ARGTYPES)(
        1, 8, 8, 16, 16, 1)
        for symbol in ("dtp_conv3x3", "dtp_upsample2x_conv3x3")}
    torch.cuda.synchronize()
    if set(codes.values()) != {1} or set(splits.values()) != {-1}:
        raise AssertionError(f"probe: fp32 entries in bf16 gave {codes}, "
                             f"split plans {splits}")
    log(f"probe: conv3x3.cu's, conv_staged.cu's SAME, UP and GN, "
        f"attn_transposed.cu's T10, attn_layouts.cu's T4, T6, T7 and T8, "
        f"attn_arms.cu's T2, T5 and T9 and conv_arms.cu's T11 and T12 fp32 "
        f"entries refuse bf16: {codes} (cudaErrorInvalidValue), conv split "
        "plans -1")


def replay_probe(gen):
    """bf16 K9 at the default stamp's three shapes, K1/K5 at a split-K, a
    whole-image and a tiled shape, K14 on K1/K5's inputs, K3 and K4 at the
    default stamp's shapes whose K splits, K6 at the default stamp's three
    shapes and a forced split, K7 at three of the safe twin's split
    shapes, K12a, K11 and K12b at one each, T11's four reads at its
    tool's first shape, T10 at its tool's three shapes in
    both orientations (the partials of many CTAs added by the last), T4
    at the slotted arm's two shapes in both softmax flavours, each twice
    on the same inputs, and T7, T9, T5, T2 (safe, unclamped, bf16 p), T6
    and T8 at the attn_arms path's three head dims (ragged), twice and once
    more replayed from a CUDA graph:
    outputs and statistics bit-identical (fixed reduction orders, no float
    atomics); K1/K5's and K14's statistics also those of their own
    outputs, K6's those of its fp32 output before the rounding
    (STATS_SELF_TOL)."""
    import torch
    import torch.nn.functional as F

    from diffusiontexturepainting_torch.ops import attention_variants as av
    from diffusiontexturepainting_torch.ops import conv_variants as cv
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
    for name, opts in (("nomax_allheads", ()), ("pvt_attention", ()),
                       ("nomax_unpadded", ()),
                       *[(name, ()) for name in IN_PLACE_ARMS],
                       *[("nomax_attention", o) for o in
                         ((True, False), (False, False), (False, True))]):
        for D in (320, 640, 1280):
            key = ((2, 1100, D), (2, 1100, D), 8) + opts
            kernel = kernel_case(name, key, torch.bfloat16, gen)[0]
            first, again = kernel(), kernel()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = kernel()
            graph.replay()
            torch.cuda.synchronize()
            if not (torch.equal(first, again)
                    and torch.equal(first, captured)):
                raise AssertionError(f"probe: {name} {key} differs on "
                                     "replay")
            del graph
            log(f"probe: {name} {key} bf16: bit-identical on replay and "
                "from a CUDA graph")

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
    # K12a and K11 (K7's launch) at a split shape of each one's path
    for kind, key in (("conv3x3_inpad", ((3, 4, 4, 2560),
                                         (3, 3, 2560, 1280))),
                      ("conv3x3_stream", ((3, 8, 8, 2560),
                                          (3, 3, 2560, 1280)))):
        kernel = kernel_case(kind, key, torch.bfloat16, gen)[0]
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"probe: {kind} {key} differs on replay")
        log(f"probe: {kind} {key} bf16: bit-identical on replay")
    # K12b (K4's launch) at the UNet's 4x4 level, whose K splits; T11's four
    # reads at the TPU tool's first shape (one window, split K, the carry)
    for kind, key in (("upsample2x_conv3x3_inpad",
                       ((3, 4, 4, 1280), (3, 3, 1280, 1280))),
                      *[(TAPS, taps_key(1, 16, 128, 512, 128, read, 24))
                        for read in TAP_READS]):
        kernel = kernel_case(kind, key, torch.bfloat16, gen)[0]
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"probe: {kind} {key} differs on replay")
        log(f"probe: {kind} {key} bf16: bit-identical on replay")

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
    affine_replay_probe(gen)


def affine_replay_probe(gen):
    """bf16 K10 (temb and residual) at the UNet's 4x4 and 16x16 levels and
    T12 at a conv_arms shape and a ragged one, each twice under the plan's
    split of K and twice under a forced split of 3: bit-identical on
    replay, and the two splits within TOL of each other (the epilogue runs
    once, after the ordered sum of the splits)."""
    import torch

    from diffusiontexturepainting_torch.ops import conv3x3
    from diffusiontexturepainting_torch.ops import conv_variants as cv

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    for kind, (B, H, W, cin, cout) in (
            ("gn_silu_conv3x3", (3, 4, 4, 2560, 1280)),
            ("gn_silu_conv3x3", (3, 16, 16, 960, 640)),
            (PIPE, (2, 64, 64, 256, 512)), (PIPE, (1, 9, 19, 200, 130))):
        x = (rnd(B, H, W, cin) + 0.3).bfloat16()
        w = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5).bfloat16()
        b = rnd(cout, std=0.1).bfloat16()
        if kind == PIPE:
            a, c = rnd(B, cin, std=0.2) + 1, rnd(B, cin, std=0.2)
            op = lambda **kw: cv._pipelined(x, a, c, w, b, **kw)
        else:
            sc, sh = (rnd(cin, std=0.2) + 1).bfloat16(), rnd(
                cin, std=0.2).bfloat16()
            t, r = rnd(B, cout).bfloat16(), rnd(B, H, W, cout).bfloat16()
            op = lambda **kw: conv3x3._gn_silu_conv3x3(
                x, sc, sh, w, b, t, r, 32, 1e-5, **kw)
        planned = [op() for _ in range(2)]
        forced = [op(splits=3) for _ in range(2)]
        torch.cuda.synchronize()
        if not (torch.equal(*planned) and torch.equal(*forced)):
            raise AssertionError(f"probe: {kind} {(B, H, W, cin, cout)} "
                                 "differs on replay")
        err, tol = _err_tol(forced[0], planned[0])
        if not err <= tol:
            raise AssertionError(f"probe: {kind} {(B, H, W, cin, cout)}: "
                                 f"split 3 against the plan's {err:.3e} > "
                                 f"{tol:.3e}")
        log(f"probe: {kind} {(B, H, W, cin, cout)} bf16: bit-identical on "
            f"replay under the plan's split and under 3 splits; the two "
            f"{err:.3e} apart (tol {tol:.3e})")


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
        device_by_option = Counter()
        lib_missing = False
        self_worst = family_diff = 0.0
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
                family_diff = max(family_diff,
                                  r.get("family_max_abs_diff", 0.0))
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
                        if "kernel_device_ms" in r:
                            device_by_option[OPTION_OF[name](key)] += (
                                count * r["kernel_device_ms"])
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
                                  "library_device", "composition_device",
                                  "family_device"):
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
                f"shapes and launches ({path} path)"
                + (f"; bf16 max|{name} - family| {family_diff:.3e} at every "
                   "shape where it runs the family's launch"
                   if name in FAMILY_EXACT else ""))
        record.append({
            "name": name, "route": "cuda",
            "source": "diffusiontexturepainting_torch/" + SOURCES[name],
            "replaces": REPLACES[name], "path": path,
            "launches": run["launches"][name],
            "launches_by_path": {p: paths[p]["launches"][name]
                                 for p in paths},
            # the FMA twins' share, where a path launched any
            "fp32_launches_by_path": {
                p: paths[p]["dtypes"][name]["float32"] for p in paths
                if paths[p].get("dtypes", {}).get(name, {}).get("float32")},
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
            **({"family_device_ms": totals["family_device"] / n}
               if name in FAMILY_IS and name in DEVICE_TIMED else {}),
            **({"family_max_abs_diff": family_diff}
               if name in FAMILY_EXACT else {}),
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
            **({"device_ms_by_option": {k: v / n for k, v in
                                        device_by_option.items()}}
               if device_by_option else {}),
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
                   if also else "")
                + (f"; family {totals['family_device'] / n:.4f}"
                   if name in FAMILY_IS else "")
                + "".join(f"; {k} {v / n:.4f}"
                          for k, v in device_by_option.items()))
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
    CARD[0] = card
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
        # K12a and K11 in fp32 (the staged-tile FMA twin): Cin 3 and 9 (one
        # ragged channel chunk), odd H and W, a 1x1 image, Cout off the
        # tile (bf16 refuses these: tma_refusal_probe); in bf16 (K7's
        # kernel) ragged shapes TMA can describe: odd H and W, a 1x1
        # image, Cout 40 and 136
        ("conv3x3_inpad", ((2, 5, 7, 3), (3, 3, 3, 40)), (torch.float32,)),
        ("conv3x3_inpad", ((1, 1, 1, 9), (3, 3, 9, 24)), (torch.float32,)),
        ("conv3x3_stream", ((1, 17, 9, 48), (3, 3, 48, 130)),
         (torch.float32,)),
        ("conv3x3_inpad", ((2, 5, 7, 8), (3, 3, 8, 40)), (torch.bfloat16,)),
        ("conv3x3_inpad", ((1, 1, 1, 16), (3, 3, 16, 24)),
         (torch.bfloat16,)),
        ("conv3x3_stream", ((1, 17, 9, 48), (3, 3, 48, 136)),
         (torch.bfloat16,)),
        # K12b (bf16: K4's kernel; fp32: the staged-tile UP mode): odd H
        # and W, Cout off the tile, a UNet 4x4 level
        ("upsample2x_conv3x3_inpad", ((1, 6, 5, 48), (3, 3, 48, 40))),
        ("upsample2x_conv3x3_inpad", ((3, 4, 4, 1280), (3, 3, 1280, 1280))),
        # K10 (bf16: the affine mode of csrc/gn_conv_sm90.cu; fp32: the
        # staged-tile GN mode): odd H and W with Cout off the tile, the 4x4
        # level at batch 3 with temb (three images a tile, K split), Cin 40
        # with Cout 130 (padded to 136, 130 stored) and groups of 5, Cin 8,
        # a 1x1 image, several images a tile with groups of 3; Cin 3 in
        # fp32 only (bf16 refuses it: tma_refusal_probe)
        ("gn_silu_conv3x3", ((2, 9, 10, 64), (3, 3, 64, 136), True, True,
                             32)),
        ("gn_silu_conv3x3", ((3, 4, 4, 2560), (3, 3, 2560, 1280), True,
                             False, 32)),
        ("gn_silu_conv3x3", ((2, 5, 7, 40), (3, 3, 40, 130), True, True, 8)),
        ("gn_silu_conv3x3", ((1, 9, 19, 8), (3, 3, 8, 24), False, False,
                             2)),
        ("gn_silu_conv3x3", ((2, 1, 1, 16), (3, 3, 16, 24), False, True, 4)),
        ("gn_silu_conv3x3", ((3, 4, 4, 96), (3, 3, 96, 40), True, True, 32)),
        ("gn_silu_conv3x3", ((2, 5, 7, 3), (3, 3, 3, 40), True, True, 3),
         (torch.float32,)),
        # the softmax arms: head dims 40, 80, 160 (the kernel's register
        # tiles), a ragged length, the options the attn_arms path does not
        # run (T3's keys a multiple of its chunk)
        ("nomax_attention", ((2, 1100, 320), (2, 1100, 320), 8, False,
                             False)),
        ("nomax_attention", ((2, 1100, 640), (2, 1100, 640), 8, True, True)),
        # bf16 T2 (flash_attention_sm90.cu, head-major): keys != queries,
        # each p at hd 160
        ("nomax_attention", ((2, 1100, 1280), (2, 1000, 1280), 8, False,
                             True)),
        ("nomax_attention", ((2, 1100, 1280), (2, 900, 1280), 8, True,
                             False)),
        ("chunked_attention", ((2, 1100, 640), (2, 1152, 640), 8, 128,
                               False)),
        ("chunked_attention", ((2, 1100, 320), (2, 1152, 320), 8, 64, True)),
        # bf16 T3 (fp32's twin takes 64 and 128 only): chunks of several
        # tiles (384: three 128-key tiles at hd 80, six 64-key ones at hd
        # 160), one chunk of every key (1152; 1100 over a ragged tile), and
        # the TPU tool's chunks at its unet L0 and L1 512px shapes
        *[("chunked_attention", ((2, 1100, d), (2, lk, d), 8, bk, bf16_p),
           (torch.bfloat16,))
          for d, lk, bk, bf16_p in ((640, 1152, 384, False),
                                    (320, 1152, 384, True),
                                    (1280, 1152, 384, True),
                                    (1280, 1152, 1152, True),
                                    (320, 1100, 1100, False),
                                    (640, 1100, 1100, True))],
        *[("chunked_attention", ((3, L, d), (3, L, d), 8, bk, bf16_p),
           (torch.bfloat16,))
          for L, d in ((4096, 320), (1024, 640))
          for bk in (512, 1024, 2048) if not (L % bk or L == bk)
          for bf16_p in (False, True)],
        ("nomax_unpadded", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("nomax_unpadded", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("nomax_unpadded", ((2, 1100, 640), (2, 900, 640), 8)),
        ("pvt_attention", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("pvt_attention", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("pvt_attention", ((2, 1100, 640), (2, 900, 640), 8)),
        # the layout arms at each register tile and a ragged length; T4 at
        # 128 lanes with fp32 logits (the option the slotted_arm path does
        # not run), with P = hd (no pad lanes), at the 160-lane bucket in
        # both flavours (keys != queries) and at 64 lanes
        ("nomax_4d", ((2, 1100, 320), (2, 1100, 320), 8)),
        ("nomax_4d", ((2, 1100, 1280), (2, 900, 1280), 8)),
        ("nomax_allheads", ((2, 1100, 1280), (2, 1100, 1280), 8)),
        ("nomax_allheads", ((2, 1100, 320), (2, 1000, 320), 8)),
        ("nomax_allheads", ((2, 1100, 640), (2, 1100, 640), 4)),
        ("nomax_laneslice", ((2, 1100, 640), (2, 1100, 640), 8)),
        ("nomax_laneslice", ((2, 1100, 320), (2, 1000, 320), 8)),
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
        # T12 at the TPU tool's shapes, then (bf16: the affine mode of
        # csrc/gn_conv_sm90.cu) odd H and W, Cin 8 and 40, Cout 130
        # (padded to 136, 130 stored), a 1x1 image, several images a tile,
        # no bias; Cin 3 and 9 in fp32 only (bf16 refuses them:
        # tma_refusal_probe)
        ("pipelined", ((2, 512, 512, 128), (3, 3, 128, 128), True)),
        ("pipelined", ((1, 512, 512, 128), (3, 3, 128, 128), True)),
        ("pipelined", ((1, 256, 256, 256), (3, 3, 256, 256), True)),
        ("pipelined", ((2, 5, 7, 8), (3, 3, 8, 40), True)),
        ("pipelined", ((1, 9, 19, 40), (3, 3, 40, 130), False)),
        ("pipelined", ((2, 1, 1, 16), (3, 3, 16, 24), True)),
        ("pipelined", ((5, 3, 3, 8), (3, 3, 8, 16), False)),
        ("pipelined", ((2, 5, 7, 3), (3, 3, 3, 40), True), (torch.float32,)),
        ("pipelined", ((1, 1, 1, 9), (3, 3, 9, 24), True), (torch.float32,)),
        # T11's four reads at the TPU tool's shapes (one window, reps 24),
        # then odd H_T and W, Cin 3 (fp32: bf16 refuses it,
        # tma_refusal_probe) and 40, N off 8 and off the tile, several
        # windows
        *[("conv_window_taps", taps_key(1, h_t, W, cin, n, read, 24))
          for h_t, W, cin, n in ((16, 128, 512, 128), (8, 256, 256, 256),
                                 (8, 512, 128, 128))
          for read in TAP_READS],
        *[("conv_window_taps", taps_key(3, 5, 9, 3, 40, read, 3),
           (torch.float32,)) for read in TAP_READS],
        *[("conv_window_taps", taps_key(2, 3, 19, 40, 130, read, 1))
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
        dtypes = launch_dtypes()
        check_counts(label, model, steps, launches, n, res, in_pad, dtypes)
        paths[label] = dict(launches=launches, shapes=shapes, dtypes=dtypes,
                            stamps=n, steps=steps, res=res)
        return first

    log("default: requests routed through diffusiontexturepainting_torch."
        "serving.wire.handle_request_bytes")
    model = TorchConditionalInpainter(resolution=RES, device="cuda")
    log(f"default: model built in {model.init_seconds:.1f} s (full SD-1.5 "
        f"width, random weights, {model.dtype}, {model.config}); unet "
        f"{sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M "
        "params")
    default_first = drive("default", model, STEPS, RES)
    weights = model.state_dicts()
    paths["cfg"] = cfg_phase(weights, model, default_first)

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
    # bf16 K12a and K12b launch K7's and K4's kernels: nothing differs
    compare_stamps("twin_inpad", inpad_first, twin_first,
                   "the safe twin with _IN_PAD on and off", exact=True)

    launches, shapes = resnet_bodies_phase(
        twin, paths["twin"]["shapes"]["conv3x3"], paths["twin"]["stamps"])
    paths["resnet_bodies"] = dict(launches=launches, shapes=shapes, stamps=1,
                                  steps=1, res=RES)
    del twin
    release()

    serve_phase(model)
    log(f"timer: the default model's StageTimer after the serve phase "
        f"({CARD[0]}):")
    for line in model.timer.summary().splitlines():
        log(f"timer: {line}")
    launches, shapes, n = session_phase(model)
    check_counts("session", model, FEW_STEPS, launches, n)
    paths["session"] = dict(launches=launches, shapes=shapes, stamps=n,
                            steps=FEW_STEPS, res=RES)
    engine_phase(model, weights)
    tic = time.perf_counter()
    scheduler_phase(weights)
    log(f"schedulers: phase done in {time.perf_counter() - tic:.1f} s")
    tic = time.perf_counter()
    checkpoint_phase(model)
    log(f"checkpoint: phase done in {time.perf_counter() - tic:.1f} s")
    convert_phase(model)
    client_record = client_phase(model)
    deep_cache_phase(model, weights, drive, paths)
    f32_phase(model, weights, drive)
    tic = time.perf_counter()
    launches, shapes = batched_phase(model)
    paths["batched"] = dict(launches=launches, shapes=shapes, stamps=1,
                            steps=STEPS, res=RES)
    data_mesh_phase(model)
    del model
    release()
    batched_serving_process()
    log(f"batched: phase done in {time.perf_counter() - tic:.1f} s")
    tic = time.perf_counter()
    run_flags_phase()
    log(f"run_flags: phase done in {time.perf_counter() - tic:.1f} s")
    train_phase()
    release()
    ddp_phase()

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

    record = kernels_phase(gen, paths) + [client_record]

    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "diffusiontexturepainting_tpu", "tornado",
                        "PIL"))
    if loaded:
        raise AssertionError(f"the run imported {loaded}")
    log("no jax: neither jax, nor diffusiontexturepainting_tpu, nor tornado, "
        "nor PIL in sys.modules")
    log(f"done in {time.perf_counter() - t_start:.1f} s ({CARD[0]})")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
