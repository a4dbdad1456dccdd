#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own lines; any failure raises (nonzero exit):
  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel from csrc/, seconds printed;
  3. probe    each kernel against its plain version at a few shapes;
  4. slice    full-width SD-1.5 (seeded random weights, bf16) at 256^2 /
              20 DDIM steps: one NEW_BRUSH_IMAGE and three NEW_STAMP
              requests as wire bytes through the port's request handler
              (serving/wire.py), plus a repeat of the first stamp, each
              reply checked;
  5. counts   each kernel's launches in phase 4 against the count derived
              from the model configuration;
  6. kernels  each kernel against its plain version at every shape phase 4
              launched it at, in bf16 and fp32, with CUDA-event times;
  7. no jax   the run imported neither JAX nor the JAX package.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
RES, STEPS = 256, 20
SETTINGS = dict(steps=STEPS, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=20, context_pad=150)
# Tolerance relative to the output's largest magnitude. bf16 products
# accumulate in fp32 in both versions but round at other places (the plain
# conv rounds before its bias add, the plain attention rounds normalized
# probabilities): 2^-5 of the largest output is 4 to 8 bf16 ulps at that
# magnitude. fp32: accumulation order only.
TOL = {"bfloat16": 2.0**-5, "float32": 1e-4}


def log(*parts):
    print(*parts, flush=True)


def kernel_case(kind, shape_key, dtype, gen):
    """Seeded inputs at `shape_key`; returns zero-argument callables
    (kernel, plain) over the same inputs."""
    import torch

    from diffusiontexturepainting_torch.ops import attention, conv3x3

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)

    if kind == "flash_attention":
        q_shape, k_shape, heads = shape_key
        q, k, v = rnd(*q_shape), rnd(*k_shape), rnd(*k_shape)
        return (lambda: attention.flash_attention(q, k, v, heads),
                lambda: attention.plain_attention(q, k, v, heads))
    x_shape, w_shape = shape_key
    x = rnd(*x_shape)
    w = rnd(*w_shape, std=(9 * w_shape[2]) ** -0.5)
    b = rnd(w_shape[3], std=0.1)
    if kind == "conv3x3":
        return (lambda: conv3x3.conv3x3(x, w, b),
                lambda: conv3x3.conv3x3_plain(x, w, b))
    # the modules fold the upsample weights once at load: outside the call
    taps = conv3x3.fold_upsample_weights(w)
    return (lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps),
            lambda: conv3x3.upsample2x_conv3x3_plain(x, w, b))


def cuda_ms(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(kind, shape_key, dtype, gen, timed=False):
    """Kernel vs plain version on the same inputs; returns (max_abs_err,
    tol, max|plain|, kernel_ms, plain_ms), the times only when `timed`."""
    import torch

    kernel, plain = kernel_case(kind, shape_key, dtype, gen)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{kind} {shape_key}: kernel gave "
                             f"{tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kind} {shape_key} {dtype}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    tol = TOL[str(dtype).split(".")[-1]] * peak
    if not err <= tol:
        raise AssertionError(f"{kind} {shape_key} {dtype}: max_abs_err "
                             f"{err:.3e} > tol {tol:.3e}")
    k_ms = p_ms = None
    if timed:
        # plain, kernel, kernel, plain: drift hits both sides alike
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    return err, tol, peak, k_ms, p_ms


def expected_per_stamp(model, res, steps):
    """Launches of each kernel in one stamp, from the configuration."""
    from diffusiontexturepainting_torch.ops.attention import uses_flash

    u, v = model.unet.cfg, model.vae_encoder.cfg
    lat = res // 8
    n_u, n_v = len(u.block_out_channels), len(v.block_out_channels)
    unet_resnets = n_u * u.layers_per_block + 2 + n_u * (u.layers_per_block
                                                         + 1)
    flash_unet = 0
    for i, ch in enumerate(u.block_out_channels):
        length = (lat >> i) ** 2
        if uses_flash(length, length, ch // u.num_attention_heads):
            flash_unet += u.attn_down[i] * (2 * u.layers_per_block + 1)
    mid_len = (lat >> (n_u - 1)) ** 2
    if uses_flash(mid_len, mid_len,
                  u.block_out_channels[-1] // u.num_attention_heads):
        flash_unet += 1
    vae_resnets = (n_v * v.layers_per_block + 2) + (n_v * (v.layers_per_block
                                                           + 1) + 2)
    # the VAE's mid block, encoder and decoder, runs at the latent size
    flash_vae = 2 * uses_flash(lat * lat, lat * lat, v.block_out_channels[-1])
    return {
        "conv3x3": steps * 2 * unet_resnets + 2 * vae_resnets,
        "upsample2x_conv3x3": steps * (n_u - 1) + (n_v - 1),
        "flash_attention": steps * flash_unet + flash_vae,
    }


def check_reply(reply, want_type, canvas=None):
    import numpy as np

    from diffusiontexturepainting_torch.serving import wire

    kind, img = wire.decode_response(reply)
    if kind != want_type or img.shape != (RES, RES, 3) \
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


def run_slice():
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    from diffusiontexturepainting_torch.serving import wire

    R, handle = wire.RequestType, wire.handle_request_bytes
    model = TorchConditionalInpainter(resolution=RES, device="cuda")
    log(f"slice: model built in {model.init_seconds:.1f} s "
        f"(full SD-1.5 width, random weights, {model.dtype}); "
        f"unet {sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M "
        "params")
    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:64, :, 3] = 255
    canvas[:64, :, :3] = 64
    stamp_req = wire.encode_request(R.NEW_STAMP, canvas, **SETTINGS)

    from diffusiontexturepainting_torch.ops import attention, conv3x3

    counters = [conv3x3.conv3x3_launches, conv3x3.upsample_launches,
                attention.flash_launches]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    times = []
    tic = time.perf_counter()
    check_reply(handle(model, wire.encode_request(R.NEW_BRUSH_IMAGE, brush,
                                                  **SETTINGS)),
                R.RETURN_PREVIEW)
    times.append(("brush+preview", time.perf_counter() - tic))
    replies = []
    for k in range(3):
        tic = time.perf_counter()
        reply = handle(model, stamp_req)
        times.append((f"stamp {k + 1}", time.perf_counter() - tic))
        replies.append(check_reply(reply, R.RETURN_STAMP, canvas))
    if all(np.array_equal(replies[0], r) for r in replies[1:]):
        raise AssertionError("stamps with different counters are identical")
    # replay request 2 (the first NEW_STAMP) with its own counter
    model.request_counter = 1
    tic = time.perf_counter()
    again = handle(model, stamp_req)
    times.append(("stamp 1 replayed", time.perf_counter() - tic))
    if not np.array_equal(check_reply(again, R.RETURN_STAMP, canvas),
                          replies[0]):
        raise AssertionError("replayed stamp differs from the original")
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters}
    shapes = {c.name: dict(c.shapes) for c in counters}
    for name, secs in times:
        log(f"slice: {name}: {secs * 1e3:.1f} ms wall ({RES}^2, {STEPS} "
            f"steps, {model.dtype})")
    log(f"slice: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, launches, shapes, 5  # preview + 3 stamps + replay


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffusiontexturepainting_torch import _cuda

    card = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    secs = _cuda.build_all()
    log(f"build: {secs:.1f} s for {', '.join(_cuda.SOURCES)}")
    for name, report in _cuda.build_reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    probes = [
        ("conv3x3", ((3, 32, 32, 320), (3, 3, 320, 320))),
        ("conv3x3", ((1, 64, 64, 512), (3, 3, 512, 256))),
        ("upsample2x_conv3x3", ((3, 8, 8, 1280), (3, 3, 1280, 1280))),
        ("flash_attention", ((3, 1024, 320), (3, 1024, 320), 8)),
        ("flash_attention", ((1, 1024, 512), (1, 1024, 512), 1)),
        # head dims of the 512^2 operating point, and a ragged length
        ("flash_attention", ((3, 4096, 640), (3, 4096, 640), 8)),
        ("flash_attention", ((2, 1100, 1280), (2, 1100, 1280), 8)),
    ]
    for kind, key in probes:
        for dt in (torch.bfloat16, torch.float32):
            err, tol, peak, _, _ = compare(kind, key, dt, gen)
            log(f"probe: {kind} {key} {str(dt)[6:]}: max_abs_err "
                f"{err:.3e} (tol {tol:.3e}, max|plain| {peak:.3e})")

    log("slice: requests routed through diffusiontexturepainting_torch."
        "serving.wire.handle_request_bytes")
    model, launches, shapes, n_stamps = run_slice()

    want = {k: n_stamps * v
            for k, v in expected_per_stamp(model, RES, STEPS).items()}
    for name in want:
        log(f"counts: {name}: {launches[name]} launches in {n_stamps} "
            f"stamps, expected {want[name]} "
            f"({want[name] // n_stamps} per stamp)")
        if launches[name] != want[name]:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {want[name]}")

    sources = {"conv3x3": "diffusiontexturepainting_torch/csrc/conv3x3.cu",
               "upsample2x_conv3x3":
                   "diffusiontexturepainting_torch/csrc/conv3x3.cu",
               "flash_attention":
                   "diffusiontexturepainting_torch/csrc/flash_attention.cu"}
    replaces = {
        "conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:162",
        "upsample2x_conv3x3":
            "diffusiontexturepainting_tpu/ops/conv3x3.py:761",
        "flash_attention":
            "diffusiontexturepainting_tpu/ops/flash_attention.py:37"}
    record = []
    for name, per_shape in shapes.items():
        errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
        err_over_tol = {torch.bfloat16: 0.0, torch.float32: 0.0}
        k_total = p_total = 0.0
        for key, count in sorted(per_shape.items()):
            for dt in errs:
                err, tol, peak, k_ms, p_ms = compare(
                    name, key, dt, gen, timed=dt == torch.bfloat16)
                errs[dt] = max(errs[dt], err)
                err_over_tol[dt] = max(err_over_tol[dt], err / tol)
                msg = (f"kernels: {name} {key} {str(dt)[6:]}: max_abs_err "
                       f"{err:.3e} (tol {tol:.3e}, max|plain| {peak:.3e})")
                if k_ms is not None:
                    k_total += count * k_ms
                    p_total += count * p_ms
                    msg += (f"; {k_ms:.4f} ms kernel, {p_ms:.4f} ms plain, "
                            f"x{count // n_stamps} per stamp")
                log(msg)
        record.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "max_err_over_tol": err_over_tol[torch.bfloat16],
            "max_err_over_tol_fp32": err_over_tol[torch.float32],
            "ms": k_total / n_stamps, "plain_ms": p_total / n_stamps,
            "ms_is": "bf16 kernel time per stamp, summed over its shapes"})

    loaded = sorted(m for m in sys.modules if m.split(".")[0]
                    in ("jax", "diffusiontexturepainting_tpu"))
    if loaded:
        raise AssertionError(f"the run imported {loaded}")
    log("no jax: neither jax nor diffusiontexturepainting_tpu in "
        "sys.modules")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
