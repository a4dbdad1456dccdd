#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own lines; any failure raises (nonzero exit):
  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel from csrc/, in parallel, seconds
              printed;
  3. probe    each kernel against its plain version at a few shapes;
  4. default  the served configuration (PipelineConfig(): every fused
              switch on): full-width SD-1.5 (seeded random weights, bf16)
              at 256^2 / 20 DDIM steps: one NEW_BRUSH_IMAGE and three
              NEW_STAMP requests as wire bytes through the port's request
              handler (serving/wire.py), plus a replay of the first stamp
              that must be bit-identical, each reply checked; then each
              kernel's launches in that run against the count derived from
              the configuration;
  5. twin     the same for the "safe twin" (every fused switch off, module
              legs only), built from the default model's state_dict, at
              4 DDIM steps; then the first stamps of the two
              configurations at equal steps, compared in u8;
  6. kernels  each kernel against its plain version at every shape the
              two paths launched it at, in bf16 and fp32 (TF32 off),
              statistics included, with CUDA-event times;
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
RES, STEPS, TWIN_STEPS = 256, 20, 4


def settings(steps):
    return dict(steps=steps, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=steps, context_pad=150)


# Tolerance relative to the output's largest magnitude. bf16 products
# accumulate in fp32 in both versions but round at other places (the plain
# convs round before their bias add, the plain attention rounds normalized
# probabilities, the plain GroupNorm prologue rounds the affine's product
# and sum apart): 2^-5 of the largest output is 4 to 8 bf16 ulps at that
# magnitude. fp32: accumulation order only. Statistics: the same fraction
# of the sum of |y| (row 0) or of y^2 (row 1) over the pixels, the scale
# that bounds their rounding error.
TOL = {"bfloat16": 2.0**-5, "float32": 1e-4}
# The first stamps of the default and the safe-twin configurations at
# equal steps: the same math with other rounding points in bf16 (fused
# epilogues round once where the module legs round twice), amplified
# through the DDIM steps of a random-weight UNet: at most MAX_MEAN_DIFF u8
# levels apart on average over the pixels.
MAX_MEAN_DIFF = 8.0

SOURCES = {
    "conv3x3": "csrc/conv3x3.cu",
    "upsample2x_conv3x3": "csrc/conv3x3.cu",
    "flash_attention": "csrc/flash_attention.cu",
    "gn_conv_resident": "csrc/conv3x3.cu",
    "gn_conv_stream": "csrc/conv3x3.cu",
    "upconv_stream": "csrc/conv3x3.cu",
    "ff_geglu": "csrc/ff_geglu.cu",
}
REPLACES = {
    "conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:162",
    "upsample2x_conv3x3": "diffusiontexturepainting_tpu/ops/conv3x3.py:761",
    "flash_attention": "diffusiontexturepainting_tpu/ops/flash_attention.py:37",
    "gn_conv_resident": "diffusiontexturepainting_tpu/ops/conv3x3.py:1031",
    "gn_conv_stream": "diffusiontexturepainting_tpu/ops/gn_conv_stream.py:173",
    "upconv_stream": "diffusiontexturepainting_tpu/ops/gn_conv_stream.py:739",
    "ff_geglu": "diffusiontexturepainting_tpu/ops/ff_geglu.py:68",
}


def log(*parts):
    print(*parts, flush=True)


def counters():
    from diffusiontexturepainting_torch.ops import (
        attention,
        conv3x3,
        ff_geglu,
        gn_conv,
    )

    return [conv3x3.conv3x3_launches, conv3x3.upsample_launches,
            attention.flash_launches, gn_conv.gn_conv_resident_launches,
            gn_conv.gn_conv_stream_launches, gn_conv.upconv_stream_launches,
            ff_geglu.ff_geglu_launches]


def kernel_case(kind, shape_key, dtype, gen):
    """Seeded inputs at `shape_key`; returns zero-argument callables
    (kernel, plain) over the same inputs. The fused convs return
    (out, statistics or None)."""
    import torch

    from diffusiontexturepainting_torch.ops import (
        attention,
        conv3x3,
        ff_geglu,
        gn_conv,
    )

    def rnd(*shape, std=1.0, mean=0.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + mean).to(dt)

    if kind == "flash_attention":
        q_shape, k_shape, heads = shape_key
        q, k, v = rnd(*q_shape), rnd(*k_shape), rnd(*k_shape)
        return (lambda: attention.flash_attention(q, k, v, heads),
                lambda: attention.plain_attention(q, k, v, heads))
    if kind == "ff_geglu":
        n, c, inner = shape_key
        x, res = rnd(n, c), rnd(n, c)
        w0, b0 = rnd(2 * inner, c, std=c**-0.5), rnd(2 * inner, std=0.1)
        w2, b2 = rnd(c, inner, std=inner**-0.5), rnd(c, std=0.1)
        return (lambda: ff_geglu.ff_geglu(x, w0, b0, w2, b2, res),
                lambda: ff_geglu.ff_geglu_plain(x, w0, b0, w2, b2, res))
    x_shape, w_shape = shape_key[:2]
    x = rnd(*x_shape)
    w = rnd(*w_shape, std=(9 * w_shape[2]) ** -0.5)
    b = rnd(w_shape[3], std=0.1)
    if kind == "conv3x3":
        return (lambda: conv3x3.conv3x3(x, w, b),
                lambda: conv3x3.conv3x3_plain(x, w, b))
    # the modules fold the upsample weights once at load: outside the call
    taps = conv3x3.fold_upsample_weights(w)
    if kind == "upsample2x_conv3x3":
        return (lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps),
                lambda: conv3x3.upsample2x_conv3x3_plain(x, w, b))
    if kind == "upconv_stream":
        stats = shape_key[2]
        return (lambda: gn_conv.upconv_stream(x, w, b, taps, stats),
                lambda: gn_conv.upconv_stream_plain(x, w, b, stats))
    has_bias, has_res, stats, apply_gn = shape_key[2:]
    B, cin = x_shape[0], x_shape[3]
    a = rnd(B, cin, std=0.2, mean=1.0, dt=torch.float32)
    c = rnd(B, cin, std=0.2, dt=torch.float32)
    b = b if has_bias else None
    r = rnd(*x_shape[:3], w_shape[3]) if has_res else None
    op = getattr(gn_conv, kind)
    return (lambda: op(x, a, c, w, b, r, stats, apply_gn),
            lambda: gn_conv.gn_conv3x3_plain(x, a, c, w, b, r, stats,
                                             apply_gn))


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
    """Kernel vs plain version on the same inputs; returns a dict of
    max_abs_err, tol, peak (max|plain|), err_over_tol (the worst of the
    output's and the statistics'), and kernel_ms / plain_ms when `timed`."""
    import torch

    kernel, plain = kernel_case(kind, shape_key, dtype, gen)
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
        out["stats_checked"] = True
    if timed:
        # plain, kernel, kernel, plain: drift hits both sides alike
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
        out["kernel_ms"], out["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    return out


def expected_per_stamp(model, res, steps):
    """Launches of each kernel in one stamp of `model`, from its
    configuration."""
    from diffusiontexturepainting_torch.ops.attention import uses_flash

    c = model.config
    u, v = model.unet.cfg, model.vae_encoder.cfg
    lat = res // 8
    n_u, n_v = len(u.block_out_channels), len(v.block_out_channels)
    L, Lv = u.layers_per_block, v.layers_per_block
    plain_resnets = n_u * L + 2          # down path and mid: no skip
    skip_resnets = n_u * (L + 1)         # up path: skip un-concatenated
    transformers = sum(u.attn_down) * (2 * L + 1) + 1
    flash_unet = 0
    for i, ch in enumerate(u.block_out_channels):
        length = (lat >> i) ** 2
        if uses_flash(length, length, ch // u.num_attention_heads):
            flash_unet += u.attn_down[i] * (2 * L + 1)
    mid_len = (lat >> (n_u - 1)) ** 2
    if uses_flash(mid_len, mid_len,
                  u.block_out_channels[-1] // u.num_attention_heads):
        flash_unet += 1
    enc_resnets, dec_resnets = n_v * Lv + 2, n_v * (Lv + 1) + 2
    # the VAE's mid block, encoder and decoder, runs at the latent size
    flash_vae = 2 * uses_flash(lat * lat, lat * lat, v.block_out_channels[-1])
    fused_unet, fused_enc, fused_dec = (c.fused_unet_resnet,
                                        c.fused_vae_encoder,
                                        c.fused_vae_decoder)
    unet_convs = 2 * (plain_resnets + skip_resnets)
    return {
        "conv3x3": (0 if fused_unet else steps * unet_convs)
        + (0 if fused_enc else 2 * enc_resnets)
        + (0 if fused_dec else 2 * dec_resnets),
        "upsample2x_conv3x3": steps * (n_u - 1)
        + (0 if fused_dec else n_v - 1),
        "flash_attention": steps * flash_unet + flash_vae,
        "gn_conv_resident": steps * (2 * plain_resnets + 3 * skip_resnets)
        if fused_unet else 0,
        "ff_geglu": steps * transformers if c.fused_unet_ff else 0,
        "gn_conv_stream": (2 * enc_resnets + 1 if fused_enc else 0)
        + (2 * dec_resnets + 1 if fused_dec else 0),
        "upconv_stream": n_v - 1 if fused_dec else 0,
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


def requests():
    import numpy as np

    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:64, :, 3] = 255
    canvas[:64, :, :3] = 64
    return brush, canvas


def run_path(label, model, steps):
    """One brush + preview, three stamps and a replay of the first, as wire
    bytes through the request handler. The kernels' counts are set to 0
    just before and read just after. Returns (first stamp, launches,
    shapes, stamps run)."""
    import numpy as np
    import torch

    from diffusiontexturepainting_torch.serving import wire

    R, handle = wire.RequestType, wire.handle_request_bytes
    brush, canvas = requests()
    stamp_req = wire.encode_request(R.NEW_STAMP, canvas, **settings(steps))
    for c in counters():
        c.reset()
    torch.cuda.synchronize()
    times = []
    tic = time.perf_counter()
    check_reply(handle(model, wire.encode_request(R.NEW_BRUSH_IMAGE, brush,
                                                  **settings(steps))),
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
        raise AssertionError(f"{label}: replayed stamp differs from the "
                             "original")
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in counters()}
    shapes = {c.name: dict(c.shapes) for c in counters()}
    for name, secs in times:
        log(f"{label}: {name}: {secs * 1e3:.1f} ms wall ({RES}^2, {steps} "
            f"steps, {model.dtype})")
    log(f"{label}: replayed stamp bit-identical; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return replies[0], launches, shapes, 5  # preview + 3 stamps + replay


def check_counts(label, model, steps, launches, n_stamps):
    want = {k: n_stamps * v
            for k, v in expected_per_stamp(model, RES, steps).items()}
    for name in want:
        log(f"{label} counts: {name}: {launches[name]} launches in "
            f"{n_stamps} stamps, expected {want[name]} "
            f"({want[name] // n_stamps} per stamp)")
        if launches[name] != want[name]:
            raise AssertionError(f"{label}: {name}: {launches[name]} "
                                 f"launches, expected {want[name]}")


def first_stamp_at(model, steps):
    """The first NEW_STAMP of run_path (request counter 2) at `steps`."""
    from diffusiontexturepainting_torch.serving import wire

    R = wire.RequestType
    _, canvas = requests()
    model.request_counter = 1
    reply = wire.handle_request_bytes(
        model, wire.encode_request(R.NEW_STAMP, canvas, **settings(steps)))
    return check_reply(reply, R.RETURN_STAMP, canvas)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffusiontexturepainting_torch import _cuda
    from diffusiontexturepainting_torch.core.config import safe_twin_config
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

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
        ("upconv_stream", ((1, 6, 5, 48), (3, 3, 48, 40), True)),
        ("ff_geglu", (100, 96, 384)),
        ("ff_geglu", (48, 1280, 5120)),
    ]
    for kind, key in probes:
        for dt in (torch.bfloat16, torch.float32):
            r = compare(kind, key, dt, gen)
            log(f"probe: {kind} {key} {str(dt)[6:]}: max_abs_err "
                f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}, max|plain| "
                f"{r['peak']:.3e}); err/tol {r['err_over_tol']:.3f}")

    log("default: requests routed through diffusiontexturepainting_torch."
        "serving.wire.handle_request_bytes")
    model = TorchConditionalInpainter(resolution=RES, device="cuda")
    log(f"default: model built in {model.init_seconds:.1f} s (full SD-1.5 "
        f"width, random weights, {model.dtype}, {model.config}); unet "
        f"{sum(p.numel() for p in model.unet.parameters()) / 1e6:.1f}M "
        "params")
    _, launches, shapes, n_stamps = run_path("default", model, STEPS)
    check_counts("default", model, STEPS, launches, n_stamps)

    twin = TorchConditionalInpainter(resolution=RES, config=safe_twin_config(),
                                     device="cuda",
                                     weights=model.state_dicts())
    log(f"twin: built from the default model's state_dict in "
        f"{twin.init_seconds:.1f} s")
    twin_first, twin_launches, twin_shapes, _ = run_path("twin", twin,
                                                         TWIN_STEPS)
    check_counts("twin", twin, TWIN_STEPS, twin_launches, n_stamps)
    ours = first_stamp_at(model, TWIN_STEPS).astype(int)
    diff = np.abs(ours - twin_first.astype(int))
    log(f"twin: first stamps of the two configurations at {TWIN_STEPS} "
        f"steps: mean |diff| {diff.mean():.3f} u8 levels, max {diff.max()}, "
        f"{(diff == 0).mean():.4f} exact, {(diff <= 4).mean():.4f} within "
        f"4, {(diff <= 16).mean():.4f} within 16")
    if not diff.mean() <= MAX_MEAN_DIFF:
        raise AssertionError(f"default and safe twin differ by "
                             f"{diff.mean():.3f} levels on average")
    del twin

    record = []
    for name in launches:
        # every shape of either path is checked; the times are weighted by
        # the launches of the path that runs the kernel (the default path,
        # or for K7 the safe twin)
        path = "default" if launches[name] else "safe_twin"
        counts = shapes[name] if launches[name] else twin_shapes[name]
        keys = sorted(set(shapes[name]) | set(twin_shapes[name]), key=str)
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
        k_total = p_total = 0.0
        for key in keys:
            count = counts.get(key, 0)
            for dt in errs:
                r = compare(name, key, dt, gen,
                            timed=dt == torch.bfloat16 and count > 0)
                errs[dt] = max(errs[dt], r["max_abs_err"])
                worst[dt] = max(worst[dt], r["err_over_tol"])
                msg = (f"kernels: {name} {key} {str(dt)[6:]}: max_abs_err "
                       f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}, "
                       f"max|plain| {r['peak']:.3e}); err/tol "
                       f"{r['err_over_tol']:.3f}"
                       + (" (output and statistics)"
                          if r.get("stats_checked") else ""))
                if "kernel_ms" in r:
                    k_total += count * r["kernel_ms"]
                    p_total += count * r["plain_ms"]
                    msg += (f"; {r['kernel_ms']:.4f} ms kernel, "
                            f"{r['plain_ms']:.4f} ms plain, "
                            f"x{count // n_stamps} per stamp")
                log(msg)
        record.append({
            "name": name, "route": "cuda",
            "source": "diffusiontexturepainting_torch/" + SOURCES[name],
            "replaces": REPLACES[name], "path": path,
            "launches": launches[name] or twin_launches[name],
            "launches_safe_twin": twin_launches[name],
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "max_err_over_tol": worst[torch.bfloat16],
            "max_err_over_tol_fp32": worst[torch.float32],
            "ms": k_total / n_stamps, "plain_ms": p_total / n_stamps,
            "ms_is": f"bf16 kernel time per stamp of the {path} path "
                     f"({STEPS if launches[name] else TWIN_STEPS} steps), "
                     "summed over its shapes"})

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
