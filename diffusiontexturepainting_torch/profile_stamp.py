"""Where one stamp's time goes on the GPU.

    python -m diffusiontexturepainting_torch.profile_stamp \
        [--config default|safe_twin|slotted] [--resolution 256|512|1024]
        [--steps 20] [--stamps 10] [--in-pad]
        [--deep-cache-interval 2|FSSF] [--f32-final-step]

Builds the full-width serving model (seeded random weights, bf16) in the
default configuration (every fused switch on), the safe twin (module legs
only) or the slotted one (default plus the head-slotted self-attention)
and prints, each beside the card's name and power limit (with --in-pad,
ops.conv3x3._IN_PAD set first: the in-kernel-padding kernels K12a/b take
every call of K7/K4, as chip_smoke.py's twin_inpad path runs them; with
--deep-cache-interval, DeepCache at that interval or pattern, applied at
any step count (deep_cache_min_steps 1); with --f32-final-step, the last
model call on the fp32 UNet; the stamp's schedule of model calls is
printed):
  - the served stamp (model.generate_u8, a replay of the engine's CUDA
    graph of the point, core/engine.py) beside the eager stamp function at
    the same point (the model's stamp functions swapped for their `.eager`
    while it runs: eager_stamps): the capture's seconds and the engine
    pool's bytes, the wall time of `--stamps` unprofiled stamps of each
    (after two warm-up stamps): median, quartiles, min and max; the first
    served stamp after the warm-up beside the later ones; one replay's
    CUDA-event time (the device's time for the stamp's kernels, with no
    host gap) and each path's busy share of its median wall;
  - CUDA-event times of one UNet eval (the CFG batch of 3), one VAE encode
    (batch 2) and one VAE decode at the stamp's shapes, and of one shallow
    eval and one fp32 final eval where the stamp has them;
  - the host time to enqueue one UNet eval against its time to finish, the
    top-level PyTorch operations that eval issues, and the Python functions
    that took the most host time in it (cProfile, which slows every call:
    compare trees, not absolute times);
  - one stamp of each path under torch.profiler: its device kernel time,
    the device's busy share of that stamp's wall, and the kernels that
    took the most device time.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import dataclasses
import pstats
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .core.config import (
    CONFIG_NAMES,
    parse_deep_cache_spec,
    pipeline_config,
)
from .ops import conv3x3
from .pipeline.torch_model import TorchConditionalInpainter


def cuda_ms(fn, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def eager_stamps(model):
    """Inside, the model serves its per-request and session stamps through
    the eager stamp functions (each cached Stamp's `.eager`), for a
    measurement beside the engine's replays; its engine is untouched, and
    the served functions come back on leaving."""
    saved = dict(model._stamp_fns)
    model._stamp_fns.update({k: fn.eager for k, fn in saved.items()})
    try:
        yield
    finally:
        model._stamp_fns.update(saved)


def percentiles(walls) -> str:
    p25, p50, p75 = np.percentile(walls, [25, 50, 75])
    return (f"median {p50:.1f} p25 {p25:.1f} p75 {p75:.1f} "
            f"min {min(walls):.1f} max {max(walls):.1f}")


def replay_ms(program, iters: int = 3) -> float:
    """The median CUDA-event time of one replay of a captured program: the
    device's time for its kernels, launched with no host gap."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        program.graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=CONFIG_NAMES, default="default")
    parser.add_argument("--resolution", type=int, default=256,
                        choices=(256, 512, 1024))
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--stamps", type=int, default=10)
    parser.add_argument("--top", type=int, default=25,
                        help="kernels listed from the profiled stamp")
    parser.add_argument("--in-pad", action="store_true",
                        help="set ops.conv3x3._IN_PAD (K12a/b for K7/K4)")
    parser.add_argument("--deep-cache-interval", type=parse_deep_cache_spec,
                        default=1, help="DeepCache interval or pattern")
    parser.add_argument("--f32-final-step", action="store_true")
    args = parser.parse_args(argv)
    res = args.resolution
    conv3x3._IN_PAD = args.in_pad

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"config: {args.config}" + (", _IN_PAD set" if args.in_pad else ""))
    config = dataclasses.replace(
        pipeline_config(args.config),
        deep_cache_interval=args.deep_cache_interval, deep_cache_min_steps=1,
        f32_final_step=args.f32_final_step)
    model = TorchConditionalInpainter(res, config=config, device="cuda")
    schedule = model._stamp_fn(args.steps).schedule
    print(f"model calls: {' '.join(schedule)} (DeepCache "
          f"{args.deep_cache_interval!r}, f32 final step "
          f"{args.f32_final_step})")
    rng = np.random.default_rng(0)
    model.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    canvas = np.zeros((res, res, 4), np.uint8)
    canvas[:res // 4, :, 3] = 255
    canvas[:res // 4, :, :3] = 64
    settings = dict(steps=args.steps, cfg_weight=2.0, tg_weight=1.0,
                    tg_steps=args.steps, context_pad=150)

    def stamp():
        model.generate_u8(canvas, **settings)

    def timed():
        torch.cuda.synchronize()
        tic = time.perf_counter()
        stamp()
        return (time.perf_counter() - tic) * 1e3

    counter = model.request_counter
    warm = model.warmup([(res, args.steps)])[(res, args.steps)]
    key = model._stamp_fn(args.steps).program_key(res, 1)
    captured = model.engine.captures[key]
    print(f"served program {key}: warm-up {warm:.2f} s, of which the eager "
          f"pass and the capture {captured['seconds']:.2f} s; engine pool "
          f"{captured['pool_bytes'] / 2**30:.2f} GiB reserved")
    first = timed()
    stamp()
    walls = {"graph": [timed() for _ in range(args.stamps)]}
    with eager_stamps(model):
        for _ in range(2):
            stamp()
        walls["eager"] = [timed() for _ in range(args.stamps)]
    model.request_counter = counter
    p50 = float(np.median(walls["graph"]))
    device = replay_ms(model.engine.programs[key])
    for path, w in walls.items():
        print(f"stamp wall ms, {path} ({res}^2, {args.steps} steps, "
              f"{model.dtype}, n={args.stamps}): {percentiles(w)}; busy "
              f"share {device / np.median(w):.3f}")
    print(f"one replay: {device:.2f} ms of device time (CUDA events); the "
          f"first served stamp after the warm-up {first:.1f} ms against "
          f"the later ones' median {p50:.1f}")

    lat = res // 8
    dev, dt = model.device, model.dtype
    with torch.inference_mode():
        sample = torch.randn(3, lat, lat, 9, device=dev)
        t = torch.full((3,), 500.0, device=dev)
        ctx = torch.randn(3, 14, model.unet.cfg.cross_attention_dim,
                          device=dev, dtype=dt)
        images = torch.randn(2, res, res, 3, device=dev)
        z = torch.randn(1, lat, lat, 4, device=dev)
        print(f"unet eval (batch 3, {lat}^2 latent): "
              f"{cuda_ms(lambda: model.unet(sample, t, ctx)):.2f} ms")
        print(f"vae encode (batch 2, {res}^2): "
              f"{cuda_ms(lambda: model.vae_encoder(images)):.2f} ms")
        print(f"vae decode (batch 1): "
              f"{cuda_ms(lambda: model.vae_decoder(z)):.2f} ms")
        if "shallow" in schedule:
            _, cache = model.unet.forward_full(sample, t, ctx)
            shallow = cuda_ms(lambda: model.unet.forward_shallow(
                sample, t, ctx, cache))
            print(f"shallow unet eval: {shallow:.2f} ms")
        if "final" in schedule:
            print(f"fp32 final unet eval: "
                  f"{cuda_ms(lambda: model.final_unet(sample, t, ctx)):.2f}"
                  " ms")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.unet(sample, t, ctx)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"unet eval: host enqueue {(t1 - t0) * 1e3:.2f} ms, device "
              f"done after {(t2 - t0) * 1e3:.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        model.unet(sample, t, ctx)
        torch.cuda.synchronize()
    top = [e for e in prof.events() if e.cpu_parent is None
           and e.name.startswith("aten::")]
    print(f"unet eval: {len(top)} top-level PyTorch operations issued")

    host = cProfile.Profile()
    with torch.inference_mode():
        torch.cuda.synchronize()
        host.enable()
        model.unet(sample, t, ctx)
        host.disable()
        torch.cuda.synchronize()
    own = sorted(pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][2])
    print(f"unet eval under cProfile: {sum(v[2] for _, v in own) * 1e3:.2f} "
          "ms of host time; the functions with the most of their own:")
    for (file, line, name), (_, calls, tt, ct, _) in own[:args.top]:
        where = f"{Path(file).name}:{line} " if line else ""
        print(f"  {(where + name)[:70]:<70} {tt * 1e3:8.2f} ms own, "
              f"{ct * 1e3:8.2f} ms with callees, x{calls}")

    for path, ctx in (("graph", contextlib.nullcontext()),
                      ("eager", eager_stamps(model))):
        with ctx, profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            tic = time.perf_counter()
            stamp()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - tic) * 1e3
        rows = [k for k in prof.key_averages()
                if k.device_type.name == "CUDA"]
        device_ms = sum(k.self_device_time_total for k in rows) / 1e3
        median = float(np.median(walls[path]))
        print(f"profiled stamp, {path}: wall {wall:.1f} ms, device kernel "
              f"time {device_ms:.1f} ms, busy share {device_ms / wall:.3f} "
              f"of the profiled wall, {device_ms / median:.3f} of the "
              "unprofiled median")
        for k in sorted(rows,
                        key=lambda k: -k.self_device_time_total)[:args.top]:
            print(f"  {k.key[:90]:<90} {k.self_device_time_total / 1e3:8.2f}"
                  f" ms x{k.count}")


if __name__ == "__main__":
    main()
