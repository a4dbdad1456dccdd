"""What DeepCache's shallow UNet eval costs against the full one.

    python -m diffusiontexturepainting_torch.tools.deepcache_split
    python -m diffusiontexturepainting_torch.tools.deepcache_split \\
        --resolution 512 --n 40
    python -m diffusiontexturepainting_torch.tools.deepcache_split \\
        --device cpu --tiny --resolution 64 --n 2   # plain versions

The port of the JAX repository's tools/bench_deepcache_split.py: the
full-width UNet of the default configuration (seeded random weights, bf16
on a card), at batch 3 (the CFG triple), t = 500, zero context, timed as

  full     forward_full (the whole UNet; returns the noise and the cache)
  shallow  forward_shallow (the outermost level against a fixed cache)
  level0   conv_in and the outermost down level (the prefix both share)

each over a chain of --n evals whose input is rebuilt from the previous
eval's noise (so no eval can be skipped or overlap the next), CUDA events
around the chain, best of 3, ms an eval; and the device kernel time of one
eval of each (torch.profiler: the sum of its CUDA kernels). full - shallow
is what a shallow model call saves; shallow - level0 the outermost up
level's cost. Each --resolution given (default 256 and 512) is one latent
size. Prints one line a variant, then one JSON line (also to --json-out)
with the card's name and power limit. Without a card and without --device
cpu it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..core.config import (
    PipelineConfig,
    UNetConfig,
    tiny_unet_config,
)


def build_unet(device, tiny: bool):
    """The serving UNet of the default configuration, seeded random
    weights, in the serving dtype (bf16 on a card, fp32 on the CPU)."""
    import dataclasses

    from ..models.unet import UNet2DCondition
    from ..weights.random_init import random_state_dict

    p = PipelineConfig()
    cfg = dataclasses.replace(
        tiny_unet_config() if tiny else UNetConfig(),
        fused_resnet=p.fused_unet_resnet, fused_ff=p.fused_unet_ff,
        fused_norm=p.fused_unet_norm, fused_attn=p.fused_unet_attn)
    with torch.device(device):
        unet = UNet2DCondition(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    unet.load_state_dict(random_state_dict(unet, gen))
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    return unet.to(dtype).eval().requires_grad_(False)


def variants(unet, t, ctx, cache):
    """{name: eval(x (3, h, w, 9)) -> (3, h, w, 4) fp32}."""
    def level0(x):
        temb = unet._temb(t, x.shape[0], x.device)
        h, _ = unet._level0(x, temb, ctx.to(unet.conv_in.weight.dtype))
        return h[..., :4].float()

    return {"full": lambda x: unet.forward_full(x, t, ctx)[0],
            "shallow": lambda x: unet.forward_shallow(x, t, ctx, cache),
            "level0": level0}


def chain(step, x, n: int):
    """n evals, each input rebuilt from the previous eval's noise."""
    for _ in range(n):
        eps = step(x)
        x = torch.cat([eps, eps, eps[..., :1]], dim=-1).to(x.dtype)
    return x


def chain_ms(step, x, n: int, tries: int = 3) -> float:
    """Best of `tries` CUDA-event timings of chain(step, x, n); ms an
    eval."""
    chain(step, x, 1)
    best = float("inf")
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(step, x, n)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def device_ms(step, x) -> float | None:
    """The CUDA kernels' time of one eval under torch.profiler, or None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    total = sum(k.self_device_time_total for k in prof.key_averages()
                if k.device_type.name == "CUDA") / 1e3
    return total or None


@torch.inference_mode()
def measure(unet, resolution: int, n: int, timed: bool) -> dict:
    device = next(unet.parameters()).device
    h = resolution // 8
    x = torch.zeros((3, h, h, 9), device=device)
    t = torch.full((3,), 500.0, device=device)
    ctx = torch.zeros((3, 14, unet.cfg.cross_attention_dim), device=device,
                      dtype=unet.conv_in.weight.dtype)
    _, cache = unet.forward_full(x, t, ctx)
    print(f"cache feature: {tuple(cache.shape)} {cache.dtype}",
          file=sys.stderr)
    out = {}
    for name, step in variants(unet, t, ctx, cache).items():
        if not timed:
            tic = time.perf_counter()
            y = chain(step, x, n)
            out[name] = {"host_ms": (time.perf_counter() - tic) * 1e3 / n,
                         "finite": bool(torch.isfinite(y).all())}
            continue
        ms = chain_ms(step, x, n)
        out[name] = {"ms": ms, "device_ms": device_ms(step, x)}
        print(f"{name}: {ms:.2f} ms/eval (batch 3, {resolution}px), device "
              f"{out[name]['device_ms']} ms", flush=True)
    if timed:
        f, s, l0 = (out[k]["ms"] for k in ("full", "shallow", "level0"))
        out["summary"] = {"shallow_over_full": s / f,
                          "level0_share_of_full": l0 / f,
                          "last_up_level_ms": s - l0,
                          "saved_per_shallow_ms": f - s}
        print(f"shallow/full = {s / f:.2f}; level0 share of full = "
              f"{l0 / f:.2f}; last-up-level ~= {s - l0:.2f} ms; DeepCache "
              f"saves {f - s:.2f} ms per cached step", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolution", type=int, action="append", default=None,
                    help="repeatable (default: 256 and 512)")
    ap.add_argument("--n", type=int, default=40,
                    help="evals a timed chain")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test UNet (with --device cpu)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("deepcache_split: no CUDA device (--device cpu --tiny runs "
                  "the plain versions, untimed)", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)} ({card})", flush=True)
    unet = build_unet(args.device, args.tiny)
    record = {"device": (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else "cpu"),
              "card": card, "n": args.n, "points": {}}
    for res in args.resolution or [256, 512]:
        record["points"][str(res)] = measure(unet, res, args.n,
                                             args.device == "cuda")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
