"""Where one stamp's time goes on the GPU.

    python -m diffusiontexturepainting_torch.profile_stamp \
        [--config default|safe_twin] [--stamps 10]

Builds the full-width serving model (seeded random weights, bf16) in the
default configuration (every fused switch on) or the safe twin (module legs
only) and prints, each beside the card's name and power limit:
  - the wall time of `--stamps` unprofiled stamps (after two warm-up
    stamps): median, quartiles, min and max;
  - CUDA-event times of one UNet eval (the CFG batch of 3), one VAE encode
    (batch 2) and one VAE decode at the stamp's shapes;
  - the host time to enqueue one UNet eval against its time to finish, and
    the top-level PyTorch operations that eval issues;
  - one stamp under torch.profiler: its device kernel time, the device's
    busy share of that stamp's wall, and the kernels that took the most
    device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .core.config import PipelineConfig, safe_twin_config
from .pipeline.torch_model import TorchConditionalInpainter

CONFIGS = {"default": PipelineConfig(), "safe_twin": safe_twin_config()}


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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS),
                        default="default")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--stamps", type=int, default=10)
    parser.add_argument("--top", type=int, default=25,
                        help="kernels listed from the profiled stamp")
    args = parser.parse_args(argv)
    res = args.resolution

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"config: {args.config}")
    model = TorchConditionalInpainter(res, config=CONFIGS[args.config],
                                      device="cuda")
    rng = np.random.default_rng(0)
    model.set_brush(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    canvas = np.zeros((res, res, 4), np.uint8)
    canvas[:res // 4, :, 3] = 255
    canvas[:res // 4, :, :3] = 64
    settings = dict(steps=args.steps, cfg_weight=2.0, tg_weight=1.0,
                    tg_steps=args.steps, context_pad=150)

    def stamp():
        model.generate_u8(canvas, **settings)

    for _ in range(2):
        stamp()
    walls = []
    for _ in range(args.stamps):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        stamp()
        walls.append((time.perf_counter() - tic) * 1e3)
    p25, p50, p75 = np.percentile(walls, [25, 50, 75])
    print(f"stamp wall ms ({res}^2, {args.steps} steps, {model.dtype}, "
          f"n={args.stamps}): median {p50:.1f} p25 {p25:.1f} p75 {p75:.1f} "
          f"min {min(walls):.1f} max {max(walls):.1f}")

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        stamp()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) * 1e3
    rows = [k for k in prof.key_averages() if k.device_type.name == "CUDA"]
    device_ms = sum(k.self_device_time_total for k in rows) / 1e3
    print(f"profiled stamp: wall {wall:.1f} ms, device kernel time "
          f"{device_ms:.1f} ms, busy share {device_ms / wall:.3f} of the "
          f"profiled wall, {device_ms / p50:.3f} of the unprofiled median")
    for k in sorted(rows, key=lambda k: -k.self_device_time_total)[:args.top]:
        print(f"  {k.key[:90]:<90} {k.self_device_time_total / 1e3:8.2f} ms "
              f"x{k.count}")


if __name__ == "__main__":
    main()
