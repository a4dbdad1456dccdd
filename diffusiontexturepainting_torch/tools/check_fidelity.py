"""Fidelity of the port's operating points: bf16 against fp32, DeepCache
against the exact schedule, the f32 final step against all-fp32.

    python -m diffusiontexturepainting_torch.tools.check_fidelity
    python -m diffusiontexturepainting_torch.tools.check_fidelity --bisect
    python -m diffusiontexturepainting_torch.tools.check_fidelity --control
    python -m diffusiontexturepainting_torch.tools.check_fidelity --quick
    python -m diffusiontexturepainting_torch.tools.check_fidelity \\
        --deep-cache 2,4,FSSF,FSFS [--resolution 512 --steps 4]
    python -m diffusiontexturepainting_torch.tools.check_fidelity \\
        --final-step [--resolution 512 --steps 4]
    python -m diffusiontexturepainting_torch.tools.check_fidelity \\
        --device cpu --tiny --quick --resolution 64   # plain versions

The port of the JAX repository's tools/check_bf16_fidelity.py: the same
stamp (the same seeded weights, the same draws at the same request
counter, the same canvas and brush) through the full-width serving model
(TorchConditionalInpainter, default configuration) at two operating points,
and the deviation of the two u8 stamps: max and mean |diff| over 255, PSNR
and the fraction of pixels off by more than 1e-2. The modes, as the tool's:

  (default)     bf16 against fp32 at (256, 20) and (512, 4)
  --bisect      bf16 everywhere but one component in fp32 (unet,
                vae_encoder, vae_decoder), against all-fp32, at (512, 4)
  --control     fp32 against fp32 with one canvas byte's lowest bit
                flipped, at (512, 4): the sampler's own sensitivity
  --quick       (256, 4) only
  --deep-cache  each DeepCache spec against the exact schedule, both bf16,
                at --resolution / --steps (512, 4)
  --final-step  bf16 with the f32 final step against all-fp32, at
                --resolution / --steps (512, 4)

"bf16" is the model as served on a card (every component in bf16); "fp32"
is every component overridden to fp32 (dtype_overrides), which keeps the
source weights. DeepCache specs apply from 2 steps on
(deep_cache_min_steps 2, as the tool sets it). Prints one line a
comparison, then one JSON line (also to --json-out), with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from ..core.config import COMPONENTS, PipelineConfig, parse_deep_cache_spec


def _inputs(resolution, steps):
    """The tool's brush, canvas (the top half painted) and settings."""
    rng = np.random.default_rng(0)
    brush = rng.random((resolution, resolution, 3)).astype(np.float32)
    canvas = np.zeros((resolution, resolution, 4), np.float32)
    canvas[: resolution // 2, :, :3] = rng.random(
        (resolution // 2, resolution, 3))
    canvas[: resolution // 2, :, 3] = 1.0
    canvas_u8 = (canvas * 255).astype(np.uint8)
    settings = dict(steps=steps, cfg_weight=2.0, tg_weight=1.0,
                    tg_steps=steps, context_pad=150)
    return brush, canvas_u8, settings


def _stats(tag, a, b):
    """The tool's statistics of two u8 stamps, printed and returned."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    diff = np.abs(a - b) / 255.0
    mse = np.mean(((a - b) / 255.0) ** 2)
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"{tag}: max|diff| {diff.max():.4f}  mean {diff.mean():.5f}  "
          f"PSNR {psnr:.1f} dB  (frac>1e-2: {(diff > 1e-2).mean():.3f})",
          flush=True)
    return {"tag": tag, "max": float(diff.max()), "mean": float(diff.mean()),
            "psnr_db": None if mse == 0 else float(psnr),
            "frac_gt_1e-2": float((diff > 1e-2).mean())}


class _Runner:
    """Builds one model a run (the device and size of the command line)
    and returns its first stamp."""

    def __init__(self, device, tiny):
        self.device, self.tiny = device, tiny

    def __call__(self, resolution, settings, brush, canvas_u8, fp32=(),
                 deep_cache=1, f32_final_step=False):
        """`fp32`: the components computed in fp32 (all of them: the fp32
        model)."""
        import torch

        from ..pipeline.torch_model import TorchConditionalInpainter

        config = PipelineConfig(deep_cache_interval=deep_cache,
                                deep_cache_min_steps=2,
                                f32_final_step=f32_final_step)
        model = TorchConditionalInpainter(
            resolution, config=config, device=self.device, tiny=self.tiny,
            dtype_overrides={name: torch.float32 for name in fp32})
        model.set_brush(brush)
        out = model.generate_u8(canvas_u8, **settings)
        del model
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return out


def run_point(run, resolution, steps):
    brush, canvas_u8, settings = _inputs(resolution, steps)
    ref = run(resolution, settings, brush, canvas_u8, fp32=COMPONENTS)
    out = run(resolution, settings, brush, canvas_u8)
    return [_stats(f"{resolution}px/{steps}-step", ref, out)]


def run_bisect(run, resolution=512, steps=4):
    brush, canvas_u8, settings = _inputs(resolution, steps)
    ref = run(resolution, settings, brush, canvas_u8, fp32=COMPONENTS)
    base = run(resolution, settings, brush, canvas_u8)
    rows = [_stats(f"{resolution}px/{steps}-step all-bf16", ref, base)]
    for comp in ("unet", "vae_encoder", "vae_decoder"):
        out = run(resolution, settings, brush, canvas_u8, fp32=(comp,))
        rows.append(_stats(f"{resolution}px/{steps}-step bf16 except "
                           f"{comp}=f32", ref, out))
    return rows


def run_control(run, resolution=512, steps=4):
    brush, canvas_u8, settings = _inputs(resolution, steps)
    a = run(resolution, settings, brush, canvas_u8, fp32=COMPONENTS)
    pert = canvas_u8.copy()
    # one bit of one painted byte: the least the wire can change
    pert[0, 0, 0] = pert[0, 0, 0] ^ 1
    b = run(resolution, settings, brush, pert, fp32=COMPONENTS)
    return [_stats(f"{resolution}px/{steps}-step f32 vs "
                   "f32+1LSB-canvas", a, b)]


def run_deep_cache(run, specs, resolution=512, steps=4):
    brush, canvas_u8, settings = _inputs(resolution, steps)
    exact = run(resolution, settings, brush, canvas_u8)
    rows = []
    for spec in specs:
        out = run(resolution, settings, brush, canvas_u8, deep_cache=spec)
        rows.append(_stats(f"{resolution}px/{steps}-step DeepCache[{spec}] "
                           "vs exact (both bf16)", exact, out))
    return rows


def run_final_step(run, resolution=512, steps=4):
    brush, canvas_u8, settings = _inputs(resolution, steps)
    ref = run(resolution, settings, brush, canvas_u8, fp32=COMPONENTS)
    out = run(resolution, settings, brush, canvas_u8, f32_final_step=True)
    return [_stats(f"{resolution}px/{steps}-step bf16 + f32-final-step vs "
                   "all-f32", ref, out)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--bisect", action="store_true")
    mode.add_argument("--control", action="store_true")
    mode.add_argument("--quick", action="store_true")
    mode.add_argument("--deep-cache", default=None,
                      help="comma list of DeepCache specs, e.g. 2,4,FSSF")
    mode.add_argument("--final-step", action="store_true")
    ap.add_argument("--resolution", type=int, default=None,
                    help="the point's size (default: the mode's)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test models (with --device cpu)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    import torch

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("check_fidelity: no CUDA device (--device cpu --tiny runs "
                  "the plain versions)", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)} ({card})", flush=True)
    run = _Runner(args.device, args.tiny)
    res, steps = args.resolution, args.steps
    if args.deep_cache:
        specs = [parse_deep_cache_spec(s) for s in args.deep_cache.split(",")
                 if s.strip()]
        rows = run_deep_cache(run, specs, res or 512, steps or 4)
    elif args.final_step:
        rows = run_final_step(run, res or 512, steps or 4)
    elif args.bisect:
        rows = run_bisect(run, res or 512, steps or 4)
    elif args.control:
        rows = run_control(run, res or 512, steps or 4)
    else:
        points = [(256, 4)] if args.quick else [(256, 20), (512, 4)]
        if res or steps:
            points = [(res or p[0], steps or p[1]) for p in points]
        rows = [r for p in points for r in run_point(run, *p)]
    record = {"device": (torch.cuda.get_device_name(0)
                         if args.device == "cuda" else "cpu"),
              "card": card, "argv": sys.argv[1:] if argv is None else argv,
              "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
