"""The first stamp of chip_smoke.py's default path as uint8, and the
difference of two such stamps.

    python diffusiontexturepainting_torch/first_stamp.py --out A.npy \
        [--resolution 256] [--steps 20]
    python diffusiontexturepainting_torch/first_stamp.py --compare A.npy B.npy

The stamp: the default configuration at full width (seeded random weights,
bf16, on the card), chip_smoke's brush and half-painted canvas, request
counter 2. Run by path, the script imports the diffusiontexturepainting_torch
that comes first on PYTHONPATH, so the stamps of two checkouts (one
unpacked with `git archive` beside the tree) are taken on one card and
compared.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np


def first_stamp(resolution: int, steps: int) -> np.ndarray:
    import torch

    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    if not torch.cuda.is_available():
        raise SystemExit("first_stamp: no CUDA device")
    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    canvas = np.zeros((resolution, resolution, 4), np.uint8)
    canvas[:resolution // 4, :, 3] = 255
    canvas[:resolution // 4, :, :3] = 64
    model = TorchConditionalInpainter(resolution=resolution, device="cuda")
    model.set_brush(brush)
    model.request_counter = 1
    return model.generate_u8(canvas, steps=steps, width=resolution,
                             cfg_weight=2.0, tg_weight=1.0, tg_steps=steps,
                             context_pad=150)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"))
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    if args.compare:
        a, b = (np.load(path).astype(int) for path in args.compare)
        diff = np.abs(a - b)
        print(f"first stamps {args.compare[0]} vs {args.compare[1]}: mean "
              f"|diff| {diff.mean():.4f} u8 levels, max {diff.max()}, "
              f"{(diff == 0).mean():.4f} exact, {(diff <= 1).mean():.4f} "
              f"within 1, {(diff <= 4).mean():.4f} within 4")
        return
    if not args.out:
        parser.error("--out or --compare")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    stamp = first_stamp(args.resolution, args.steps)
    np.save(args.out, stamp)
    print(f"{card}: first stamp {args.resolution}^2 / {args.steps} steps "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
