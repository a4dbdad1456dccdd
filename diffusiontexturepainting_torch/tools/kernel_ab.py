"""Eager and CUDA-graph device time of the served K3, K4, K6 and K7
wrappers at their served shapes, for comparing two checkouts on one card.

    python diffusiontexturepainting_torch/tools/kernel_ab.py --json-out A.json
    PYTHONPATH=<another checkout> python \\
        diffusiontexturepainting_torch/tools/kernel_ab.py --json-out B.json

Run by path, the script imports the package found first on PYTHONPATH (or
its own checkout's), so the same script times another checkout's kernels
through the wrappers both share: ops.ff_geglu.ff_geglu (K3) at one UNet
eval's feed-forward shapes at 256^2, 512^2 and 1024^2,
ops.conv3x3.upsample2x_conv3x3 (K4) at the UNet's upsample shapes at the
same points, ops.gn_conv.upconv_stream (K6, statistics on) at the VAE
decoder's three upsamplers at the same points (batch 1), and
ops.conv3x3.conv3x3 (K7) at every shape the safe twin's 256^2 stamp runs
it at (TWIN_K7). Seeded normal bf16 inputs. Each row: ms a call (CUDA events
over back-to-back calls, best of 4: the host's launch cost included) and
device_ms (the same calls replayed from a CUDA graph). Without a card it
exits nonzero. Prints one line per row, then one JSON line naming the
package's path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    # run by path: the checkout holding this script comes after PYTHONPATH
    sys.path.append(str(Path(__file__).resolve().parents[2]))

import diffusiontexturepainting_torch  # noqa: E402
from diffusiontexturepainting_torch.ops import (  # noqa: E402
    conv3x3,
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


def _rows(gen):
    rows = []
    rnd = lambda *s, std=1.0: (torch.randn(s, generator=gen, device="cuda")
                               * std).bfloat16()
    for N, C, inner, tag in FF:
        x, res = rnd(N, C), rnd(N, C)
        w0, b0 = rnd(2 * inner, C, std=C**-0.5), rnd(2 * inner, std=0.1)
        w2, b2 = rnd(C, inner, std=inner**-0.5), rnd(C, std=0.1)
        call = lambda: ff_geglu.ff_geglu(x, w0, b0, w2, b2, res)
        rows.append({"kernel": "K3", "tag": tag, "shape": [N, C, inner],
                     "ms": _common.event_ms(call),
                     "device_ms": _common.graph_ms(call)})
    for B, H, W, C, tag in UP:
        x = rnd(B, H, W, C)
        w, b = rnd(3, 3, C, C, std=(9 * C) ** -0.5), rnd(C, std=0.1)
        taps = conv3x3.fold_upsample_weights(w)
        call = lambda: conv3x3.upsample2x_conv3x3(x, w, b, taps)
        rows.append({"kernel": "K4", "tag": tag, "shape": [B, H, W, C, C],
                     "ms": _common.event_ms(call),
                     "device_ms": _common.graph_ms(call)})
    for B, H, W, C, tag in UPSTATS:
        x = rnd(B, H, W, C)
        w, b = rnd(3, 3, C, C, std=(9 * C) ** -0.5), rnd(C, std=0.1)
        taps = conv3x3.fold_upsample_weights(w)
        call = lambda: gn_conv.upconv_stream(x, w, b, taps)
        rows.append({"kernel": "K6", "tag": tag, "shape": [B, H, W, C, C],
                     "ms": _common.event_ms(call),
                     "device_ms": _common.graph_ms(call)})
    for B, H, W, cin, cout, tag in TWIN_K7:
        x = rnd(B, H, W, cin)
        w, b = rnd(3, 3, cin, cout, std=(9 * cin) ** -0.5), rnd(cout, std=0.1)
        call = lambda: conv3x3.conv3x3(x, w, b)
        rows.append({"kernel": "K7", "tag": tag,
                     "shape": [B, H, W, cin, cout],
                     "ms": _common.event_ms(call),
                     "device_ms": _common.graph_ms(call)})
    return rows


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
              f"{r['device_ms']:.4f} ms", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "card": card,
              "package": package, "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
