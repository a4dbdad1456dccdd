"""Batched stamps on one device: the port's ParallelStampEngine.

Port of the JAX package's parallel/serving.py for its data = 1 mesh: a
batch of B stamps, one a request, each with its own canvas, brush,
cond/uncond, draws and settings (cfg_weight, tg_weight, tg_steps,
context_pad), runs as one stamp program (pipeline/inpaint.py
stamp.batched: the VAE encode at 2B, the UNet at 3B, the decode at B), at
the serving model's operating point (its scheduler, DeepCache spec and f32
final step) and on the legs its configuration picks. The program is the
model's engine's (core/engine.py): on CUDA a CUDA graph per batch size,
captured at the first batch of that size, as the JAX package compiles its
batched program at its first batch, and replayed after. The JAX package traces
its batched program from the safe twin because Pallas could not lower the
vmap; the port's kernels take a batch, so the default configuration's
batch runs the fused kernels.
"""

from __future__ import annotations

import numpy as np
import torch


class ParallelStampEngine:
    """Batched stamps of a TorchConditionalInpainter `model`."""

    def __init__(self, model):
        self.model = model

    def stamp_fn(self, steps: int):
        """The stamp function of `steps` at the model's operating point: the
        model's own engine Stamp, built once per (scheduler, steps,
        DeepCache spec, f32 final step) and shared with its solo stamps; its
        programs are per resolution and batch size. Every caller runs on
        the service's one worker."""
        return self.model._stamp_fn(steps)

    def stamp_batch(self, canvases_u8, brushes, conds, unconds, enc_noise,
                    init_latents, cfg_weights, tg_weights, tg_steps,
                    context_pads, steps: int, step_noise=None):
        """B stamps as one.

        canvases_u8 (B, H, W, 4) uint8; brushes (B, H, W, 3) in [0, 1];
        conds and unconds (B, L, D); enc_noise (B, 2, H/8, W/8, 4), each
        request's (masked image, context) posterior draws; init_latents
        (B, H/8, W/8, 4); step_noise (B, n_iters, H/8, W/8, 4) or None; the
        settings B host values each. Arrays may be numpy or tensors.
        Returns (raw_u8, composited_u8), each (B, H, W, 3) uint8 on the
        model's device."""
        dev = self.model.device
        put = lambda a: (a if isinstance(a, torch.Tensor)
                         else torch.from_numpy(np.asarray(a))).to(dev)
        canvases_u8, brushes, conds, unconds, enc_noise, init_latents = (
            put(a) for a in (canvases_u8, brushes, conds, unconds,
                             enc_noise, init_latents))
        fn = self.stamp_fn(steps)
        # branch-major, as the batched stamp runs its encode
        enc = torch.cat([enc_noise[:, 0], enc_noise[:, 1]], dim=0)
        if step_noise is not None:
            step_noise = put(step_noise).transpose(0, 1)
        return fn.batched(canvases_u8, brushes, conds, unconds, enc,
                          init_latents, list(cfg_weights), list(tg_weights),
                          list(tg_steps), list(context_pads), step_noise)
