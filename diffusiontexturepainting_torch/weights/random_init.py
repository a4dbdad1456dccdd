"""Seeded random weights, made on the device (no checkpoint needed).

The latency of the pipeline does not depend on the weights, so serving and
measurement without a trained checkpoint use these. The distributions
follow the JAX package's flax initializers: LeCun-normal kernels (std
1/sqrt(fan_in)), zero biases, unit norm scales, N(0, 0.02) CLIP class and
position embeddings, N(0, 1) uncond vector.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import (
    PatchEncoderConfig,
    UNetConfig,
    VAEConfig,
)
from ..models.layers import GroupNorm32, LayerNorm32
from ..models.patch_encoder import ConditionPatchEncoder
from ..models.unet import UNet2DCondition
from ..models.vae import VAEDecoder, VAEEncoder


@torch.no_grad()
def random_state_dict(module: nn.Module, generator: torch.Generator) -> dict:
    """A fresh fp32 value for every parameter of `module`, drawn from
    `generator` in the order of named_parameters (deterministic for a given
    seed and device)."""
    norms = (GroupNorm32, LayerNorm32)
    sd = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            v = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if isinstance(m, norms):
                v.fill_(1.0 if pname == "weight" else 0.0)
            elif pname == "bias":
                v.zero_()
            elif pname == "class_embedding" or isinstance(m, nn.Embedding):
                v.normal_(0.0, 0.02, generator=generator)
            elif pname == "uncond_vector":
                v.normal_(0.0, 1.0, generator=generator)
            else:  # LeCun normal; conv (kH, kW, Cin, Cout), linear (out, in)
                fan_in = p.shape[1] if p.dim() == 2 else p[..., 0].numel()
                v.normal_(0.0, fan_in**-0.5, generator=generator)
            sd[f"{mname}.{pname}" if mname else pname] = v
    return sd


def init_pipeline(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                  patch_cfg: PatchEncoderConfig, device, dtype,
                  seed: int = 0, fused_vae: tuple = (False, False),
                  weights: dict | None = None) -> dict:
    """Build the four components on `device` in `dtype`, then load seeded
    random weights into them (load_state_dict casts them to `dtype`), or
    `weights`, a state_dict per component. fused_vae: the (encoder,
    decoder) execution legs; the parameters are the same either way."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        models = {
            "unet": UNet2DCondition(unet_cfg),
            "vae_encoder": VAEEncoder(vae_cfg, fused=fused_vae[0]),
            "vae_decoder": VAEDecoder(vae_cfg, fused=fused_vae[1]),
            "patch_encoder": ConditionPatchEncoder(patch_cfg),
        }
    for name, m in models.items():
        m.to(dtype).eval().requires_grad_(False)
        m.load_state_dict(weights[name] if weights is not None
                          else random_state_dict(m, gen))
    return models
