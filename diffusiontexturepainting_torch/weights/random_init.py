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


def build_pipeline(unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                   patch_cfg: PatchEncoderConfig, device, dtype,
                   fused_vae: tuple = (False, False),
                   dtype_overrides: dict | None = None) -> dict:
    """The four components on `device`, in eval mode, their weights not yet
    set: each in `dtype` unless `dtype_overrides` names it ({"unet":
    torch.float32}: the JAX package's dtype_overrides). A component keeps
    its weights in its own dtype, so an fp32 one holds the source values
    and a bf16 one their rounding. fused_vae: the (encoder, decoder)
    execution legs; the parameters are the same either way."""
    overrides = dict(dtype_overrides or {})
    with torch.device(device):
        models = {
            "unet": UNet2DCondition(unet_cfg),
            "vae_encoder": VAEEncoder(vae_cfg, fused=fused_vae[0]),
            "vae_decoder": VAEDecoder(vae_cfg, fused=fused_vae[1]),
            "patch_encoder": ConditionPatchEncoder(patch_cfg),
        }
    unknown = set(overrides) - set(models)
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}; choose "
                         f"from {sorted(models)}")
    for name, m in models.items():
        m.to(overrides.get(name, dtype)).eval().requires_grad_(False)
    return models


def complete_weights(models: dict, weights: dict | None = None,
                     seed: int = 0) -> dict:
    """{name: state_dict} for every component of `models`: `weights`' where
    it has one, else the seeded random fp32 weights on the module's device,
    the values the component has in a model whose every component is
    random (the generator walks the components in order, drawing for given
    ones too where a later one is random)."""
    weights = weights or {}
    names = list(models)
    random_upto = max((i for i, n in enumerate(names) if n not in weights),
                      default=-1)
    gen = None
    out = {}
    for i, (name, m) in enumerate(models.items()):
        if i <= random_upto:
            if gen is None:
                device = next(m.parameters()).device
                gen = torch.Generator(device=device).manual_seed(seed)
            sd = random_state_dict(m, gen)
        out[name] = weights[name] if name in weights else sd
    return out


def load_weights(models: dict, weights: dict | None = None,
                 seed: int = 0) -> None:
    """Load `weights` (a state_dict per component; load_state_dict casts
    them to each module's dtype) into `models`; a component that `weights`
    lacks gets the seeded random weights (complete_weights)."""
    for name, sd in complete_weights(models, weights, seed).items():
        models[name].load_state_dict(sd)
