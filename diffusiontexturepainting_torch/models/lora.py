"""LoRA adapters for the UNet's attention projections.

Port of diffusiontexturepainting_tpu/models/lora.py. The factors live in
their own dict, apart from the frozen base weights, keyed by the module
path of the projection ('down_blocks.0.attentions.0.transformer_blocks.0.
attn1.to_q', 'mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0'):
{name: {"down": (rank, in), "up": (out, rank)}}. At train time the merge
W_eff = W + scale * up @ down is made in every step from the fp32 base
weight, so gradients reach the factors while the base stays frozen; the
export merges once. nn.Linear's weight is (out, in), so the delta is
up @ down where the JAX package's flax kernels (in, out) take
down.T @ up.T. weights/from_jax.py maps the names to the JAX package's
('down_0_attn_0/transformer_blocks_0/attn1/to_q') both ways.
"""

from __future__ import annotations

import torch
import torch.nn as nn

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def attention_projections(unet: nn.Module) -> dict:
    """{name: nn.Linear} for every attention projection of the UNet:
    attn1 and attn2 x to_q, to_k, to_v, to_out.0 of each transformer block
    (128 at SD-1.5 width), in module order (the JAX package's
    _iter_attention_paths)."""
    out = {}
    for name, module in unet.named_modules():
        if name.rsplit(".", 1)[-1] not in ("attn1", "attn2"):
            continue
        for target in LORA_TARGETS:
            proj = getattr(module, target, None)
            if proj is None:
                continue
            if target == "to_out":
                out[f"{name}.to_out.0"] = proj[0]
            else:
                out[f"{name}.{target}"] = proj
    return out


def init_lora_params(unet: nn.Module, rank: int = 4,
                     generator: torch.Generator | None = None) -> dict:
    """One (down, up) fp32 pair per attention projection: down ~ N(0, 1) /
    rank, up = 0, so the adapter starts as the identity (diffusers'
    LoRALinearLayer init, as the JAX package draws it). The draws follow
    the projections' order from `generator`."""
    lora = {}
    for name, proj in attention_projections(unet).items():
        out_dim, in_dim = proj.weight.shape
        dev = proj.weight.device
        down = torch.randn((rank, in_dim), generator=generator,
                           dtype=torch.float32, device=dev) / rank
        lora[name] = {"down": down,
                      "up": torch.zeros((out_dim, rank), dtype=torch.float32,
                                        device=dev)}
    return lora


def merge_lora(base: dict, lora_params: dict, scale: float = 1.0,
               dtype=None) -> dict:
    """{name + '.weight': W + scale * up @ down} for every factor pair,
    computed in fp32 from `base` ({name + '.weight': the fp32 base weight},
    a state_dict or any part of one holding the projections) and then cast
    to `dtype` where given. Differentiable in the factors; the base enters
    as it is. KeyError names a factor pair without a base weight."""
    merged = {}
    for name, factors in lora_params.items():
        key = f"{name}.weight"
        if key not in base:
            raise KeyError(f"LoRA target {name} not found in the UNet's "
                           "weights")
        w = base[key].float() + scale * (factors["up"] @ factors["down"])
        merged[key] = w if dtype is None else w.to(dtype)
    return merged


def num_lora_params(lora_params: dict) -> int:
    return sum(t.numel() for f in lora_params.values() for t in f.values())
