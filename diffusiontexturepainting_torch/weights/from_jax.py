"""JAX-package parameter trees -> this package's (diffusers-named) state_dicts.

The inverse of diffusiontexturepainting_tpu/weights/convert.py
(convert_unet, convert_vae_encoder, convert_vae_decoder,
convert_patch_encoder): paths are renamed back to diffusers / Hugging Face
names. Conv kernels keep their (kH, kW, Cin, Cout) layout, which the port's
convs use too; Dense kernels (in, out) become nn.Linear's (out, in). Input
leaves are numpy arrays, never jax arrays.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK_RULES = [
    (r"transformer_blocks_(\d+)/", r"transformer_blocks.\1."),
    (r"(attn[12])/to_out/", r"\1.to_out.0."),
    (r"ff/net_0/proj/", "ff.net.0.proj."),
    (r"ff/net_2/", "ff.net.2."),
]

_RULES = {
    "unet": [
        (r"^down_(\d+)_resnet_(\d+)/", r"down_blocks.\1.resnets.\2."),
        (r"^down_(\d+)_attn_(\d+)/", r"down_blocks.\1.attentions.\2."),
        (r"^down_(\d+)_downsample/", r"down_blocks.\1.downsamplers.0."),
        (r"^up_(\d+)_resnet_(\d+)/", r"up_blocks.\1.resnets.\2."),
        (r"^up_(\d+)_attn_(\d+)/", r"up_blocks.\1.attentions.\2."),
        (r"^up_(\d+)_upsample/", r"up_blocks.\1.upsamplers.0."),
        (r"^mid_resnet_(\d+)/", r"mid_block.resnets.\1."),
        (r"^mid_attn/", "mid_block.attentions.0."),
        (r"^time_embedding_linear_(\d+)/", r"time_embedding.linear_\1."),
    ] + _BLOCK_RULES,
    "vae_encoder": [
        (r"^down_(\d+)_resnet_(\d+)/", r"down_blocks.\1.resnets.\2."),
        (r"^down_(\d+)_downsample/", r"down_blocks.\1.downsamplers.0."),
        (r"^(?!quant_conv/)", "encoder."),
    ],
    "vae_decoder": [
        (r"^up_(\d+)_resnet_(\d+)/", r"up_blocks.\1.resnets.\2."),
        (r"^up_(\d+)_upsample/", r"up_blocks.\1.upsamplers.0."),
        (r"^(?!post_quant_conv/)", "decoder."),
    ],
    "patch_encoder": [
        (r"^([lms])_block_(\d+)/", r"\1_patch_encoder_layers.\2."),
        # the GELU feed-forward's first Dense is `ff/net_0` in the JAX
        # module; diffusers (and this package) name it ff.net.0.proj
        (r"ff/net_0/(kernel|bias)$", r"ff.net.0.proj.\1"),
        (r"^clip/class_embedding$",
         "clip.vision_model.embeddings.class_embedding"),
        (r"^clip/patch_embedding/",
         "clip.vision_model.embeddings.patch_embedding."),
        (r"^clip/position_embedding$",
         "clip.vision_model.embeddings.position_embedding.weight"),
        (r"^clip/pre_layernorm/", "clip.vision_model.pre_layrnorm."),
        (r"^clip/layer_(\d+)/([qkv]_proj|out_proj)/",
         r"clip.vision_model.encoder.layers.\1.self_attn.\2."),
        (r"^clip/layer_(\d+)/(fc[12])/",
         r"clip.vision_model.encoder.layers.\1.mlp.\2."),
        (r"^clip/layer_(\d+)/", r"clip.vision_model.encoder.layers.\1."),
        (r"^clip/post_layernorm/", "clip.vision_model.post_layernorm."),
    ] + _BLOCK_RULES,
}

# VAE mid block (both halves): mid/{resnet_k, attn_norm, attn/to_*}
_VAE_MID = [
    (r"mid/resnet_(\d+)/", r"mid_block.resnets.\1."),
    (r"mid/attn_norm/norm/", "mid_block.attentions.0.group_norm."),
    (r"mid/attn/to_out/", "mid_block.attentions.0.to_out.0."),
    (r"mid/attn/", "mid_block.attentions.0."),
]
_RULES["vae_encoder"] = _VAE_MID + _RULES["vae_encoder"]
_RULES["vae_decoder"] = _VAE_MID + _RULES["vae_decoder"]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, path + "/")
        else:
            yield path, v


def torch_name(component: str, path: str) -> str:
    """A JAX parameter path ('down_0_resnet_0/conv1/kernel') -> its
    state_dict name ('down_blocks.0.resnets.0.conv1.weight')."""
    p = path
    for pat, rep in _RULES[component]:
        p = re.sub(pat, rep, p)
    p = p.replace("/norm/", ".")  # GroupNorm32 / LayerNorm32 wrapper level
    p = p.replace("/", ".")
    return re.sub(r"\.(kernel|scale)$", ".weight", p)


def state_dict_from_jax(component: str, tree) -> Dict[str, torch.Tensor]:
    """component in {'unet', 'vae_encoder', 'vae_decoder', 'patch_encoder'};
    tree: nested dict of numpy arrays (a JAX package parameter tree)."""
    if component not in _RULES:
        raise ValueError(f"unknown component {component!r}")
    sd = {}
    for path, leaf in _flatten(tree):
        a = np.array(leaf, dtype=np.float32)
        if path.endswith("kernel") and a.ndim == 2:
            a = a.T
        sd[torch_name(component, path)] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd
