"""JAX-package parameter trees <-> this package's (diffusers-named) state_dicts.

`state_dict_from_jax` is the inverse of
diffusiontexturepainting_tpu/weights/convert.py (convert_unet,
convert_vae_encoder, convert_vae_decoder, convert_patch_encoder): paths
are renamed back to diffusers / Hugging Face names. Conv kernels keep their
(kH, kW, Cin, Cout) layout, which the port's convs use too; Dense kernels
(in, out) become nn.Linear's (out, in). `jax_tree_from_state_dict` goes
back, so the port writes checkpoints the JAX package loads
(weights/loader.py). `lora_from_jax` and `lora_to_jax` rename the LoRA
factors (models/lora.py) both ways. Leaves are numpy arrays, never jax
arrays.
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


# diffusers owner names (the part before .weight / .bias) -> JAX paths,
# '.'-separated until the end (torch_name's rules read backwards)
_BLOCK_INVERSE = [
    (r"transformer_blocks\.(\d+)", r"transformer_blocks_\1"),
    (r"(attn[12])\.to_out\.0$", r"\1.to_out"),
    (r"ff\.net\.0\.proj$", "ff.net_0.proj"),
    (r"ff\.net\.2$", "ff.net_2"),
]
_VAE_MID_INVERSE = [
    (r"^mid_block\.resnets\.(\d+)", r"mid.resnet_\1"),
    (r"^mid_block\.attentions\.0\.group_norm$", "mid.attn_norm"),
    (r"^mid_block\.attentions\.0\.to_out\.0$", "mid.attn.to_out"),
    (r"^mid_block\.attentions\.0\.", "mid.attn."),
]
_INVERSE = {
    "unet": [
        (r"^(down|up)_blocks\.(\d+)\.resnets\.(\d+)", r"\1_\2_resnet_\3"),
        (r"^(down|up)_blocks\.(\d+)\.attentions\.(\d+)", r"\1_\2_attn_\3"),
        (r"^down_blocks\.(\d+)\.downsamplers\.0", r"down_\1_downsample"),
        (r"^up_blocks\.(\d+)\.upsamplers\.0", r"up_\1_upsample"),
        (r"^mid_block\.resnets\.(\d+)", r"mid_resnet_\1"),
        (r"^mid_block\.attentions\.0", "mid_attn"),
        (r"^time_embedding\.linear_(\d+)", r"time_embedding_linear_\1"),
    ] + _BLOCK_INVERSE,
    "vae_encoder": [
        (r"^encoder\.", ""),
        (r"^down_blocks\.(\d+)\.resnets\.(\d+)", r"down_\1_resnet_\2"),
        (r"^down_blocks\.(\d+)\.downsamplers\.0", r"down_\1_downsample"),
    ] + _VAE_MID_INVERSE,
    "vae_decoder": [
        (r"^decoder\.", ""),
        (r"^up_blocks\.(\d+)\.resnets\.(\d+)", r"up_\1_resnet_\2"),
        (r"^up_blocks\.(\d+)\.upsamplers\.0", r"up_\1_upsample"),
    ] + _VAE_MID_INVERSE,
    "patch_encoder": [
        (r"^([lms])_patch_encoder_layers\.(\d+)", r"\1_block_\2"),
        (r"ff\.net\.0\.proj$", "ff.net_0"),
        (r"^clip\.vision_model\.embeddings\.patch_embedding$",
         "clip.patch_embedding"),
        (r"^clip\.vision_model\.pre_layrnorm$", "clip.pre_layernorm"),
        (r"^clip\.vision_model\.post_layernorm$", "clip.post_layernorm"),
        (r"^clip\.vision_model\.encoder\.layers\.(\d+)\.(self_attn|mlp)\.",
         r"clip.layer_\1."),
        (r"^clip\.vision_model\.encoder\.layers\.(\d+)", r"clip.layer_\1"),
    ] + _BLOCK_INVERSE,
}
# leaves that are no layer's .weight / .bias
_PLAIN_LEAVES = {
    "clip.vision_model.embeddings.class_embedding": "clip/class_embedding",
    "clip.vision_model.embeddings.position_embedding.weight":
        "clip/position_embedding",
    "uncond_vector": "uncond_vector",
}


def jax_path(component: str, name: str, norm: bool) -> str:
    """A state_dict name -> its JAX parameter path; `norm`: the name is a
    normalization layer's (its weight 1-D), whose JAX scale sits under the
    GroupNorm32 / LayerNorm32 wrapper's `norm` level except in CLIP and the
    patch encoder's final LayerNorm. Raises ValueError where torch_name
    does not map the path back to `name`."""
    if name in _PLAIN_LEAVES:
        path = _PLAIN_LEAVES[name]
    else:
        owner, leaf = name.rsplit(".", 1)
        p = owner
        for pat, rep in _INVERSE[component]:
            p = re.sub(pat, rep, p)
        p = p.replace(".", "/")
        if norm:
            bare = component == "patch_encoder" and (
                owner.startswith("clip.") or owner == "final_layer_norm")
            path = p + ("/" if bare else "/norm/") + (
                "scale" if leaf == "weight" else leaf)
        else:
            path = p + "/" + ("kernel" if leaf == "weight" else leaf)
    if torch_name(component, path) != name:
        raise ValueError(f"{component}: no JAX path maps to {name!r} "
                         f"(tried {path!r})")
    return path


def jax_tree_from_state_dict(component: str, sd) -> dict:
    """A port state_dict -> the JAX package's nested parameter tree of
    float32 numpy arrays (nn.Linear's (out, in) back to Dense (in, out))."""
    if component not in _INVERSE:
        raise ValueError(f"unknown component {component!r}")
    norms = {k.rsplit(".", 1)[0] for k, v in sd.items()
             if k.endswith(".weight") and v.dim() == 1}
    tree = {}
    for name, t in sd.items():
        path = jax_path(component, name,
                        "." in name and name.rsplit(".", 1)[0] in norms)
        a = t.detach().to("cpu", torch.float32).numpy()
        if path.endswith("kernel") and a.ndim == 2:
            a = a.T
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return tree


def lora_from_jax(tree) -> dict:
    """The JAX package's LoRA factors ({'down_0_attn_0/transformer_blocks_0/
    attn1/to_q': {'down': (r, in), 'up': (out, r)}}) -> the port's
    ({'down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q': ...},
    fp32 tensors). The factors' layouts are the same on both sides."""
    out = {}
    for path, factors in tree.items():
        name = torch_name("unet", f"{path}/kernel").removesuffix(".weight")
        out[name] = {k: torch.from_numpy(np.array(v, dtype=np.float32))
                     for k, v in factors.items()}
    return out


def lora_to_jax(lora) -> dict:
    """The port's LoRA factors -> the JAX package's tree of fp32 numpy
    arrays (lora_from_jax's inverse)."""
    out = {}
    for name, factors in lora.items():
        path = jax_path("unet", f"{name}.weight", False)
        out[path.removesuffix("/kernel")] = {
            k: np.ascontiguousarray(v.detach().to("cpu", torch.float32)
                                    .numpy())
            for k, v in factors.items()}
    return out
