"""The reference's released checkpoints -> the port's state_dicts -> npz.

Port of diffusiontexturepainting_tpu/weights/convert.py, numpy and torch
only (no jax, no safetensors package). It reads the artifacts the
reference serves from:

  1. SD-1.5 inpainting weights: diffusers UNet2DConditionModel and
     AutoencoderKL state_dicts (`.bin` or `.safetensors`);
  2. `pytorch_lora_weights.bin` (diffusers attn-procs format), merged into
     the UNet's attention projections: W += scale * (up @ down);
  3. `image_encoder.pth` (the ConditionPatchEncoder: per-scale transformer
     stacks, projection, uncond vector, and its CLIP visual tower in
     OpenAI or Hugging Face naming);
  4. optionally, the CLIP text tower (Hugging Face CLIPTextModel).

Each convert_* function returns the port's own state_dict of a component
(diffusers / Hugging Face names, as weights/from_jax.py names them): a conv
weight goes from torch's (Cout, Cin, kH, kW) to the port's (kH, kW, Cin,
Cout), a linear weight keeps its (out, in). `main` writes each component
in the JAX package's npz format (from_jax.jax_tree_from_state_dict,
loader.save_component), array for array the files the JAX converter
writes, with one difference: the patch encoder's GELU input projection is
written as `ff/net_0`, the JAX module's name, where the JAX converter
writes `ff/net_0/proj`, which the JAX loader's validation refuses. Derived
tensors (the upsamplers' folded taps, the slotted q/k/v, the VAE head's
padded weight) are never written: the modules' load hooks rebuild them.

    python -m diffusiontexturepainting_torch.weights.convert \\
        --unet unet.bin --vae vae.safetensors \\
        --lora pytorch_lora_weights.bin --image-encoder image_encoder.pth \\
        --out CHECKPOINT_DIR

A component is converted, written and freed before the next is read, so
the process holds at most about two copies of the UNet (3.44 GB of float32
at SD-1.5 width) at a time.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).float()


def _module(sd, prefix: str, out: StateDict, kind: str,
            name: str | None = None) -> None:
    """One torch layer (`kind`: linear, conv or norm) at `prefix` into
    `out` under `name` (default: the same name)."""
    name = prefix if name is None else name
    w = sd.get(f"{prefix}.weight")
    b = sd.get(f"{prefix}.bias")
    if w is None:
        raise KeyError(f"missing weight for {prefix!r} in state_dict")
    if kind == "conv":
        out[f"{name}.weight"] = _f32(w).permute(2, 3, 1, 0).contiguous()
    elif kind in ("linear", "norm"):
        out[f"{name}.weight"] = _f32(w)
    else:
        raise ValueError(kind)
    if b is not None:
        out[f"{name}.bias"] = _f32(b)
    elif kind == "norm":
        raise KeyError(f"missing bias for {prefix!r} in state_dict")


def _transformer_block(sd, prefix: str, out: StateDict) -> None:
    """diffusers BasicTransformerBlock (the port's names are diffusers')."""
    for n in ("norm1", "norm2", "norm3"):
        _module(sd, f"{prefix}.{n}", out, "norm")
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            _module(sd, f"{prefix}.{attn}.{proj}", out, "linear")
    _module(sd, f"{prefix}.ff.net.0.proj", out, "linear")
    _module(sd, f"{prefix}.ff.net.2", out, "linear")


def _resnet(sd, prefix: str, out: StateDict, has_temb: bool = True) -> None:
    _module(sd, f"{prefix}.norm1", out, "norm")
    _module(sd, f"{prefix}.conv1", out, "conv")
    if has_temb and f"{prefix}.time_emb_proj.weight" in sd:
        _module(sd, f"{prefix}.time_emb_proj", out, "linear")
    _module(sd, f"{prefix}.norm2", out, "norm")
    _module(sd, f"{prefix}.conv2", out, "conv")
    if f"{prefix}.conv_shortcut.weight" in sd:
        _module(sd, f"{prefix}.conv_shortcut", out, "conv")


def _transformer2d(sd, prefix: str, out: StateDict, depth: int = 1) -> None:
    _module(sd, f"{prefix}.norm", out, "norm")
    _module(sd, f"{prefix}.proj_in", out, "conv")
    for d in range(depth):
        _transformer_block(sd, f"{prefix}.transformer_blocks.{d}", out)
    _module(sd, f"{prefix}.proj_out", out, "conv")


def _unet_side(sd, side: str, n_res: int, num_blocks: int,
               out: StateDict) -> None:
    sampler = "downsamplers" if side == "down" else "upsamplers"
    for i in range(num_blocks):
        for j in range(n_res):
            _resnet(sd, f"{side}_blocks.{i}.resnets.{j}", out)
            attn = f"{side}_blocks.{i}.attentions.{j}"
            if f"{attn}.norm.weight" in sd:
                _transformer2d(sd, attn, out)
        conv = f"{side}_blocks.{i}.{sampler}.0.conv"
        if f"{conv}.weight" in sd:
            _module(sd, conv, out, "conv")


def convert_unet(sd, layers_per_block: int = 2,
                 num_blocks: int = 4) -> StateDict:
    """diffusers UNet2DConditionModel state_dict -> the port's UNet."""
    out: StateDict = {}
    _module(sd, "conv_in", out, "conv")
    _module(sd, "time_embedding.linear_1", out, "linear")
    _module(sd, "time_embedding.linear_2", out, "linear")
    _unet_side(sd, "down", layers_per_block, num_blocks, out)
    _resnet(sd, "mid_block.resnets.0", out)
    _transformer2d(sd, "mid_block.attentions.0", out)
    _resnet(sd, "mid_block.resnets.1", out)
    _unet_side(sd, "up", layers_per_block + 1, num_blocks, out)
    _module(sd, "conv_norm_out", out, "norm")
    _module(sd, "conv_out", out, "conv")
    return out


def _vae_attn(sd, prefix: str, out: StateDict) -> None:
    """The VAE mid-block attention in the old (query/key/value/proj_attn)
    or the new (to_q/.../to_out.0) diffusers naming -> the new one."""
    names = (("query", "key", "value", "proj_attn")
             if f"{prefix}.query.weight" in sd
             else ("to_q", "to_k", "to_v", "to_out.0"))
    _module(sd, f"{prefix}.group_norm", out, "norm")
    for torch_n, ours in zip(names, ("to_q", "to_k", "to_v", "to_out.0")):
        _module(sd, f"{prefix}.{torch_n}", out, "linear", f"{prefix}.{ours}")


def _vae_mid(sd, prefix: str, out: StateDict) -> None:
    _resnet(sd, f"{prefix}.mid_block.resnets.0", out, has_temb=False)
    _vae_attn(sd, f"{prefix}.mid_block.attentions.0", out)
    _resnet(sd, f"{prefix}.mid_block.resnets.1", out, has_temb=False)


def convert_vae_encoder(sd, layers_per_block: int = 2,
                        num_blocks: int = 4) -> StateDict:
    """AutoencoderKL state_dict (whole) -> the port's VAEEncoder."""
    out: StateDict = {}
    _module(sd, "encoder.conv_in", out, "conv")
    for i in range(num_blocks):
        for j in range(layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", out,
                    has_temb=False)
        conv = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{conv}.weight" in sd:
            _module(sd, conv, out, "conv")
    _vae_mid(sd, "encoder", out)
    _module(sd, "encoder.conv_norm_out", out, "norm")
    _module(sd, "encoder.conv_out", out, "conv")
    _module(sd, "quant_conv", out, "conv")
    return out


def convert_vae_decoder(sd, layers_per_block: int = 2,
                        num_blocks: int = 4) -> StateDict:
    """AutoencoderKL state_dict (whole) -> the port's VAEDecoder."""
    out: StateDict = {}
    _module(sd, "post_quant_conv", out, "conv")
    _module(sd, "decoder.conv_in", out, "conv")
    _vae_mid(sd, "decoder", out)
    for i in range(num_blocks):
        for j in range(layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", out,
                    has_temb=False)
        conv = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{conv}.weight" in sd:
            _module(sd, conv, out, "conv")
    _module(sd, "decoder.conv_norm_out", out, "norm")
    _module(sd, "decoder.conv_out", out, "conv")
    return out


def _clip_layer(sd, src: str, out: StateDict, dst: str, names,
                attn) -> None:
    """One CLIP encoder layer at `src` -> the port's (Hugging Face) names
    at `dst`, in the JAX converter's order; `names`: the source's
    (layer_norm1, layer_norm2, fc1, fc2); `attn(src, dst)` writes the
    attention's four projections."""
    ln1, ln2, fc1, fc2 = names
    _module(sd, f"{src}.{ln1}", out, "norm", f"{dst}.layer_norm1")
    _module(sd, f"{src}.{ln2}", out, "norm", f"{dst}.layer_norm2")
    attn(src, dst)
    _module(sd, f"{src}.{fc1}", out, "linear", f"{dst}.mlp.fc1")
    _module(sd, f"{src}.{fc2}", out, "linear", f"{dst}.mlp.fc2")


def _hf_layers(sd, prefix: str, out: StateDict, o: str,
               num_layers: int) -> None:
    """Hugging Face CLIPEncoderLayer names on both sides."""
    def attn(src, dst):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _module(sd, f"{src}.self_attn.{p}", out, "linear",
                    f"{dst}.self_attn.{p}")

    for i in range(num_layers):
        _clip_layer(sd, f"{prefix}.encoder.layers.{i}", out,
                    f"{o}.encoder.layers.{i}",
                    ("layer_norm1", "layer_norm2", "mlp.fc1", "mlp.fc2"),
                    attn)


def convert_clip_hf(sd, prefix: str = "vision_model",
                    num_layers: int = 12) -> StateDict:
    """Hugging Face CLIPVisionModel -> the port's CLIPVisionModel
    (vision_model.*; the pre-LayerNorm read as `pre_layrnorm`, Hugging
    Face's historical spelling, or `pre_layernorm`)."""
    out: StateDict = {}
    emb = f"{prefix}.embeddings"
    o = "vision_model"
    out[f"{o}.embeddings.class_embedding"] = _f32(
        sd[f"{emb}.class_embedding"])
    _module(sd, f"{emb}.patch_embedding", out, "conv",
            f"{o}.embeddings.patch_embedding")
    out[f"{o}.embeddings.position_embedding.weight"] = _f32(
        sd[f"{emb}.position_embedding.weight"])
    pre = (f"{prefix}.pre_layrnorm" if f"{prefix}.pre_layrnorm.weight" in sd
           else f"{prefix}.pre_layernorm")
    _module(sd, pre, out, "norm", f"{o}.pre_layrnorm")
    _hf_layers(sd, prefix, out, o, num_layers)
    _module(sd, f"{prefix}.post_layernorm", out, "norm",
            f"{o}.post_layernorm")
    return out


def convert_clip_openai(sd, prefix: str = "clip.visual",
                        num_layers: int = 12) -> StateDict:
    """OpenAI CLIP's visual tower (as image_encoder.pth holds it) -> the
    port's CLIPVisionModel. in_proj_weight / in_proj_bias split as q, k, v;
    the checkpoint's other keys (the projection, the text tower) are not
    read."""
    out: StateDict = {}
    o = "vision_model"
    out[f"{o}.embeddings.class_embedding"] = _f32(
        sd[f"{prefix}.class_embedding"])
    _module(sd, f"{prefix}.conv1", out, "conv",
            f"{o}.embeddings.patch_embedding")
    out[f"{o}.embeddings.position_embedding.weight"] = _f32(
        sd[f"{prefix}.positional_embedding"])
    _module(sd, f"{prefix}.ln_pre", out, "norm", f"{o}.pre_layrnorm")

    def attn(src, dst):
        in_w = _f32(sd[f"{src}.attn.in_proj_weight"])
        in_b = _f32(sd[f"{src}.attn.in_proj_bias"])
        d = in_w.shape[0] // 3
        for k, p in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}.self_attn.{p}.weight"] = in_w[k * d:(k + 1) * d]
            out[f"{dst}.self_attn.{p}.bias"] = in_b[k * d:(k + 1) * d]
        _module(sd, f"{src}.attn.out_proj", out, "linear",
                f"{dst}.self_attn.out_proj")

    for i in range(num_layers):
        _clip_layer(sd, f"{prefix}.transformer.resblocks.{i}", out,
                    f"{o}.encoder.layers.{i}",
                    ("ln_1", "ln_2", "mlp.c_fc", "mlp.c_proj"), attn)
    _module(sd, f"{prefix}.ln_post", out, "norm", f"{o}.post_layernorm")
    return out


def convert_patch_encoder(sd, num_layers: int = 4,
                          clip_layers: int = 12) -> StateDict:
    """image_encoder.pth -> the port's ConditionPatchEncoder, with its CLIP
    tower where the file holds one (OpenAI or Hugging Face naming)."""
    out: StateDict = {}
    for stack in ("l", "m", "s"):
        for i in range(num_layers):
            _transformer_block(sd, f"{stack}_patch_encoder_layers.{i}", out)
    _module(sd, "final_layer_norm", out, "norm")
    _module(sd, "proj_out", out, "linear")
    out["uncond_vector"] = _f32(sd["uncond_vector"])
    if "clip.visual.class_embedding" in sd:
        clip = convert_clip_openai(sd, "clip.visual", clip_layers)
    elif "clip.vision_model.embeddings.class_embedding" in sd:
        clip = convert_clip_hf(sd, "clip.vision_model", clip_layers)
    else:
        clip = {}
    out.update((f"clip.{k}", v) for k, v in clip.items())
    return out


def convert_clip_text(sd, prefix: str = "text_model",
                      num_layers: int = 12) -> StateDict:
    """Hugging Face CLIPTextModel (SD's `text_encoder`) -> the port's
    CLIPTextEncoder (text_model.*)."""
    out: StateDict = {}
    o = "text_model"
    for e in ("token_embedding", "position_embedding"):
        out[f"{o}.embeddings.{e}.weight"] = _f32(
            sd[f"{prefix}.embeddings.{e}.weight"])
    _hf_layers(sd, prefix, out, o, num_layers)
    _module(sd, f"{prefix}.final_layer_norm", out, "norm",
            f"{o}.final_layer_norm")
    return out


_LORA_KEY_RE = re.compile(
    r"^(?P<block>.*)\.processor\.(?P<target>to_[qkv]|to_out)_lora\."
    r"(?P<factor>down|up)\.weight$")


def _lora_target(name: str) -> str:
    """'down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_out' ->
    the port's weight 'down_blocks.0.attentions.1.transformer_blocks.0.
    attn1.to_out.0.weight'; KeyError for anything but the attention
    projections of a down, mid or up block (the JAX converter's
    _torch_attn_path_to_ours)."""
    m = re.match(r"((?:down|up)_blocks\.\d+\.attentions\.\d+|"
                 r"mid_block\.attentions\.0)\.transformer_blocks\.\d+\."
                 r"attn[12]\.(to_\w+)$", name)
    if not m:
        raise KeyError(f"cannot map LoRA target {name}")
    return name + (".0" if m.group(2) == "to_out" else "") + ".weight"


def merge_lora_state_dict(unet: StateDict, lora_sd,
                          scale: float = 1.0) -> StateDict:
    """Fold a diffusers attn-procs LoRA state_dict into the port's UNet
    state_dict, in place: W (out, in) += scale * (up @ down), the product
    in float32 numpy as the JAX converter computes its transpose, so the
    merged weights are its bits. A key of another pattern is skipped with
    a warning; a file with no key of the pattern raises ValueError (the
    JAX converter then merges nothing, and a LoRA in another format would
    be served as the bare base model)."""
    pairs: dict = {}
    for key, val in lora_sd.items():
        m = _LORA_KEY_RE.match(key)
        if not m:
            logger.warning("unrecognized LoRA key %s", key)
            continue
        name = f"{m.group('block')}.{m.group('target')}"
        pairs.setdefault(name, {})[m.group("factor")] = _f32(val).numpy()
    if not pairs:
        raise ValueError(
            f"no LoRA key of the diffusers attn-procs format "
            f"('<block>.processor.to_q_lora.down.weight'; "
            f"{len(lora_sd)} keys read)")
    for name, factors in pairs.items():
        key = _lora_target(name)
        if key not in unet:
            raise KeyError(f"LoRA target {name} not found in the UNet's "
                           "weights")
        missing = {"up", "down"} - set(factors)
        if missing:
            raise ValueError(f"LoRA projection {name} lacks its "
                             f"{sorted(missing)} factor")
        delta = factors["up"] @ factors["down"]  # (out, in)
        unet[key] = torch.from_numpy(
            unet[key].numpy() + scale * delta.astype(np.float32))
    logger.info("merged %d LoRA projections", len(pairs))
    return unet


def _torch_load(path: str) -> StateDict:
    # weights_only=True refuses to unpickle module objects: a checkpoint
    # that pickles a whole module fails here (UnpicklingError) and is not
    # retried with weights_only=False, which would run code from the file
    obj = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"{path}: {k!r} is a {type(v).__name__}, not a "
                             "tensor: a state_dict is needed")
        out[k] = v.float()
    return out


# safetensors dtype -> the little-endian numpy dtype its bytes are read as
_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def read_safetensors(path: str) -> StateDict:
    """A .safetensors file's tensors as float32, read without the
    safetensors package: an 8-byte little-endian header length, a JSON
    header ({key: {dtype, shape, data_offsets}}, optional __metadata__),
    then the raw little-endian data. F32, F16 and BF16 (its 16 bits shifted
    into the top of a float32) are read; any other dtype raises ValueError
    naming the key."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    n = int(data[:8].view("<u8")[0])
    header = json.loads(bytes(data[8:8 + n]))
    body = data[8 + n:]
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {key!r} is {info['dtype']}; only "
                             f"{sorted(_SAFETENSORS_DTYPES)} are read")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * np.dtype(dt).itemsize or end > body.size:
            raise ValueError(f"{path}: {key!r}'s data_offsets {start, end} "
                             f"do not hold a {info['dtype']} {shape}")
        raw = body[start:end].view(dt)
        if info["dtype"] == "BF16":
            a = (raw.astype(np.uint32) << 16).view(np.float32)
        else:
            a = raw.astype(np.float32)
        out[key] = torch.from_numpy(a.reshape(shape))
    del data
    return out


def load_state_dict(path: str) -> StateDict:
    """A torch state_dict file (.bin / .pth / .pt, through torch.load
    with weights_only) or a .safetensors file, as float32 CPU tensors."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return _torch_load(path)


def main(argv=None):
    import argparse
    import os
    import time

    from .from_jax import jax_tree_from_state_dict
    from .loader import component_path, save_component

    ap = argparse.ArgumentParser(
        description="Convert SD-1.5 + LoRA + image-encoder torch "
                    "checkpoints to the JAX package's .npz component files")
    ap.add_argument("--unet", help="diffusers UNet state_dict file")
    ap.add_argument("--vae", help="diffusers AutoencoderKL state_dict file")
    ap.add_argument("--lora", help="pytorch_lora_weights.bin")
    ap.add_argument("--image-encoder", help="image_encoder.pth")
    ap.add_argument("--text-encoder",
                    help="Hugging Face CLIPTextModel state_dict file "
                         "(optional; the inpaint server does not use it)")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    def write(name, sd, tic):
        path = component_path(args.out, name)
        save_component(path, jax_tree_from_state_dict(name, sd))
        nbytes = sum(4 * t.numel() for t in sd.values())
        print(f"converted {name}: {nbytes} bytes of float32 arrays, "
              f"{os.path.getsize(path)} on disk, "
              f"{time.perf_counter() - tic:.2f} s", flush=True)

    if args.unet:
        tic = time.perf_counter()
        unet = convert_unet(load_state_dict(args.unet))
        if args.lora:
            merge_lora_state_dict(unet, load_state_dict(args.lora),
                                  args.lora_scale)
        write("unet", unet, tic)
        del unet
    if args.vae:
        tic = time.perf_counter()
        vae = load_state_dict(args.vae)
        write("vae_encoder", convert_vae_encoder(vae), tic)
        tic = time.perf_counter()
        write("vae_decoder", convert_vae_decoder(vae), tic)
        del vae
    if args.image_encoder:
        tic = time.perf_counter()
        write("patch_encoder",
              convert_patch_encoder(load_state_dict(args.image_encoder)), tic)
    if args.text_encoder:
        tic = time.perf_counter()
        write("text_encoder",
              convert_clip_text(load_state_dict(args.text_encoder)), tic)
    print(f"wrote checkpoint components to {args.out}")


if __name__ == "__main__":
    main()
