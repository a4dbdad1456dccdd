"""CLIP text encoder (SD-1.5's `text_encoder`) and `encode_prompt`.

Port of diffusiontexturepainting_tpu/models/clip_text.py. Names follow
Hugging Face CLIPTextModel (text_model.embeddings.*, text_model.encoder.
layers.*, text_model.final_layer_norm), which weights/convert.py
convert_clip_text reads. The tower returns the last hidden state, the
`text_embeddings` a text-conditioned UNet takes as encoder_hidden_states.
The inpaint server never calls it: the brush's patch encoder conditions
the UNet instead.

Token ids only: the CLIP tokenizer's vocabulary ships with checkpoints, not
with this repository, and neither the port nor the machines it runs on
count on `transformers`. A string prompt raises ValueError.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..core.config import CLIPTextConfig, CLIPVisionConfig
from .clip_vit import CLIPEncoderLayer
from .layers import LayerNorm32


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        # the vision tower's layers with the causal mask
        layer_cfg = CLIPVisionConfig(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            layer_norm_eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([CLIPEncoderLayer(layer_cfg, causal=True)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size,
                                            cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """input_ids (B, L) -> last hidden state (B, L, hidden) in the module's
    dtype: token + position embeddings, pre-LN causal layers, the final
    LayerNorm in fp32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids):
        tm = self.text_model
        emb = tm.embeddings
        ids = input_ids.long()
        x = emb.token_embedding(ids)
        x = x + emb.position_embedding.weight[None, :ids.shape[1]]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)


def _ids(prompt, device) -> torch.Tensor:
    if isinstance(prompt, str) or (
            isinstance(prompt, (list, tuple)) and prompt
            and isinstance(prompt[0], str)):
        raise ValueError("encode_prompt needs token ids ((B, 77) ints): the "
                         "port has no CLIP tokenizer")
    return torch.as_tensor(np.asarray(prompt, np.int32), device=device)


@torch.inference_mode()
def encode_prompt(model: CLIPTextEncoder, prompt_ids, negative_ids,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """[uncond, cond] text embeddings (negative first, the JAX package's
    and the reference pipeline's order) in `dtype`. A single negative is
    tiled to the prompt batch; any other batch mismatch raises ValueError."""
    device = next(model.parameters()).device
    cond = model(_ids(prompt_ids, device))
    uncond = model(_ids(negative_ids, device))
    if uncond.shape[0] != cond.shape[0]:
        if uncond.shape[0] != 1:
            raise ValueError(
                f"negative_prompt batch {uncond.shape[0]} must be 1 or "
                f"match prompt batch {cond.shape[0]}")
        uncond = uncond.expand_as(cond)
    return torch.cat([uncond, cond], dim=0).to(dtype)
