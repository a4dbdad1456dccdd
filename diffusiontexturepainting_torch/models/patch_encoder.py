"""ConditionPatchEncoder: multi-scale CLIP patch conditioning of the brush.

Port of diffusiontexturepainting_tpu/models/patch_encoder.py: the brush
image becomes a 1 + 4 + 9 patch pyramid, every patch is CLIP-encoded, 2D
sin/cos positional codes are added per scale, one transformer stack per
scale processes its tokens, and LayerNorm + Linear project the 14 tokens to
the UNet's cross-attention width. A learned `uncond_vector` is the negative
embedding for CFG.

Checkpoint quirk kept on purpose: the reference builds its positional
buffer as `positional_encoding_2d(C, s, s).view(1, s*s, C)`, a raw memory
reinterpretation that scrambles (position, channel) for s > 1; trained
weights saw those codes, so positional_encoding_2d_flat reproduces them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    PatchEncoderConfig,
)
from ..ops.constants import device_constant
from ..ops.resize import resize2d
from .clip_vit import CLIPVisionModel
from .layers import BasicTransformerBlock, LayerNorm32

STACK_NAMES = ("l", "m", "s")


def positional_encoding_2d(channels: int, height: int,
                           width: int) -> np.ndarray:
    """(C, H, W) interleaved sin/cos codes (reference image_encoder.py)."""
    pos = np.zeros((channels, height, width), dtype=np.float32)
    d = channels // 2
    freq = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    x = np.arange(width, dtype=np.float32)[:, None]
    y = np.arange(height, dtype=np.float32)[:, None]
    pos[0:d:2] = np.sin(x * freq).T[:, None, :]
    pos[1:d:2] = np.cos(x * freq).T[:, None, :]
    pos[d::2] = np.sin(y * freq).T[:, :, None]
    pos[d + 1::2] = np.cos(y * freq).T[:, :, None]
    return pos


def positional_encoding_2d_flat(channels: int, n_patches: int) -> np.ndarray:
    """(n_patches, C): the reference's raw `.view` of the (C, s, s) codes."""
    side = int(math.isqrt(n_patches))
    return positional_encoding_2d(channels, side, side).reshape(
        n_patches, channels)


def build_pos_emb(cfg: PatchEncoderConfig) -> np.ndarray:
    return np.concatenate([positional_encoding_2d_flat(cfg.hid_size, n)
                           for n in cfg.num_patches], axis=0)


def clip_normalize(images):
    """(..., H, W, 3) in [0, 1] -> CLIP-normalized."""
    mean = device_constant(CLIP_IMAGE_MEAN, images.device, images.dtype)
    std = device_constant(CLIP_IMAGE_STD, images.device, images.dtype)
    return (images - mean) / std


def build_patch_pyramid(image, num_patches: Tuple[int, ...],
                        out_size: int = 224):
    """(B, S, S, 3) -> (B, sum(num_patches), out, out, 3): per scale, s x s
    row-major tiles of size S//s (remainder cropped), each resized to
    out_size (bilinear)."""
    b, size = image.shape[0], image.shape[1]
    levels = []
    for n in num_patches:
        side = int(math.isqrt(n))
        p = size // side
        crop = image[:, :side * p, :side * p, :]
        tiles = crop.reshape(b, side, p, side, p, 3).permute(0, 1, 3, 2, 4, 5)
        tiles = resize2d(tiles.reshape(b * n, p, p, 3), out_size, out_size,
                         mode="bilinear")
        levels.append(tiles.reshape(b, n, out_size, out_size, 3))
    return torch.cat(levels, dim=1)


class ConditionPatchEncoder(nn.Module):
    def __init__(self, cfg: PatchEncoderConfig = PatchEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        hid = cfg.hid_size
        self.clip = CLIPVisionModel(cfg.clip)
        for name in STACK_NAMES[:len(cfg.num_patches)]:
            setattr(self, f"{name}_patch_encoder_layers", nn.ModuleList([
                BasicTransformerBlock(hid, cfg.num_heads,
                                      hid // cfg.num_heads, qkv_bias=True,
                                      ff_activation="gelu")
                for _ in range(cfg.num_layers)]))
        # flax's LayerNorm default epsilon, as the JAX module uses it
        self.final_layer_norm = LayerNorm32(hid, eps=1e-6)
        self.proj_out = nn.Linear(hid, cfg.cross_attention_dim)
        self.uncond_vector = nn.Parameter(
            torch.zeros(1, cfg.total_patches, cfg.cross_attention_dim))
        # fp32 codes, kept out of the buffers so a dtype cast leaves them
        self._pos_emb = build_pos_emb(cfg)

    def clip_tokens(self, image_patches):
        """The frozen CLIP tower's pooled token of every patch:
        (B, total, H, W, 3) -> (B * total, hid)."""
        flat = image_patches.reshape((-1,) + image_patches.shape[2:])
        return self.clip(flat)

    def forward(self, image_patches, clip_tokens=None):
        """(B, total, H, W, 3) CLIP-normalized patches -> (cond tokens
        (B, total, cross_dim) fp32, uncond vector (1, total, cross_dim)).
        `clip_tokens`: clip_tokens(image_patches), computed by the caller
        (the trainer runs the frozen tower under no_grad); image_patches is
        then not read. The head computes in the dtype of its transformer
        blocks; the final LayerNorm and proj_out in fp32."""
        cfg = self.cfg
        if clip_tokens is None:
            clip_tokens = self.clip_tokens(image_patches)
        tokens = clip_tokens.reshape(-1, cfg.total_patches, cfg.hid_size)
        pos = device_constant(self._pos_emb, tokens.device)
        dtype = self.l_patch_encoder_layers[0].attn1.to_q.weight.dtype
        tokens = (tokens + pos[None]).to(dtype)
        groups = torch.split(tokens, list(cfg.num_patches), dim=1)
        outs = []
        for g, name in zip(groups, STACK_NAMES):
            for block in getattr(self, f"{name}_patch_encoder_layers"):
                g = block(g)
            outs.append(g)
        latent = self.final_layer_norm(torch.cat(outs, dim=1).float())
        latent = F.linear(latent, self.proj_out.weight.float(),
                          self.proj_out.bias.float())
        return latent, self.uncond_vector


def encode_brush_image(module: ConditionPatchEncoder, image):
    """Brush encoding of (B, H, W, 3) float [0, 1]: bicubic align-corners
    resize to the CLIP input size, CLIP normalize, pyramid, encoder.
    Returns (cond, uncond)."""
    size = module.cfg.clip.image_size
    if image.shape[1] != size or image.shape[2] != size:
        image = resize2d(image, size, size, mode="bicubic",
                         align_corners=True)
    pyramid = build_patch_pyramid(clip_normalize(image),
                                  module.cfg.num_patches, out_size=size)
    return module(pyramid)
