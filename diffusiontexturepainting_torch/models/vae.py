"""SD AutoencoderKL encoder and decoder, NHWC.

Port of diffusiontexturepainting_tpu/models/vae.py (the module path; the
TPU's fused streaming encode/decode comes later). Names follow diffusers'
AutoencoderKL (encoder.*, quant_conv, post_quant_conv, decoder.*), so the
state_dicts convert with weights/convert.py.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import VAEConfig
from .layers import (
    Attention,
    Conv1x1,
    ConvNHWC,
    Downsample,
    GroupNorm32,
    ResnetBlock,
    Upsample,
)


class _VAEAttention(Attention):
    """The mid block's single-head spatial attention with its GroupNorm."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__(channels, 1, channels, qkv_bias=True)
        self.group_norm = GroupNorm32(num_groups, channels, eps=1e-6)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, num_groups, eps=1e-6)
            for _ in range(2)])
        self.attentions = nn.ModuleList([_VAEAttention(channels, num_groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        b, h, w, c = x.shape
        attn = self.attentions[0]
        a = attn(attn.group_norm(x).reshape(b, h * w, c))
        return self.resnets[1](x + a.reshape(b, h, w, c))


class _Level(nn.Module):
    def __init__(self, resnets, resampler, resampler_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))


class _Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chs = cfg.block_out_channels
        self.conv_in = ConvNHWC(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(prev, ch, g, eps=1e-6))
                prev = ch
            down = (Downsample(ch, asymmetric_pad=True)
                    if i < len(chs) - 1 else None)
            self.down_blocks.append(_Level(resnets, down, "downsamplers"))
        self.mid_block = _MidBlock(chs[-1], g)
        self.conv_norm_out = GroupNorm32(g, chs[-1], eps=1e-6)
        self.conv_out = ConvNHWC(chs[-1], 2 * cfg.latent_channels, 3,
                                 padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down_blocks:
            for res in level.resnets:
                h = res(h)
            if hasattr(level, "downsamplers"):
                h = level.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = ConvNHWC(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(prev, ch, g, eps=1e-6))
                prev = ch
            up = Upsample(ch) if i < len(rev) - 1 else None
            self.up_blocks.append(_Level(resnets, up, "upsamplers"))
        self.conv_norm_out = GroupNorm32(g, rev[-1], eps=1e-6)
        self.conv_out = ConvNHWC(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            for res in level.resnets:
                h = res(h)
            if hasattr(level, "upsamplers"):
                h = level.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEEncoder(nn.Module):
    """images (B,H,W,3) in [-1,1] -> moments (B,H/8,W/8,2*latent) fp32."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels)

    def forward(self, x):
        x = x.to(self.quant_conv.weight.dtype)
        return self.quant_conv(self.encoder(x)).float()


class VAEDecoder(nn.Module):
    """latents (B,h,w,4), already divided by the scaling factor -> images
    (B,8h,8w,3) in about [-1,1], fp32."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = Conv1x1(cfg.latent_channels,
                                       cfg.latent_channels)
        self.decoder = _Decoder(cfg)

    def forward(self, z):
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).float()


def sample_latents(moments, noise):
    """Reparameterized posterior sample with explicit standard-normal
    `noise` of the mean's shape (the JAX package draws it inside)."""
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mean + std * noise


def latent_mode(moments):
    return moments.chunk(2, dim=-1)[0]
