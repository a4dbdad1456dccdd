"""SD-1.5 inpainting UNet (9-channel input), NHWC.

Port of diffusiontexturepainting_tpu/models/unet.py (`__call__` only; the
DeepCache forwards come later). Submodule names follow diffusers'
UNet2DConditionModel, so the state_dict converts with
weights/convert.py convert_unet. UNetConfig's fused_resnet / fused_ff /
fused_norm / fused_attn choose the serving legs of the resnets and
transformers; the parameters are the same either way.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import UNetConfig
from .layers import (
    ConvNHWC,
    Downsample,
    GroupNorm32,
    ResnetBlock,
    Transformer2D,
    Upsample,
    timestep_embedding,
)


class _TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Level(nn.Module):
    """One down or up level: resnets, optional transformers, optional
    resampler (diffusers' down_blocks.i / up_blocks.i)."""

    def __init__(self, resnets, attentions, resampler, resampler_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        else:
            self.attentions = None
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        heads, groups, kv = (cfg.num_attention_heads, cfg.norm_num_groups,
                             cfg.cross_attention_dim)
        tdim = cfg.time_embed_dim
        self.conv_in = ConvNHWC(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimestepEmbedding(ch0, tdim)

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, groups, temb_dim=tdim,
                               fused=cfg.fused_resnet)

        def transformer(ch):
            return Transformer2D(ch, heads, ch // heads, kv_dim=kv,
                                 num_groups=groups, ff_fused=cfg.fused_ff,
                                 gn_folded=cfg.fused_norm,
                                 attn_slotted=cfg.fused_attn)

        n_levels = len(cfg.block_out_channels)
        skip_ch = [ch0]
        prev = ch0
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(cfg.block_out_channels):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(resnet(prev, ch))
                if cfg.attn_down[i]:
                    attns.append(transformer(ch))
                prev = ch
                skip_ch.append(ch)
            down = None
            if i < n_levels - 1:
                down = Downsample(ch)
                skip_ch.append(ch)
            self.down_blocks.append(_Level(resnets, attns, down,
                                           "downsamplers"))

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Level([resnet(mid, mid), resnet(mid, mid)],
                                [transformer(mid)], None, "")

        self.up_blocks = nn.ModuleList()
        rev = tuple(reversed(cfg.block_out_channels))
        rev_attn = tuple(reversed(cfg.attn_down))
        for i, ch in enumerate(rev):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(resnet(prev + skip_ch.pop(), ch))
                if rev_attn[i]:
                    attns.append(transformer(ch))
                prev = ch
            up = Upsample(ch) if i < n_levels - 1 else None
            self.up_blocks.append(_Level(resnets, attns, up, "upsamplers"))

        self.conv_norm_out = GroupNorm32(groups, ch0)
        self.conv_out = ConvNHWC(ch0, cfg.out_channels, 3, padding=1)

    def _res_attn(self, resnet, attn, h, temb, ctx, skip=None):
        """resnet [-> transformer]; with fused_norm the resnet's statistics
        epilogue feeds the transformer's folded GroupNorm. `skip` goes to
        the resnet un-concatenated."""
        if attn is not None and self.cfg.fused_norm:
            h, st = resnet(h, temb, skip=skip, return_stats=True)
            return attn(h, ctx, in_stats=st)
        h = resnet(h, temb, skip=skip)
        return attn(h, ctx) if attn is not None else h

    def forward(self, sample, timestep, encoder_hidden_states):
        """(B, H, W, 9), t (scalar or (B,)), (B, L, D) -> (B, H, W, 4)
        predicted noise in fp32."""
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        ctx = encoder_hidden_states.to(dt)
        b = sample.shape[0]
        t = torch.as_tensor(timestep, dtype=torch.float32,
                            device=sample.device).reshape(-1)
        t = t.expand(b) if t.shape[0] != b else t
        temb = timestep_embedding(t, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dt))

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for level in self.down_blocks:
            for j, res in enumerate(level.resnets):
                h = self._res_attn(res, _attn(level, j), h, temb, ctx)
                skips.append(h)
            if hasattr(level, "downsamplers"):
                h = level.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = self._res_attn(mid.resnets[0], mid.attentions[0], h, temb, ctx)
        h = mid.resnets[1](h, temb)

        for level in self.up_blocks:
            for j, res in enumerate(level.resnets):
                h = self._res_attn(res, _attn(level, j), h, temb, ctx,
                                   skip=skips.pop())
            if hasattr(level, "upsamplers"):
                h = level.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()


def _attn(level, j):
    return level.attentions[j] if level.attentions is not None else None
