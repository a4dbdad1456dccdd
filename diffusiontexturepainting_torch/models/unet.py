"""SD-1.5 inpainting UNet (9-channel input), NHWC.

Port of diffusiontexturepainting_tpu/models/unet.py: `forward` (the JAX
`__call__`) and the DeepCache forwards under the JAX names, `forward_full`
(the noise and the cache, the last upsample's output) and `forward_shallow`
(the outermost level against a cache), built from the same pieces
(`_temb`, `_level0`, `_level_last_up`). Submodule names follow diffusers'
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

    def _temb(self, timestep, batch, device):
        """The projected time embedding of (B,) or scalar timesteps."""
        cfg = self.cfg
        t = torch.as_tensor(timestep, dtype=torch.float32,
                            device=device).reshape(-1)
        t = t.expand(batch) if t.shape[0] != batch else t
        temb = timestep_embedding(t, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        return self.time_embedding(temb.to(self.conv_in.weight.dtype))

    def _level0(self, sample, temb, ctx):
        """conv_in and the outermost down level's resnets and transformers
        (not its downsample): (h, skips), what the shallow forward shares
        with the full one."""
        h = self.conv_in(sample.to(self.conv_in.weight.dtype))
        skips = [h]
        level = self.down_blocks[0]
        for j, res in enumerate(level.resnets):
            h = self._res_attn(res, _attn(level, j), h, temb, ctx)
            skips.append(h)
        return h, skips

    def _level_last_up(self, h, skips, temb, ctx):
        """The outermost up level and the output head: (B, H, W, 4) fp32."""
        level = self.up_blocks[-1]
        for j, res in enumerate(level.resnets):
            h = self._res_attn(res, _attn(level, j), h, temb, ctx,
                               skip=skips.pop())
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.float()

    def forward(self, sample, timestep, encoder_hidden_states):
        """(B, H, W, 9), t (scalar or (B,)), (B, L, D) -> (B, H, W, 4)
        predicted noise in fp32."""
        return self.forward_full(sample, timestep, encoder_hidden_states)[0]

    def forward_full(self, sample, timestep, encoder_hidden_states):
        """forward's noise and the DeepCache feature: the tensor entering
        the outermost up level (the last upsample's output, (B, H, W,
        block_out_channels[-2]) in the module's dtype)."""
        ctx = encoder_hidden_states.to(self.conv_in.weight.dtype)
        temb = self._temb(timestep, sample.shape[0], sample.device)
        h, skips = self._level0(sample, temb, ctx)
        if hasattr(self.down_blocks[0], "downsamplers"):
            h = self.down_blocks[0].downsamplers[0](h)
            skips.append(h)
        for level in self.down_blocks[1:]:
            for j, res in enumerate(level.resnets):
                h = self._res_attn(res, _attn(level, j), h, temb, ctx)
                skips.append(h)
            if hasattr(level, "downsamplers"):
                h = level.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = self._res_attn(mid.resnets[0], mid.attentions[0], h, temb, ctx)
        h = mid.resnets[1](h, temb)

        for level in self.up_blocks[:-1]:
            for j, res in enumerate(level.resnets):
                h = self._res_attn(res, _attn(level, j), h, temb, ctx,
                                   skip=skips.pop())
            h = level.upsamplers[0](h)
        return self._level_last_up(h, skips, temb, ctx), h

    def forward_shallow(self, sample, timestep, encoder_hidden_states,
                        cache):
        """DeepCache's cached forward: only the outermost level, with
        `cache` (forward_full's second output) in place of everything
        deeper."""
        ctx = encoder_hidden_states.to(self.conv_in.weight.dtype)
        temb = self._temb(timestep, sample.shape[0], sample.device)
        _, skips = self._level0(sample, temb, ctx)
        return self._level_last_up(cache.to(self.conv_in.weight.dtype),
                                   skips, temb, ctx)


def _attn(level, j):
    return level.attentions[j] if level.attentions is not None else None
