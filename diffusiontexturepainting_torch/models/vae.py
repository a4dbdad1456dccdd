"""SD AutoencoderKL encoder and decoder, NHWC.

Port of diffusiontexturepainting_tpu/models/vae.py: the module path and
the fused serving path (fused_encode / fused_decode: every resnet conv and
both output heads as chained GroupNorm-prologue / statistics-epilogue convs,
kernel K5; the decoder's upsamples with statistics, K6), chosen by
`fused` on VAEEncoder / VAEDecoder over the same parameters. Names follow
diffusers' AutoencoderKL (encoder.*, quant_conv, post_quant_conv,
decoder.*), so the state_dicts convert with weights/convert.py.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.config import VAEConfig
from ..ops.gn_conv import (
    gn_affine_from_stats,
    gn_conv_stream,
    stats_of,
    upconv_stream,
)
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
    """images (B,H,W,3) in [-1,1] -> moments (B,H/8,W/8,2*latent) fp32;
    `fused` runs fused_encode."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused = fused
        self.encoder = _Encoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels)

    def forward(self, x):
        if self.fused:
            return fused_encode(self, x)
        x = x.to(self.quant_conv.weight.dtype)
        return self.quant_conv(self.encoder(x)).float()


class VAEDecoder(nn.Module):
    """latents (B,h,w,4), already divided by the scaling factor -> images
    (B,8h,8w,3) in about [-1,1], fp32; `fused` runs fused_decode."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused = fused
        self.post_quant_conv = Conv1x1(cfg.latent_channels,
                                       cfg.latent_channels)
        self.decoder = _Decoder(cfg)

    def forward(self, z):
        if self.fused:
            return fused_decode(self, z)
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


# --- the fused serving path ---
#
# The same modules' parameters executed as a chain of fused convs: every
# conv emits the (sum, sumsq) statistics of its output, and the next
# GroupNorm folds into a per-(B, C) affine applied in the next conv's
# prologue, so no GroupNorm makes a pass of its own over a large tensor.
# The RGB stem, the stride-2 downsamples and the 1x1 convs stay plain
# PyTorch, as the JAX package leaves them to XLA.


def _bias_round(y, bias, dt):
    """y + bias in fp32, rounded to dt (the JAX path's bias epilogue)."""
    return (y.float() + bias.float()).to(dt)


def _conv(x, conv, stride=1, padding=1):
    """A plain conv (ConvNHWC's weight) in x's dtype, bias added in fp32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.permute(3, 2, 0, 1),
                 None, stride, padding)
    return _bias_round(y.permute(0, 2, 3, 1), conv.bias, x.dtype)


def _conv_in_im2col(x, conv):
    """The RGB stem (3x3 SAME, Cin 3) as one (B*H*W, 9*Cin) matmul."""
    b, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    panel = torch.cat([xp[:, di:di + h, dj:dj + w] for di in range(3)
                       for dj in range(3)], dim=-1)
    kmat = conv.weight.reshape(9 * cin, -1)
    return _bias_round(panel @ kmat, conv.bias, x.dtype)


def _dense1x1(x, conv):
    return _bias_round(x @ conv.weight[0, 0], conv.bias, x.dtype)


def _fused_resnet(res, h, stats):
    """One ResnetBlock (no time embedding) as two fused convs; returns
    (out, statistics of out)."""
    n_sp = h.shape[1] * h.shape[2]
    g, eps = res.norm1.num_groups, res.norm1.eps
    a1, c1 = gn_affine_from_stats(stats, res.norm1.weight, res.norm1.bias, g,
                                  n_sp, eps)
    h1, s1 = gn_conv_stream(h, a1, c1, res.conv1.weight, res.conv1.bias,
                            None, True)
    a2, c2 = gn_affine_from_stats(s1, res.norm2.weight, res.norm2.bias, g,
                                  n_sp, eps)
    residual = (_dense1x1(h, res.conv_shortcut)
                if res.conv_shortcut is not None else h)
    return gn_conv_stream(h1, a2, c2, res.conv2.weight, res.conv2.bias,
                          residual, True)


def _fused_mid(mid, h, stats):
    h, stats = _fused_resnet(mid.resnets[0], h, stats)
    b, hh, ww, c = h.shape
    attn = mid.attentions[0]
    gn = attn.group_norm
    a, cc = gn_affine_from_stats(stats, gn.weight, gn.bias, gn.num_groups,
                                 hh * ww, gn.eps)
    hn = (h.float() * a[:, None, None, :] + cc[:, None, None, :]).to(h.dtype)
    out = attn(hn.reshape(b, hh * ww, c))
    h = h + out.reshape(b, hh, ww, c)
    return _fused_resnet(mid.resnets[1], h, stats_of(h))


def _fused_norm_silu_conv(norm, conv, h, stats):
    """conv_norm_out -> SiLU -> conv_out head, one fused conv."""
    a, c = gn_affine_from_stats(stats, norm.weight, norm.bias,
                                norm.num_groups, h.shape[1] * h.shape[2],
                                norm.eps)
    out, _ = gn_conv_stream(h, a, c, conv.weight, conv.bias, None, False)
    return out


def fused_encode(vae: VAEEncoder, images):
    """The fused equivalent of VAEEncoder's module path (same parameters,
    same output)."""
    enc = vae.encoder
    h = _conv_in_im2col(images.to(vae.quant_conv.weight.dtype), enc.conv_in)
    stats = stats_of(h)
    for level in enc.down_blocks:
        for res in level.resnets:
            h, stats = _fused_resnet(res, h, stats)
        if hasattr(level, "downsamplers"):
            # the SD encoder's asymmetric (0, 1) padding
            h = _conv(F.pad(h, (0, 0, 0, 1, 0, 1)),
                      level.downsamplers[0].conv, stride=2, padding=0)
            stats = stats_of(h)
    h, stats = _fused_mid(enc.mid_block, h, stats)
    h = _fused_norm_silu_conv(enc.conv_norm_out, enc.conv_out, h, stats)
    return _dense1x1(h, vae.quant_conv).float()


def fused_decode(vae: VAEDecoder, latents):
    """The fused equivalent of VAEDecoder's module path."""
    dec = vae.decoder
    z = _dense1x1(latents.to(vae.post_quant_conv.weight.dtype),
                  vae.post_quant_conv)
    h = _conv(z, dec.conv_in)
    h, stats = _fused_mid(dec.mid_block, h, stats_of(h))
    for level in dec.up_blocks:
        for res in level.resnets:
            h, stats = _fused_resnet(res, h, stats)
        if hasattr(level, "upsamplers"):
            up = level.upsamplers[0]
            h, stats = upconv_stream(h, up.conv.weight, up.conv.bias, up.taps,
                                     True)
    h = _fused_norm_silu_conv(dec.conv_norm_out, dec.conv_out, h, stats)
    return h.float()
