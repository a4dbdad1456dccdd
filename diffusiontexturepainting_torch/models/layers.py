"""Shared building blocks of the diffusion models, NHWC.

Port of diffusiontexturepainting_tpu/models/layers.py: the module legs and
the serving-only fused legs (ResnetBlock(fused=True), FeedForward(fused=True),
Transformer2D(gn_folded=True), Attention(slotted=True)).
A fused leg runs the same parameters as its module leg. Parameter names
follow diffusers; conv weights keep the JAX package's (kH, kW, Cin, Cout)
layout, which the conv kernels read, and linear weights PyTorch's (out, in),
which the feed-forward kernel reads.

Precision policy, as in the JAX package: parameters and activations share
one dtype (bf16 when serving); normalization statistics and softmax run in
fp32; matmul and convolution products accumulate in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import (
    SLOT,
    attention,
    flash_attention_slotted,
    slotted_self_attention_fits,
)
from ..ops.conv3x3 import (
    conv3x3,
    fold_upsample_weights,
    gn_silu_conv3x3,
    upsample2x_conv3x3,
)
from ..ops.ff_geglu import ff_geglu
from ..ops.gn_conv import gn_conv_resident, shift_stats_for_temb, stats_of
from ..ops.groupnorm import gn_affine_from_stats


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0):
    """Sinusoidal embedding: (B,) timesteps -> (B, dim) float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm over the channel-last axis: statistics in fp32 (E[x^2] -
    E[x]^2), normalization applied in the activation dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(b, -1, g, c // g)
        n = xg.shape[1] * xg.shape[3]
        mean = xg.sum(dim=(1, 3)) / n
        var = xg.square().sum(dim=(1, 3)) / n - mean.square()
        inv = torch.rsqrt(var + self.eps)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean_c = mean.repeat_interleave(c // g, dim=1).reshape(shape)
        inv_c = inv.repeat_interleave(c // g, dim=1).reshape(shape)
        dt = x.dtype
        y = (x - mean_c.to(dt)) * inv_c.to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)


class LayerNorm32(nn.Module):
    """LayerNorm computed in fp32, result in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class ConvNHWC(nn.Module):
    """Convolution of NHWC tensors through F.conv2d (the convs that are not
    the 3x3 resnet kind: stems, heads, stride-2 downsamples, CLIP's patch
    embedding). Weight (k, k, Cin, Cout), as every conv of this package."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, cin,
                                               cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.normal_(self.weight, std=(kernel_size**2 * cin) ** -0.5)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.permute(3, 2, 0, 1),
                     self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class Conv1x1(nn.Module):
    """1x1 conv as a matmul over the channel axis; weight (1, 1, Cin, Cout)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, std=cin**-0.5)

    def forward(self, x):
        return F.linear(x, self.weight[0, 0].t(), self.bias)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv through ops.conv3x3 (kernel K7 on CUDA); the
    weight is (3, 3, Cin, Cout), the kernel's layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.normal_(self.weight, std=(9 * cin) ** -0.5)

    def forward(self, x):
        return conv3x3(x, self.weight, self.bias)


def _slot_columns(w, num_heads: int, head_dim: int):
    """nn.Linear weight (h*hd, Din) -> (Din, h*128) head-slotted matrix:
    head h's hd output columns at lane h*128, zeros after, so x @ it is the
    slotted layout of the projection, exactly."""
    w3 = w.t().reshape(w.shape[1], num_heads, head_dim)
    return F.pad(w3, (0, SLOT - head_dim)).reshape(w.shape[1], -1)


def _slot_rows(w, num_heads: int, head_dim: int):
    """nn.Linear weight (Dout, h*hd) -> (h*128, Dout) with zero pad rows, so
    a slotted activation @ it equals the unslotted activation @ w.t()."""
    w3 = w.t().reshape(num_heads, head_dim, w.shape[0])
    return F.pad(w3, (0, 0, 0, SLOT - head_dim)).reshape(-1, w.shape[0])


def _slot_bias(b, num_heads: int, head_dim: int):
    return F.pad(b.reshape(num_heads, head_dim),
                 (0, SLOT - head_dim)).reshape(-1)


class Attention(nn.Module):
    """Multi-head attention with linear projections (diffusers names).

    `slotted` (the serving leg of the UNet's self-attention): the q/k/v
    projections run as one matmul against head-slotted weights (each head's
    columns zero-padded to a 128-lane slot), kernel K13 reads that layout in
    place, and the output projection takes it through zero pad rows: no
    head split or merge pass exists. The slotted weights are non-persistent
    buffers, built from the projections at construction and after every
    load_state_dict, so the state_dict is that of the plain leg. The leg
    applies to self-attention on (B, L, C) input whose length the kernel
    takes (slotted_self_attention_fits); other calls run the plain leg."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 kv_dim: int | None = None, qkv_bias: bool = False,
                 out_bias: bool = True, slotted: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        kv_dim = kv_dim or query_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim,
                                               bias=out_bias)])
        self.slotted = slotted and head_dim <= SLOT
        if self.slotted:
            for name, t in self._slot_weights().items():
                self.register_buffer(name, t, persistent=False)
            self.register_load_state_dict_post_hook(Attention._reslot)

    @torch.no_grad()
    def _slot_weights(self) -> dict:
        h, hd = self.num_heads, self.head_dim
        projs = (self.to_q, self.to_k, self.to_v)
        out = {"qkv_slotted": torch.cat([_slot_columns(p.weight, h, hd)
                                         for p in projs], dim=1),
               "out_slotted": _slot_rows(self.to_out[0].weight, h, hd)}
        if self.to_q.bias is not None:
            out["qkv_bias_slotted"] = torch.cat([_slot_bias(p.bias, h, hd)
                                                 for p in projs])
        return out

    @staticmethod
    def _reslot(module, incompatible_keys):
        # in place: a captured CUDA graph (core/engine.py) reads these
        # buffers at their addresses
        for name, t in module._slot_weights().items():
            getattr(module, name).copy_(t)

    def forward(self, x, context=None):
        if (self.slotted and context is None and x.dim() == 3
                and slotted_self_attention_fits(x.shape[1], x.shape[1],
                                                self.head_dim)):
            return self._forward_slotted(x)
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                        self.num_heads)
        return self.to_out[0](out)

    def _forward_slotted(self, x):
        qkv = x @ self.qkv_slotted
        if self.to_q.bias is not None:
            qkv = qkv + self.qkv_bias_slotted
        q, k, v = qkv.chunk(3, dim=-1)
        out = flash_attention_slotted(q, k, v, self.num_heads, self.head_dim)
        y = out @ self.out_slotted
        bo = self.to_out[0].bias
        return y if bo is None else y + bo


class GEGLU(nn.Module):
    """Gated GELU input projection (erf GELU)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    """GEGLU (UNet) or plain GELU (patch encoder) feed-forward; the
    parameterless net.1 keeps diffusers' net.0 / net.2 names. With
    `fused` (GEGLU, given the residual) the whole feed-forward and the
    residual add run as one kernel (ops.ff_geglu, K3 on CUDA) over the
    modules' own weights."""

    def __init__(self, dim: int, mult: int = 4, activation: str = "geglu",
                 fused: bool = False):
        super().__init__()
        inner = dim * mult
        if activation == "geglu":
            act = GEGLU(dim, inner)
        elif activation == "gelu":
            act = GELUProj(dim, inner)
        else:
            raise ValueError(activation)
        self.fused = fused and activation == "geglu"
        self.net = nn.ModuleList([act, nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x, residual=None):
        if self.fused and residual is not None:
            c = residual.shape[-1]
            proj, out = self.net[0].proj, self.net[2]
            y = ff_geglu(x.reshape(-1, c), proj.weight, proj.bias, out.weight,
                         out.bias, residual.reshape(-1, c))
            return y.reshape(residual.shape)
        y = self.net[2](self.net[0](x))
        return y if residual is None else residual + y


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> FF, all residual. With
    no context, attn2 is self-attention again (the patch encoder).
    `attn_slotted`: attn1 takes its slotted leg."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 kv_dim: int | None = None, qkv_bias: bool = False,
                 ff_activation: str = "geglu", ff_fused: bool = False,
                 attn_slotted: bool = False):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = Attention(dim, num_heads, head_dim, qkv_bias=qkv_bias,
                               slotted=attn_slotted)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = Attention(dim, num_heads, head_dim, kv_dim=kv_dim,
                               qkv_bias=qkv_bias)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim, activation=ff_activation, fused=ff_fused)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return self.ff(self.norm3(x), residual=x)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> 3x3 conv, twice, with optional time conditioning; eps
    is 1e-5 in the UNet and 1e-6 in the VAE.

    `fused` (the UNet's serving leg, kernel K1 on CUDA): each GroupNorm +
    SiLU folds into its conv's prologue, with the affine derived from the
    previous conv's statistics epilogue; the time embedding folds into
    GN2's statistics and affine (shift_stats_for_temb, c + t*a). An up-path
    `skip` stays un-concatenated: its GroupNorm statistics are the parts'
    statistics side by side, conv1 runs as two chained calls over the two
    halves of its weight (the second adds onto the first through its
    residual), and the 1x1 shortcut as two matmuls."""

    def __init__(self, cin: int, cout: int, num_groups: int = 32,
                 temb_dim: int | None = None, eps: float = 1e-5,
                 fused: bool = False):
        super().__init__()
        self.fused = fused
        self.norm1 = GroupNorm32(num_groups, cin, eps)
        self.conv1 = Conv3x3(cin, cout)
        self.time_emb_proj = (nn.Linear(temb_dim, cout)
                              if temb_dim is not None else None)
        self.norm2 = GroupNorm32(num_groups, cout, eps)
        self.conv2 = Conv3x3(cout, cout)
        self.conv_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x, temb=None, skip=None, return_stats=False):
        """return_stats: (out, statistics of out) on the fused leg, for a
        following Transformer2D's folded GroupNorm; (out, None) on the
        module leg."""
        if self.fused:
            return self._forward_fused(x, temb, skip, return_stats)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + h, None) if return_stats else x + h

    def _forward_fused(self, x, temb, skip, return_stats):
        _, H, W, ca = x.shape
        n_sp = H * W
        g, eps = self.norm1.num_groups, self.norm1.eps
        w1, b1 = self.conv1.weight, self.conv1.bias
        if skip is None:
            a1, c1 = gn_affine_from_stats(stats_of(x), self.norm1.weight,
                                          self.norm1.bias, g, n_sp, eps)
            h, st = gn_conv_resident(x, a1, c1, w1, b1, None, True)
        else:
            st_in = torch.cat([stats_of(x), stats_of(skip)], dim=-1)
            a1, c1 = gn_affine_from_stats(st_in, self.norm1.weight,
                                          self.norm1.bias, g, n_sp, eps)
            h1, _ = gn_conv_resident(x, a1[:, :ca], c1[:, :ca],
                                     w1[:, :, :ca], b1, None, False)
            h, st = gn_conv_resident(skip, a1[:, ca:], c1[:, ca:],
                                     w1[:, :, ca:], None, h1, True)
        t = None
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            st = shift_stats_for_temb(st, t, n_sp)
        a2, c2 = gn_affine_from_stats(st, self.norm2.weight, self.norm2.bias,
                                      g, n_sp, eps)
        if t is not None:
            c2 = c2 + t.float() * a2
        sc = self.conv_shortcut
        if skip is not None and sc is not None:
            w00 = sc.weight[0, 0]
            res = x @ w00[:ca] + skip @ w00[ca:] + sc.bias
        elif skip is not None:
            res = torch.cat([x, skip], dim=-1)
        else:
            res = sc(x) if sc is not None else x
        out, st = gn_conv_resident(h, a2, c2, self.conv2.weight,
                                   self.conv2.bias, res, return_stats)
        return (out, st) if return_stats else out


def resnet_gn_silu_conv(block, x, temb=None, skip=None):
    """A ResnetBlock's forward as two fused GroupNorm -> SiLU -> conv calls
    (ops.conv3x3.gn_silu_conv3x3, kernel K10 on CUDA), each taking the
    statistics of its own input: conv1 with the projected time embedding
    added, conv2 with the shortcut as its residual; an up-path `skip` is
    concatenated first. The block's own parameters; the arithmetic rounds
    once per conv where the module leg rounds after each operation."""
    if skip is not None:
        x = torch.cat([x, skip], dim=-1)
    t = None
    if block.time_emb_proj is not None and temb is not None:
        t = block.time_emb_proj(F.silu(temb))
    n1, n2 = block.norm1, block.norm2
    h = gn_silu_conv3x3(x, n1.weight, n1.bias, block.conv1.weight,
                        block.conv1.bias, t, None, n1.num_groups, n1.eps)
    sc = block.conv_shortcut
    return gn_silu_conv3x3(h, n2.weight, n2.bias, block.conv2.weight,
                           block.conv2.bias, None,
                           sc(x) if sc is not None else x, n2.num_groups,
                           n2.eps)


class Downsample(nn.Module):
    """Stride-2 3x3 conv; `asymmetric_pad` is the VAE encoder's (0,1,0,1)
    padding, the UNet pads 1 on every side."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = ConvNHWC(channels, channels, 3, stride=2,
                             padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 + 3x3 conv through ops.upsample2x_conv3x3 (kernel K4 on
    CUDA). The kernel's 16 folded taps are a buffer, folded from the conv
    weight at construction and again, in place, after every
    load_state_dict; load weights in the dtype the module runs in."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)
        self.register_buffer("taps", self._fold(), persistent=False)
        self.register_load_state_dict_post_hook(Upsample._refold)

    @torch.no_grad()
    def _fold(self):
        return fold_upsample_weights(self.conv.weight.detach())

    @staticmethod
    def _refold(module, incompatible_keys):
        # in place: a captured CUDA graph (core/engine.py) reads the taps at
        # their address
        with torch.no_grad():
            module.taps.copy_(module._fold())

    def forward(self, x):
        return upsample2x_conv3x3(x, self.conv.weight, self.conv.bias,
                                  self.taps)


class Transformer2D(nn.Module):
    """GN -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, residual.

    `gn_folded` (serving leg): the GroupNorm folds into proj_in,
    (x*a + c) @ W = (x*a) @ W + c @ W, with (a, c) from `in_stats` (the
    preceding fused resnet's statistics epilogue) or from one statistics
    pass over x. `ff_fused`: the blocks' feed-forwards run as kernel K3.
    `attn_slotted`: their self-attentions take the slotted leg (K13)."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 depth: int = 1, kv_dim: int | None = None,
                 num_groups: int = 32, ff_fused: bool = False,
                 gn_folded: bool = False, attn_slotted: bool = False):
        super().__init__()
        self.gn_folded = gn_folded
        self.norm = GroupNorm32(num_groups, channels, eps=1e-6)
        self.proj_in = Conv1x1(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, num_heads, head_dim, kv_dim=kv_dim,
                                  ff_fused=ff_fused,
                                  attn_slotted=attn_slotted)
            for _ in range(depth)])
        self.proj_out = Conv1x1(channels, channels)

    def forward(self, x, context=None, in_stats=None):
        b, h, w, c = x.shape
        if self.gn_folded:
            st = in_stats if in_stats is not None else stats_of(x)
            a, cc = gn_affine_from_stats(st, self.norm.weight, self.norm.bias,
                                         self.norm.num_groups, h * w,
                                         self.norm.eps)
            w00 = self.proj_in.weight[0, 0]
            hidden = (x * a[:, None, None, :].to(x.dtype)) @ w00
            shift = cc @ w00.float() + self.proj_in.bias.float()
            hidden = (hidden + shift[:, None, None, :].to(x.dtype)).reshape(
                b, h * w, c)
        else:
            hidden = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        return self.proj_out(hidden.reshape(b, h, w, c)) + x
