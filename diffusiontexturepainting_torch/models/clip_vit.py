"""CLIP ViT-B/32 vision tower, NHWC patch conv, quick-GELU.

Port of diffusiontexturepainting_tpu/models/clip_vit.py: the pooled
feature post_layernorm(CLS) without projection. Names follow Hugging Face
CLIPVisionModel (vision_model.embeddings.*, pre_layrnorm,
encoder.layers.*, post_layernorm), which weights/convert.py convert_clip_hf
reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import CLIPVisionConfig
from ..ops.attention import attention
from .layers import ConvNHWC, LayerNorm32


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def causal_attention(q, k, v, num_heads: int):
    """Attention under a causal mask in plain PyTorch ops, the JAX
    package's _causal_attention (plain XLA there too: the text tower's
    77-token sequences run no kernel): fp32 scores and softmax, the
    probabilities rounded to the input dtype, the product accumulated in
    fp32, the result in the input dtype."""
    b, n, d = q.shape
    hd = d // num_heads
    split = lambda t: t.reshape(b, n, num_heads, hd).transpose(1, 2).float()
    qh, kh, vh = split(q), split(k), split(v)
    scores = (qh @ kh.transpose(-1, -2)) * hd**-0.5
    mask = torch.full((n, n), float("-inf"), device=q.device).triu(1)
    probs = torch.softmax(scores + mask, dim=-1).to(q.dtype).float()
    out = probs @ vh
    return out.transpose(1, 2).reshape(b, n, d).to(q.dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = ConvNHWC(3, cfg.hidden_size, cfg.patch_size,
                                        stride=cfg.patch_size, bias=False)
        num_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(num_pos, cfg.hidden_size)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)


class CLIPEncoderLayer(nn.Module):
    """A pre-LN CLIP layer; `causal`: the text tower's, whose attention is
    causal_attention."""

    def __init__(self, cfg: CLIPVisionConfig, causal: bool = False):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.causal = causal
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(cfg.hidden_size)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        sa = self.self_attn
        h = self.layer_norm1(x)
        attend = causal_attention if self.causal else attention
        a = attend(sa.q_proj(h), sa.k_proj(h), sa.v_proj(h), self.num_heads)
        x = x + sa.out_proj(a)
        h = quick_gelu(self.mlp.fc1(self.layer_norm2(x)))
        return x + self.mlp.fc2(h)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class CLIPVisionTower(nn.Module):
    """pixel_values (B, H, W, 3), CLIP-normalized -> (B, hidden) fp32."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        # Hugging Face's historical spelling, kept for checkpoint names
        self.pre_layrnorm = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixel_values):
        emb = self.embeddings
        dt = emb.class_embedding.dtype
        patches = emb.patch_embedding(pixel_values.to(dt))
        b, gh, gw, c = patches.shape
        cls = emb.class_embedding.expand(b, 1, c)
        tokens = torch.cat([cls, patches.reshape(b, gh * gw, c)], dim=1)
        tokens = tokens + emb.position_embedding.weight[None,
                                                        :tokens.shape[1]]
        tokens = self.pre_layrnorm(tokens)
        for layer in self.encoder.layers:
            tokens = layer(tokens)
        return self.post_layernorm(tokens[:, 0].float())


class CLIPVisionModel(nn.Module):
    """Holds the tower under `vision_model`, as Hugging Face names it."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.vision_model = CLIPVisionTower(cfg)

    def forward(self, pixel_values):
        return self.vision_model(pixel_values)
