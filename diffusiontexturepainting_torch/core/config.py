"""Configuration of the models and the serving pipeline the port runs.

The same values, under the same names, as the JAX package's core/config.py
(tests/test_torch_port_wire.py holds every field here equal to its
counterpart there). The fused execution switches are kept, with the JAX
package's defaults, except the head-slotted attention (off by default
there); the port runs the exact DDIM path only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 inpainting UNet (9 input channels)."""

    in_channels: int = 9
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD-1.x quirk: "attention_head_dim=8" means 8 heads; the head dim is
    # channels / 8 at each level.
    num_attention_heads: int = 8
    norm_num_groups: int = 32
    # levels whose down/up blocks carry cross-attention transformers
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    time_embed_dim_mult: int = 4
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    # Serving-only fused execution (same parameters): resnets as chained
    # GroupNorm-prologue / statistics-epilogue convs (kernel K1), the
    # transformer feed-forward as one kernel (K3), and each Transformer2D's
    # GroupNorm folded into proj_in from the resnet's statistics.
    fused_resnet: bool = False
    fused_ff: bool = False
    fused_norm: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult


@dataclass(frozen=True)
class VAEConfig:
    """SD-1.5 AutoencoderKL."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2  # encoder resnets per block; decoder uses +1
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-B/32 vision tower (pooled output: post-LN CLS token)."""

    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class PatchEncoderConfig:
    """ConditionPatchEncoder: the brush's multi-scale CLIP patch tokens."""

    cross_attention_dim: int = 768
    num_layers: int = 4
    hid_size: int = 768
    num_heads: int = 4
    num_patches: Tuple[int, ...] = (1, 4, 9)
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)

    @property
    def total_patches(self) -> int:
        return sum(self.num_patches)


@dataclass(frozen=True)
class PipelineConfig:
    """Serving defaults: the client's settings when a request omits them."""

    denoising_steps: int = 20
    guidance_scale: float = 2.0
    texture_guidance_scale: float = 1.0
    texture_guidance_steps: int = 20
    context_pad: int = 150
    seed: int = 42
    # Fused execution, the default as in the JAX package: the VAE as chained
    # GroupNorm-conv kernels (K5, K6), the UNet's resnets (K1), feed-forwards
    # (K3) and folded Transformer2D norms. All False is the "safe twin":
    # module legs only, the same parameters.
    fused_vae_encoder: bool = True
    fused_vae_decoder: bool = True
    fused_unet_resnet: bool = True
    fused_unet_ff: bool = True
    fused_unet_norm: bool = True


def safe_twin_config(config: PipelineConfig = PipelineConfig()
                     ) -> PipelineConfig:
    """`config` with every fused switch off: the module legs only, over the
    same parameters."""
    return dataclasses.replace(config, **{
        f.name: False for f in dataclasses.fields(config)
        if f.name.startswith("fused")})


# CLIP image normalization
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def tiny_unet_config() -> UNetConfig:
    """Small UNet for CPU tests: same topology, narrow channels."""
    return UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                      cross_attention_dim=32, num_attention_heads=2,
                      norm_num_groups=8)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                     norm_num_groups=8)


def tiny_clip_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2)


def tiny_patch_encoder_config() -> PatchEncoderConfig:
    return PatchEncoderConfig(cross_attention_dim=32, num_layers=1,
                              hid_size=32, num_heads=2,
                              clip=tiny_clip_config())
