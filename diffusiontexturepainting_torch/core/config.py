"""Configuration of the models and the serving pipeline the port runs.

The same values, under the same names, as the JAX package's core/config.py
(tests/test_torch_port_wire.py holds every field here equal to its
counterpart there). The fused execution switches are kept, with the JAX
package's defaults, and so are the operating points: DeepCache by interval
or by pattern (`parse_deep_cache_spec`) and the f32 final step.
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
    # Head-slotted self-attention: the q/k/v projection emits the
    # (B, L, heads*128) layout kernel K13 reads in place.
    fused_attn: bool = False

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
class CLIPTextConfig:
    """CLIP ViT-L/14 text tower (SD-1.5's text encoder): on no request path
    of the server (the brush's patch encoder conditions the UNet), kept for
    text-conditioned use of the same weights; see models/clip_text.py."""

    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    # openai/clip-vit-large-patch14 token ids (SD-1.5 tokenizer)
    bos_token_id: int = 49406
    eos_token_id: int = 49407


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

    scheduler: str = "DDIM"  # a name of schedulers.available_schedulers()
    denoising_steps: int = 20
    guidance_scale: float = 2.0
    texture_guidance_scale: float = 1.0
    texture_guidance_steps: int = 20
    context_pad: int = 150
    seed: int = 42
    # DeepCache: the full UNet every `deep_cache_interval`-th model call, the
    # outermost level against the cached deep feature in between (1: off,
    # exact). A uniform interval applies to requests of at least
    # deep_cache_min_steps steps; an 'F'/'S' pattern such as 'FSSF' pins
    # each model call, applies exactly where the scheduler's model calls
    # number its length (PNDM: steps + 1) and bypasses the gate.
    deep_cache_interval: int | str = 1
    deep_cache_min_steps: int = 8
    # The final model call's UNet eval in fp32 (the module legs over the
    # serving weights, upcast); the other calls as configured.
    f32_final_step: bool = False
    # Fused execution, the default as in the JAX package: the VAE as chained
    # GroupNorm-conv kernels (K5, K6), the UNet's resnets (K1), feed-forwards
    # (K3) and folded Transformer2D norms. All False is the "safe twin":
    # module legs only, the same parameters.
    fused_vae_encoder: bool = True
    fused_vae_decoder: bool = True
    fused_unet_resnet: bool = True
    fused_unet_ff: bool = True
    fused_unet_norm: bool = True
    # Head-slotted UNet self-attention (kernel K13), off by default as in
    # the JAX package.
    fused_unet_attn: bool = False


def parse_deep_cache_spec(value):
    """A DeepCache spec from an int or from text: an interval >= 1, or an
    'F'/'S' pattern starting with 'F' (upper-cased). Raises ValueError
    otherwise, an interval below 1 included, which the JAX package's parser
    accepts and then serves as 1. Whether a pattern's length matches a
    scheduler is the stamp function's check."""
    text = str(value).strip()
    if isinstance(value, int) or text.lstrip("+-").isdigit():
        interval = value if isinstance(value, int) else int(text)
        if interval < 1 or isinstance(value, bool):
            raise ValueError(f"DeepCache interval {value!r}: must be an "
                             "int >= 1 (1 is off)")
        return interval
    pattern = text.upper()
    if not pattern or set(pattern) - {"F", "S"} or pattern[0] != "F":
        raise ValueError(
            f"DeepCache spec {value!r}: expected an int interval >= 1 or an "
            "'F'/'S' pattern starting with 'F'")
    return pattern


def safe_twin_config(config: PipelineConfig = PipelineConfig()
                     ) -> PipelineConfig:
    """`config` with every fused switch off: the module legs only, over the
    same parameters."""
    return dataclasses.replace(config, **{
        f.name: False for f in dataclasses.fields(config)
        if f.name.startswith("fused")})


def slotted_config(config: PipelineConfig = PipelineConfig()
                   ) -> PipelineConfig:
    """`config` with the head-slotted self-attention on, over the same
    parameters."""
    return dataclasses.replace(config, fused_unet_attn=True)


CONFIG_NAMES = ("default", "safe_twin", "slotted")
# the serving model's components, the names --f32-components takes
COMPONENTS = ("unet", "vae_encoder", "vae_decoder", "patch_encoder")


def pipeline_config(name: str) -> PipelineConfig:
    """The serving configuration called `name` (one of CONFIG_NAMES)."""
    return {"default": PipelineConfig, "safe_twin": safe_twin_config,
            "slotted": slotted_config}[name]()


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
