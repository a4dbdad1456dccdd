"""The inpainting stamp: u8 canvas in, u8 stamp out.

Port of diffusiontexturepainting_tpu/pipeline/inpaint.py make_stamp_fn and
make_preview_fn, exact DDIM path (no DeepCache, no f32 final step):

    canvas u8 -> normalize/split -> context dilation (prefix sums)
    -> one batch-2 VAE encode (both branches)
    -> DDIM loop (CFG triple-batch UNet + dual-guidance combine)
    -> VAE decode -> [0,1] -> alpha composite -> u8 (truncating)

The random draws are inputs: `enc_noise` (the VAE posterior sample of both
branches) and `init_latents`; DDIM with eta = 0 draws nothing per step.
"""

from __future__ import annotations

import torch

from ..models.vae import sample_latents
from ..ops.morphology import add_extra_context
from ..ops.resize import nearest_downsample
from ..schedulers.ddim import DDIMScheduler


def make_stamp_fn(unet, vae_encoder, vae_decoder, num_steps: int,
                  vae_scaling: float = 0.18215):
    """Returns stamp(canvas_u8 (1,H,W,4) uint8, brush (1,H,W,3) in [0,1],
    cond (1,L,D), uncond (1,L,D), enc_noise (2,H/8,W/8,4),
    init_latents (1,H/8,W/8,4), cfg_weight, tg_weight, tg_steps,
    context_pad) -> (raw_u8 (H,W,3), composited_u8 (H,W,3))."""
    scheduler = DDIMScheduler().set_timesteps(num_steps)
    timesteps = scheduler.scan_rows()["timestep"]

    @torch.inference_mode()
    def stamp(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
              cfg_weight, tg_weight, tg_steps, context_pad):
        canvas = canvas_u8.float() / 255.0
        images = canvas[..., :3] * 2.0 - 1.0
        mask = canvas[..., 3:4]
        masked_images = images * mask

        ctx_masked, ctx_mask = add_extra_context(
            brush.float() * 2.0 - 1.0, masked_images, mask, context_pad)
        # UNet convention: 1 = generate here
        m_lat = nearest_downsample(1.0 - mask, 8)
        cm_lat = nearest_downsample(1.0 - ctx_mask, 8)
        mask_lat = torch.cat([m_lat, m_lat, cm_lat], dim=0)

        moments = vae_encoder(torch.cat([masked_images, ctx_masked], dim=0))
        lat = sample_latents(moments, enc_noise) * vae_scaling
        masked_latents = torch.cat([lat[:1], lat[:1], lat[1:]], dim=0)
        embeddings = torch.cat([uncond.float(), cond.float(), cond.float()],
                               dim=0)

        latents = init_latents.float() * scheduler.init_noise_sigma
        for i in range(scheduler.num_iterations()):
            tg_scale = float(tg_weight) if i < int(tg_steps) else 0.0
            unet_in = torch.cat([torch.cat([latents] * 3, dim=0), mask_lat,
                                 masked_latents], dim=-1)
            t = torch.full((3,), float(timesteps[i]), device=latents.device)
            eps_u, eps_c, eps_tg = unet(unet_in, t, embeddings).chunk(3)
            eps = (eps_u + float(cfg_weight) * (eps_c - eps_u)
                   + tg_scale * (eps_tg - eps_c))
            latents = scheduler.step(eps, latents, i)

        decoded = vae_decoder(latents / vae_scaling)
        result = torch.clamp(decoded / 2.0 + 0.5, 0.0, 1.0)
        composited = canvas[..., :3] * mask + result * (1.0 - mask)
        return _to_u8(result[0]), _to_u8(composited[0])

    return stamp


def _to_u8(x):
    # float -> uint8 truncates, as the JAX package's astype(uint8)
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def preview_canvas_u8(brush):
    """(1,R,R,3) brush in [0,1] -> (1,R,R,4) u8 canvas whose top-left
    quadrant is the brush, known (the brush preview's input)."""
    res = brush.shape[1]
    center = res // 2
    idx = torch.arange(res, device=brush.device)
    quad = (idx[:, None] < center) & (idx[None, :] < center)
    mask = quad.to(torch.float32)[None, :, :, None]
    canvas = torch.cat([brush.float() * mask, mask], dim=-1)
    return _to_u8(canvas)


def make_preview_fn(unet, vae_encoder, vae_decoder, num_steps: int,
                    vae_scaling: float = 0.18215):
    """Brush preview: the stamp on preview_canvas_u8(brush)."""
    stamp = make_stamp_fn(unet, vae_encoder, vae_decoder, num_steps,
                          vae_scaling)

    def preview(brush, cond, uncond, enc_noise, init_latents, cfg_weight,
                tg_weight, tg_steps, context_pad):
        return stamp(preview_canvas_u8(brush), brush, cond, uncond,
                     enc_noise, init_latents, cfg_weight, tg_weight,
                     tg_steps, context_pad)

    return preview
