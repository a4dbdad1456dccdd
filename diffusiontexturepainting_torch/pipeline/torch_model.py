"""TorchConditionalInpainter: the serving model of the port.

Port of diffusiontexturepainting_tpu/pipeline/tpu_model.py for the exact
DDIM stamp path: `resolution`, `set_brush`, `generate_raw`, `generate`,
`generate_u8` and `create_preview_brush_context`, with the same
wire-settings parsing, so it answers the port's own request handler
(serving/wire.py) and the JAX package's framework-free server
(`serving/run.py create_server(model=...)`) alike. Stroke sessions are not
ported yet: their methods raise.

The configuration's fused_* switches (all True by default, as in the JAX
package) choose the UNet's and the VAE's serving legs: the fused kernels
(K1, K3, K5, K6) or, with all of them False, the module legs ("safe
twin"). Both take the same state_dict.

Random draws: request n (the model's request counter) draws its VAE
posterior noise and initial latents from a torch.Generator seeded with
(config.seed, n), so a request is reproducible from its counter.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..core.config import (
    PatchEncoderConfig,
    PipelineConfig,
    UNetConfig,
    VAEConfig,
    tiny_patch_encoder_config,
    tiny_unet_config,
    tiny_vae_config,
)
from ..models.patch_encoder import encode_brush_image
from ..serving.model_base import (
    crop_resize_square,
    ensure_float01,
    preview_brush_context,
)
from ..weights.random_init import init_pipeline
from .inpaint import make_stamp_fn

logger = logging.getLogger(__name__)


class TorchConditionalInpainter:
    def __init__(self, resolution: int = 256,
                 config: PipelineConfig | None = None,
                 device: str | torch.device = "cuda", tiny: bool = False,
                 weights: dict | None = None):
        """Seeded random weights (no checkpoint loading yet), or `weights`
        (a state_dict per component, as state_dicts() returns), built on
        `device` and cast once to bf16 on CUDA (fp32 on the CPU, as the JAX
        package serves bf16 on a TPU only). `tiny` uses the JAX package's
        tiny_*_config() models."""
        self._resolution = int(resolution)
        self.config = config or PipelineConfig()
        self.device = torch.device(device)
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        if tiny:
            cfgs = (tiny_unet_config(), tiny_vae_config(),
                    tiny_patch_encoder_config())
        else:
            cfgs = (UNetConfig(), VAEConfig(), PatchEncoderConfig())
        c = self.config
        ucfg = dataclasses.replace(cfgs[0], fused_resnet=c.fused_unet_resnet,
                                   fused_ff=c.fused_unet_ff,
                                   fused_norm=c.fused_unet_norm)
        tic = time.perf_counter()
        models = init_pipeline(
            ucfg, *cfgs[1:], device=self.device, dtype=self.dtype,
            fused_vae=(c.fused_vae_encoder, c.fused_vae_decoder),
            weights=weights)
        self.init_seconds = time.perf_counter() - tic
        self.unet = models["unet"]
        self.vae_encoder = models["vae_encoder"]
        self.vae_decoder = models["vae_decoder"]
        self.patch_encoder = models["patch_encoder"]
        self._stamp_fns = {}
        self.request_counter = 0
        # neutral brush, so a stamp before set_brush is served
        self.set_brush(np.full((self._resolution, self._resolution, 3), 0.5,
                               np.float32))

    def state_dicts(self) -> dict:
        """Each component's state_dict, for another model's `weights`."""
        return {name: getattr(self, name).state_dict()
                for name in ("unet", "vae_encoder", "vae_decoder",
                             "patch_encoder")}

    # --- the serving model contract ---

    def resolution(self) -> int:
        return self._resolution

    @torch.inference_mode()
    def set_brush(self, image: np.ndarray) -> None:
        """Crop/resize the brush to the model resolution and encode it into
        (cond, uncond) cross-attention tokens."""
        image = ensure_float01(image)[..., :3]
        self.image = crop_resize_square(image, self._resolution).astype(
            np.float32)
        self._brush = torch.from_numpy(self.image[None]).to(self.device)
        self._cond, self._uncond = encode_brush_image(self.patch_encoder,
                                                      self._brush)

    def _settings(self, settings):
        c = self.config
        return (int(settings.get("steps", c.denoising_steps)),
                float(np.float32(settings.get("cfg_weight",
                                              c.guidance_scale))),
                float(np.float32(settings.get("tg_weight",
                                              c.texture_guidance_scale))),
                int(settings.get("tg_steps", c.texture_guidance_steps)),
                int(settings.get("context_pad", c.context_pad)))

    def _stamp_fn(self, steps: int):
        fn = self._stamp_fns.get(steps)
        if fn is None:
            fn = make_stamp_fn(self.unet, self.vae_encoder, self.vae_decoder,
                               steps, self.vae_encoder.cfg.scaling_factor)
            self._stamp_fns[steps] = fn
        return fn

    def draws(self, counter: int, res: int):
        """(enc_noise, init_latents) of request `counter` at canvas size
        `res`, from a generator seeded with (config.seed, counter)."""
        gen = torch.Generator(device=self.device).manual_seed(
            (int(self.config.seed) << 32) | (int(counter) & 0xFFFFFFFF))
        lat = res // 8
        shape = (lat, lat, self.vae_encoder.cfg.latent_channels)
        enc_noise = torch.randn((2,) + shape, generator=gen,
                                device=self.device)
        init_latents = torch.randn((1,) + shape, generator=gen,
                                   device=self.device)
        return enc_noise, init_latents

    def _run_stamp(self, canvas: np.ndarray, **settings):
        """One stamp; returns (raw_u8, composited_u8) as (H, W, 3) numpy."""
        if canvas.dtype == np.uint8:
            canvas_u8 = canvas
        else:
            canvas_u8 = (np.clip(canvas, 0.0, 1.0) * 255).astype(np.uint8)
        res = int(canvas_u8.shape[0])
        steps, cfg_w, tg_w, tg_steps, pad = self._settings(settings)
        brush = self._brush
        if brush.shape[1] != res:
            brush = torch.from_numpy(crop_resize_square(
                self.image, res).astype(np.float32)[None]).to(self.device)
        self.request_counter += 1
        enc_noise, init_latents = self.draws(self.request_counter, res)
        canvas_t = torch.from_numpy(np.array(canvas_u8))[None].to(self.device)
        raw, comp = self._stamp_fn(steps)(
            canvas_t, brush, self._cond, self._uncond, enc_noise,
            init_latents, cfg_w, tg_w, tg_steps, pad)
        return raw.cpu().numpy(), comp.cpu().numpy()

    def generate_raw(self, canvas: np.ndarray, **settings) -> np.ndarray:
        raw_u8, _ = self._run_stamp(canvas, **settings)
        return raw_u8.astype(np.float32) / 255.0

    def generate(self, canvas: np.ndarray, **settings) -> np.ndarray:
        """Composited on the device, like the JAX model (the same math as
        the host composite canvas * alpha + result * (1 - alpha))."""
        _, comp_u8 = self._run_stamp(canvas, **settings)
        return comp_u8.astype(np.float32) / 255.0

    def generate_u8(self, canvas_u8: np.ndarray, **settings) -> np.ndarray:
        """uint8 in, uint8 out: the websocket server's fast path."""
        _, comp_u8 = self._run_stamp(canvas_u8, **settings)
        return comp_u8

    def create_preview_brush_context(self, brush_image: np.ndarray):
        """The brush preview's canvas: the brush known in the top-left
        quadrant."""
        return preview_brush_context(brush_image, self._resolution)

    # --- stroke sessions: not ported yet ---

    def session_active(self) -> bool:
        return False

    def _no_sessions(self, *args, **kwargs):
        raise NotImplementedError(
            "stroke sessions are not ported to the PyTorch package yet")

    begin_session = stamp_at = erase_at = fetch_canvas = sync_session = \
        end_session = _no_sessions
