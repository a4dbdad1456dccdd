"""TorchConditionalInpainter: the serving model of the port.

Port of diffusiontexturepainting_tpu/pipeline/tpu_model.py: `resolution`,
`set_brush`, `generate_raw`, `generate`, `generate_u8` and
`create_preview_brush_context`, with the same wire-settings parsing, so it
answers the port's request handler (serving/wire.py) and its server
(serving/server.py). A stamp runs at its canvas's size (256, 512 or 1024
px), with the configuration's scheduler (any name of
schedulers.available_schedulers(); DDIM by default).

Weights: seeded random ones, a state_dict per component (`weights`), or a
checkpoint in the JAX package's format (`checkpoint_dir`,
weights/loader.py); `reload_params` swaps in another checkpoint while
serving. `warmup` builds the kernels and captures one stamp program per
operating point, so a server's first painter does not pay them.

Every stamp, session stamp, batch and brush encode is served by the
model's engine (core/engine.py): on CUDA one CUDA graph per (scheduler,
resolution, steps, DeepCache spec, f32 final step, batch size), captured
at its first call and replayed; the brush encode one a resolution. On the
CPU the engine runs the same functions eagerly. The eager stamp functions
stay reachable as `_stamp_fn(steps).eager`.

Stroke sessions (`begin_session`, `stamp_at`, `erase_at`, `fetch_canvas`,
`sync_session`, `end_session`; pipeline/session.py) keep the canvas on the
device as a (H, W, 4) uint8 tensor, stamps of the model's resolution. Each
STAMP_AT crops on the device, replays its program and writes back, all
enqueued; without pixels it returns before the stamp has run, and only
fetch_canvas, sync_session and the pixel-returning requests wait for the
device.

The configuration's fused_* switches choose the UNet's and the VAE's
serving legs: by default, as in the JAX package, the fused kernels (K1,
K3, K5, K6) with plain-layout attention; fused_unet_attn adds the
head-slotted self-attention (K13, slotted_config()); with all of them
False, the module legs ("safe twin"). All take the same state_dict.

Operating points, as the JAX model's: DeepCache (deep_cache_interval, an
interval gated by deep_cache_min_steps or an 'F'/'S' pattern that applies
at its own scheduler iteration count; `set_deep_cache` switches it),
f32_final_step (the last model call on `final_unet`, the module legs in
fp32 over the serving UNet's weights upcast, a second module kept beside
the bf16 one and refreshed by reload_params), and `dtype_overrides`
(components computed, and their weights kept, in another dtype: the
--f32-components flag). A stamp function is cached per scheduler, step
count, DeepCache spec and f32 final step, every static knob of a stamp;
its programs per resolution and batch size in the engine.

Random draws: request n (the model's request counter) draws its VAE
posterior noise, its initial latents and, for a stochastic scheduler, its
per-step noise, in that order, from a torch.Generator seeded with
(config.seed, n), so a request is reproducible from its counter.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..core.engine import Engine, Stamp
from ..core.config import (
    COMPONENTS,
    PatchEncoderConfig,
    PipelineConfig,
    UNetConfig,
    VAEConfig,
    parse_deep_cache_spec,
    tiny_patch_encoder_config,
    tiny_unet_config,
    tiny_vae_config,
)
from ..models.patch_encoder import encode_brush_image
from ..models.unet import UNet2DCondition
from ..ops.conv3x3 import require_kernels
from ..schedulers import make_scheduler
from ..serving.model_base import (
    ConditionalInpainterBase,
    crop_resize_square,
    ensure_float01,
    validate_session_canvas,
)
from ..utils.profiling import StageTimer
from ..weights.loader import load_pipeline_params
from ..weights.random_init import build_pipeline, load_weights
from .inpaint import ieee_fp32, make_stamp_fn
from .session import (
    erase_keep,
    overpaint_margin,
    session_erase,
    session_stamp,
)

logger = logging.getLogger(__name__)


class TorchConditionalInpainter(ConditionalInpainterBase):
    def __init__(self, resolution: int = 256,
                 config: PipelineConfig | None = None,
                 device: str | torch.device = "cuda", tiny: bool = False,
                 weights: dict | None = None,
                 checkpoint_dir: str | None = None, weights_seed: int = 0,
                 dtype_overrides: dict | None = None,
                 verbose_timing: bool = True, cfg_mesh=None):
        """Weights from `checkpoint_dir` (the JAX package's npz format;
        components it lacks get seeded random ones), or `weights` (a
        state_dict per component, as state_dicts() returns), else seeded
        random weights (`weights_seed`), built on `device` and cast once
        to bf16 on CUDA (fp32 on the CPU, as the JAX package serves bf16 on
        a TPU only). `dtype_overrides` ({"unet": torch.float32}) computes
        the components it names in their own dtype, their weights kept in
        it (the source values for fp32). `tiny` uses the JAX package's
        tiny_*_config() models. `verbose_timing`: the per-stage table in
        `timer` (utils/profiling.py StageTimer: brush-encode, stamp xN,
        session stamp xN; wall and, on CUDA, device ms), as the JAX model
        keeps it. `cfg_mesh` (parallel/mesh.py CfgMesh, --mesh model=3):
        the UNet's guidance branches a device each (parallel/cfg_shard.py),
        everything else on the mesh's first device, which is the model's
        device. Nothing is warmed here: see warmup()."""
        if weights is not None and checkpoint_dir:
            raise ValueError("give weights or checkpoint_dir, not both")
        self._resolution = int(resolution)
        self.config = self._validate_deep_cache(config or PipelineConfig())
        self.cfg_mesh = cfg_mesh
        if cfg_mesh is not None:
            device = cfg_mesh.devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        self.dtype_overrides = dict(dtype_overrides or {})
        self.weights_seed = int(weights_seed)
        self.tiny = bool(tiny)
        self.build_seconds = None  # the kernels' build, timed by warmup()
        if tiny:
            cfgs = (tiny_unet_config(), tiny_vae_config(),
                    tiny_patch_encoder_config())
        else:
            cfgs = (UNetConfig(), VAEConfig(), PatchEncoderConfig())
        c = self.config
        ucfg = dataclasses.replace(cfgs[0], fused_resnet=c.fused_unet_resnet,
                                   fused_ff=c.fused_unet_ff,
                                   fused_norm=c.fused_unet_norm,
                                   fused_attn=c.fused_unet_attn)
        tic = time.perf_counter()
        models = build_pipeline(
            ucfg, *cfgs[1:], device=self.device, dtype=self.dtype,
            fused_vae=(c.fused_vae_encoder, c.fused_vae_decoder),
            dtype_overrides=self.dtype_overrides)
        if checkpoint_dir:
            weights = load_pipeline_params(checkpoint_dir, models)
        load_weights(models, weights, self.weights_seed)
        self.unet = models["unet"]
        self.vae_encoder = models["vae_encoder"]
        self.vae_decoder = models["vae_decoder"]
        self.patch_encoder = models["patch_encoder"]
        # the f32 final step's UNet: the module legs in fp32 (the JAX
        # package's safe configuration) over the serving weights, upcast
        self._ucfg = ucfg
        self.final_unet = self._final_unet_on(self.device)
        self._refresh_final_unet()
        self.engine = Engine(self.device)
        self.cfg_unets = None
        if cfg_mesh is not None:
            from ..parallel.cfg_shard import CfgShardedUNets

            self.cfg_unets = CfgShardedUNets(
                cfg_mesh, self.unet, self.final_unet, self.engine,
                self._unets_on)
        self.init_seconds = time.perf_counter() - tic
        self.timer = StageTimer(enabled=verbose_timing, device=self.device)
        # {warm-up point: its program's capture record}: engine.captures
        self.warmup_captures = {}
        self._stamp_fns = {}
        self._schedulers = {}
        self.request_counter = 0
        self._session_canvas = None
        self._erase_keep = None
        # neutral brush, so a stamp before set_brush is served
        self.set_brush(np.full((self._resolution, self._resolution, 3), 0.5,
                               np.float32))

    def replica_on(self, device) -> "TorchConditionalInpainter":
        """A model of this one's configuration, dtypes and weights (copied)
        on `device`, with its own engine: a card of the data mesh
        (serving/parallel_model.py params_on)."""
        return TorchConditionalInpainter(
            self._resolution, config=self.config, device=device,
            tiny=self.tiny, weights=self.state_dicts(),
            weights_seed=self.weights_seed,
            dtype_overrides=self.dtype_overrides,
            verbose_timing=self.timer.enabled)

    def _final_unet_on(self, device):
        """The f32 final step's UNet on `device` (None without the f32
        final step): the module legs in fp32 (the JAX package's safe
        configuration), weights not yet set."""
        if not self.config.f32_final_step:
            return None
        safe = dataclasses.replace(self._ucfg, fused_resnet=False,
                                   fused_ff=False, fused_norm=False,
                                   fused_attn=False)
        with torch.device(device):
            unet = UNet2DCondition(safe)
        return unet.to(torch.float32).eval().requires_grad_(False)

    def _unets_on(self, device):
        """(UNet, f32 final step's UNet or None) on another device of the
        CFG mesh, built as this model's, weights not yet set."""
        with torch.device(device):
            unet = UNet2DCondition(self._ucfg)
        dtype = self.dtype_overrides.get("unet", self.dtype)
        unet.to(dtype).eval().requires_grad_(False)
        return unet, self._final_unet_on(device)

    @torch.no_grad()
    def _refresh_final_unet(self) -> None:
        """final_unet's weights := the serving UNet's, upcast to fp32 (its
        load hooks refold the upsample taps)."""
        if self.final_unet is not None:
            self.final_unet.load_state_dict(self.unet.state_dict())

    def reload_params(self, checkpoint_dir: str) -> None:
        """Swap in the weights of `checkpoint_dir` (components it lacks
        get the seeded random ones), refresh the f32 final step's UNet,
        then re-encode the current brush. Every component is read and
        validated before any weight is copied, so a checkpoint that fails
        leaves the old weights serving; load_state_dict's hooks rebuild the
        derived buffers (the slotted q/k/v, the upsamplers' folded taps, the
        decoder's padded head). Every weight is copied into its tensor, so
        the engine's captured programs are kept and read the new values, as
        the JAX engine keeps its compiled programs."""
        models = {name: getattr(self, name) for name in self._COMPONENTS}
        weights = load_pipeline_params(checkpoint_dir, models)
        if self._session_canvas is not None:
            self.sync_session()  # queued stamps read the old weights
        load_weights(models, weights, self.weights_seed)
        self._refresh_final_unet()
        if self.cfg_unets is not None:
            self.cfg_unets.refresh()
        self.set_brush(self.image)

    def warmup(self, points=None) -> dict:
        """Build the kernels (on CUDA), then run one stamp on a blank
        canvas per (resolution, steps[, DeepCache spec]) of `points`
        (default: the model's resolution at the configuration's steps; the
        spec, where given, instead of the configuration's for that step
        count), which captures its program on CUDA (Engine.warmup of the
        JAX package); returns {point: seconds, capture included} keyed
        (resolution, steps) or (resolution, steps, spec) as the point was
        given, each stamp synchronized. `warmup_captures[point]` holds the
        capture's seconds and the pool's bytes after it, where this warm-up
        captured the point's program. The request
        counter is put back, so the first request after a warm-up draws
        what it would have drawn without one."""
        if self.device.type == "cuda":
            from .. import _cuda

            self.build_seconds = _cuda.build_all()
        points = points or [(self._resolution, self.config.denoising_steps)]
        counter = self.request_counter
        out = {}
        try:
            for point in points:
                res, steps = int(point[0]), int(point[1])
                key = (res, steps)
                interval = None
                if len(point) > 2:
                    interval = parse_deep_cache_spec(point[2])
                    key += (interval,)
                prog = self._stamp_fn(steps, interval).program_key(res, 1)
                captured = prog in self.engine.captures
                tic = time.perf_counter()
                self._run_stamp(np.zeros((res, res, 4), np.uint8),
                                interval=interval, steps=steps)
                out[key] = time.perf_counter() - tic
                if not captured and prog in self.engine.captures:
                    self.warmup_captures[key] = self.engine.captures[prog]
        finally:
            self.request_counter = counter
        return out

    # --- operating points (the JAX model's tpu_model.py:413-460) ---

    @staticmethod
    def _validate_deep_cache(config: PipelineConfig) -> PipelineConfig:
        """`config` with its DeepCache spec parsed (ValueError for an
        interval below 1 or a malformed pattern), refused where every
        request it applies to would fail: f32_final_step needs the
        pattern's last call full. Checked at construction and at
        set_deep_cache."""
        spec = parse_deep_cache_spec(config.deep_cache_interval)
        if (config.f32_final_step and isinstance(spec, str)
                and spec.endswith("S")):
            raise ValueError(
                f"--f32-final-step requires an 'F'-terminated DeepCache "
                f"pattern (the final eval must be full to promote it); "
                f"got {config.deep_cache_interval!r}")
        if spec == config.deep_cache_interval:
            return config
        return dataclasses.replace(config, deep_cache_interval=spec)

    def set_deep_cache(self, interval, min_steps: int | None = None) -> None:
        """Switch the DeepCache operating point; the stamp functions and
        their captured programs are kept per spec, so switching back
        rebuilds nothing."""
        kw = dict(deep_cache_interval=interval)
        if min_steps is not None:
            kw["deep_cache_min_steps"] = int(min_steps)
        self.config = self._validate_deep_cache(
            dataclasses.replace(self.config, **kw))

    def _scheduler(self, steps: int):
        """The configuration's scheduler set to `steps` (cached)."""
        key = (self.config.scheduler, int(steps))
        sched = self._schedulers.get(key)
        if sched is None:
            sched = make_scheduler(key[0]).set_timesteps(key[1])
            self._schedulers[key] = sched
        return sched

    def _cache_interval(self, steps: int):
        """The DeepCache spec of a request of `steps` steps: 1 (exact), an
        interval (where steps >= deep_cache_min_steps) or a pattern (where
        the scheduler's model calls number its length: a pattern is an
        explicit opt-in at that point and bypasses the gate)."""
        dci = self.config.deep_cache_interval
        if isinstance(dci, str):
            n_iters = self._scheduler(steps).num_iterations()
            return dci if len(dci) == n_iters else 1
        if steps < self.config.deep_cache_min_steps:
            return 1
        return dci

    _COMPONENTS = COMPONENTS

    def state_dicts(self) -> dict:
        """Each component's state_dict, for another model's `weights` or
        weights/loader.py save_pipeline_params."""
        return {name: getattr(self, name).state_dict()
                for name in self._COMPONENTS}

    # --- the serving model contract ---

    def resolution(self) -> int:
        return self._resolution

    def set_brush(self, image: np.ndarray) -> None:
        """Crop/resize the brush to the model resolution and encode it into
        (cond, uncond) cross-attention tokens."""
        require_kernels("set_brush")
        self.image, self._brush, self._cond, self._uncond = \
            self.encode_brush(image)

    @torch.inference_mode()
    def encode_brush(self, image: np.ndarray):
        """(image, brush, cond, uncond) of a brush image, the model's own
        brush untouched: the (res, res, 3) float32 crop (made on the host),
        it as a (1, res, res, 3) tensor on the device, and its
        cross-attention tokens, from the engine's brush program of the
        resolution (the JAX model's jit of encode_brush_image)."""
        require_kernels("set_brush")
        image = crop_resize_square(ensure_float01(image)[..., :3],
                                   self._resolution).astype(np.float32)
        brush = torch.from_numpy(image[None]).to(self.device)
        with self.timer.stage("brush-encode"):
            cond, uncond = self.engine.program(
                ("brush", self._resolution), self._encode_brush)(brush)
        return image, brush, cond, uncond

    def _encode_brush(self, brush):
        with ieee_fp32():
            return encode_brush_image(self.patch_encoder, brush)

    def _settings(self, settings):
        c = self.config
        return (int(settings.get("steps", c.denoising_steps)),
                float(np.float32(settings.get("cfg_weight",
                                              c.guidance_scale))),
                float(np.float32(settings.get("tg_weight",
                                              c.texture_guidance_scale))),
                int(settings.get("tg_steps", c.texture_guidance_steps)),
                int(settings.get("context_pad", c.context_pad)))

    def _stamp_fn(self, steps: int, interval=None):
        """The served stamp function of (the configuration's scheduler,
        steps, the DeepCache spec: `interval`, else the configuration's at
        `steps`, and the f32 final step), built once per key: the engine's
        core.engine.Stamp around make_stamp_fn's function (`.eager`)."""
        steps = int(steps)
        if interval is None:
            interval = self._cache_interval(steps)
        c = self.config
        key = (c.scheduler, steps, interval, c.f32_final_step)
        fn = self._stamp_fns.get(key)
        if fn is None:
            scaling = self.vae_encoder.cfg.scaling_factor
            sharded = self.cfg_unets
            if sharded is None:
                fn = make_stamp_fn(self.unet, self.vae_encoder,
                                   self.vae_decoder, steps, scaling,
                                   c.scheduler, deep_cache_interval=interval,
                                   final_step_f32=c.f32_final_step,
                                   unet_final=self.final_unet)
            else:
                fn = make_stamp_fn(
                    sharded.unet,
                    sharded.lead_program("vae_encoder", self.vae_encoder),
                    sharded.lead_program("vae_decoder", self.vae_decoder),
                    steps, scaling, c.scheduler,
                    deep_cache_interval=interval,
                    final_step_f32=c.f32_final_step,
                    unet_full=sharded.unet_full,
                    unet_shallow=sharded.unet_shallow,
                    unet_final=(sharded.unet_final if c.f32_final_step
                                else None))
            fn = self._stamp_fns[key] = Stamp(self.engine, fn, key,
                                              graphed=sharded is None)
        return fn

    def draws(self, counter: int, res: int, steps: int | None = None):
        """(enc_noise, init_latents, step_noise) of request `counter` at
        canvas size `res`, from a generator seeded with (config.seed,
        counter); step_noise, drawn after the others, is (n_iters, 1,
        res/8, res/8, 4) where the scheduler is stochastic at `steps`
        (default: the configuration's), else None."""
        gen = torch.Generator(device=self.device).manual_seed(
            (int(self.config.seed) << 32) | (int(counter) & 0xFFFFFFFF))
        lat = res // 8
        shape = (lat, lat, self.vae_encoder.cfg.latent_channels)
        enc_noise = torch.randn((2,) + shape, generator=gen,
                                device=self.device)
        init_latents = torch.randn((1,) + shape, generator=gen,
                                   device=self.device)
        sched = self._scheduler(self.config.denoising_steps if steps is None
                                else steps)
        step_noise = None
        if sched.stochastic:
            step_noise = torch.randn((sched.num_iterations(), 1) + shape,
                                     generator=gen, device=self.device)
        return enc_noise, init_latents, step_noise

    def _next_counter(self) -> int:
        self.request_counter += 1
        return self.request_counter

    def _run_stamp(self, canvas: np.ndarray, interval=None, **settings):
        """One stamp (at the DeepCache spec `interval` where given, else
        the configuration's); returns (raw_u8, composited_u8) as (H, W, 3)
        numpy."""
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
        enc_noise, init_latents, step_noise = self.draws(
            self._next_counter(), res, steps)
        canvas_t = torch.from_numpy(np.array(canvas_u8))[None].to(self.device)
        raw, comp = self._stamp_fn(steps, interval)(
            canvas_t, brush, self._cond, self._uncond, enc_noise,
            init_latents, cfg_w, tg_w, tg_steps, pad, step_noise)
        return raw.cpu().numpy(), comp.cpu().numpy()

    def _steps(self, settings) -> int:
        return int(settings.get("steps", self.config.denoising_steps))

    def generate_raw(self, canvas: np.ndarray, **settings) -> np.ndarray:
        with self.timer.stage(f"stamp raw x{self._steps(settings)}"):
            raw_u8, _ = self._run_stamp(canvas, **settings)
        return raw_u8.astype(np.float32) / 255.0

    def generate(self, canvas: np.ndarray, **settings) -> np.ndarray:
        """Composited on the device, like the JAX model (the same math as
        the host composite canvas * alpha + result * (1 - alpha))."""
        with self.timer.stage(f"stamp x{self._steps(settings)}"):
            _, comp_u8 = self._run_stamp(canvas, **settings)
        return comp_u8.astype(np.float32) / 255.0

    def generate_u8(self, canvas_u8: np.ndarray, **settings) -> np.ndarray:
        """uint8 in, uint8 out: the websocket server's fast path."""
        with self.timer.stage(f"stamp u8 x{self._steps(settings)}"):
            _, comp_u8 = self._run_stamp(canvas_u8, **settings)
        return comp_u8

    # --- stroke sessions: the canvas on the device ---
    # Every method that writes the canvas runs under inference_mode: the
    # canvas is an inference tensor, which refuses in-place writes outside.

    @torch.inference_mode()
    def begin_session(self, canvas_u8: np.ndarray) -> None:
        canvas_u8 = validate_session_canvas(canvas_u8, self._resolution)
        self._session_canvas = torch.from_numpy(np.array(canvas_u8)).to(
            self.device)

    def session_active(self) -> bool:
        return self._session_canvas is not None

    @torch.inference_mode()
    def stamp_at(self, x0: int, y0: int, return_pixels: bool = True,
                 overpaint: bool = False, **settings):
        """One stamp into the resident canvas with its window's top-left
        corner at (x0, y0), clamped to fit; it takes the next request
        counter, so its draws are those of the per-request path at that
        counter. Returns the composited crop (res, res, 3) uint8 when
        return_pixels, else None without waiting for the device."""
        return self.stamp_into(self._require_session(), self._brush,
                               self._cond, self._uncond,
                               self._next_counter(), x0, y0, return_pixels,
                               overpaint, settings)

    @torch.inference_mode()
    def stamp_into(self, canvas, brush, cond, uncond, counter: int, x0: int,
                   y0: int, return_pixels: bool, overpaint: bool,
                   settings: dict):
        """stamp_at's work on any resident canvas, brush and request
        counter (a connection of the batching service keeps its own)."""
        steps, cfg_w, tg_w, tg_steps, pad = self._settings(settings)
        res = self._resolution
        margin = overpaint_margin(res) if overpaint else 0
        enc_noise, init_latents, step_noise = self.draws(counter, res, steps)
        with self.timer.stage(f"session stamp x{steps}"):
            comp = session_stamp(self._stamp_fn(steps), canvas, brush, cond,
                                 uncond, enc_noise, init_latents, x0, y0,
                                 cfg_w, tg_w, tg_steps, pad, margin,
                                 step_noise)
            return comp.cpu().numpy() if return_pixels else None

    @torch.inference_mode()
    def erase_at(self, x0: int, y0: int, return_pixels: bool = True):
        """Zero RGBA under the erase circle of the window at (x0, y0);
        returns the window's RGB after it when return_pixels."""
        canvas = self._require_session()
        if self._erase_keep is None:
            self._erase_keep = erase_keep(self._resolution, self.device)
        crop = session_erase(canvas, self._erase_keep, x0, y0)
        return crop.cpu().numpy() if return_pixels else None

    def fetch_canvas(self) -> np.ndarray:
        """Waits for every queued stamp and downloads the canvas (a copy,
        also on the CPU)."""
        return np.array(self._require_session().cpu())

    def sync_session(self) -> None:
        """Waits for every queued stamp, downloading nothing."""
        canvas = self._require_session()
        if canvas.device.type == "cuda":
            torch.cuda.current_stream(canvas.device).synchronize()

    def end_session(self) -> None:
        self._session_canvas = None

    def _require_session(self):
        if self._session_canvas is None:
            raise RuntimeError("no active stroke session (BEGIN_SESSION "
                               "first)")
        return self._session_canvas
