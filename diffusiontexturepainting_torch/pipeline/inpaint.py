"""The inpainting stamp: u8 canvas in, u8 stamp out.

Port of diffusiontexturepainting_tpu/pipeline/inpaint.py make_stamp_fn and
make_preview_fn, for any scheduler of the registry (schedulers/__init__.py)
and at any operating point of the JAX package (DeepCache by interval or by
pattern, the f32 final step):

    canvas u8 -> normalize/split -> context dilation (prefix sums)
    -> one batch-2 VAE encode (both branches)
    -> denoise loop (CFG triple-batch UNet on the scheduler's scaled input
       + dual-guidance combine + scheduler step)
    -> VAE decode -> [0,1] -> alpha composite -> u8 (truncating)

The loop is Python, one model call after another, each of the kind the
host schedule `model_call_schedule` gives it: "exact" (the UNet's forward),
"full" (forward_full, which also caches the deep feature), "shallow"
(forward_shallow against the latest cache) or "final" (the fp32 UNet of the
f32 final step, which caches nothing). The JAX package groups the same
schedule into scan bodies. Called directly, the function runs eagerly; the
serving model captures it once per operating point as a CUDA graph and
replays that (core/engine.py). So `stamp.run`, the body the graph holds,
reads every request value from the device: the four settings are (B,)
tensors, the texture-guidance scale of each call is computed from them on
the device, the context pad dilates through the per-image tensor path.

The random draws are inputs: `enc_noise` (the VAE posterior sample of both
branches), `init_latents` and, for a stochastic scheduler (EulerA),
`step_noise`, one standard normal of the latents' shape per model call.
DDIM, DPM-Solver, LMS and PNDM draw nothing per step.

`stamp.batched` runs B stamps as one (the counterpart of the JAX package's
jax.vmap of its stamp, parallel/serving.py): each request its own canvas,
brush, cond/uncond, draws and settings (cfg_weight, tg_weight, tg_steps,
context_pad, one value a request); the VAE encode at batch 2B, the UNet at
3B, branch-major [uncond x B, cond x B, cond x B], the decode at B. At
B = 1 it runs the ops of the single stamp, which is batched()[0]. Host
settings reach the device by fill_ (setting_tensor), never by a copy from
host memory, so a stroke session's stamp is enqueued without waiting.
"""

from __future__ import annotations

import contextlib

import torch

from ..models.vae import sample_latents
from ..ops.conv3x3 import require_kernels
from ..ops.morphology import add_extra_context
from ..ops.resize import nearest_downsample
from ..schedulers import make_scheduler


MODEL_CALL_KINDS = ("exact", "full", "shallow", "final")


def model_call_schedule(deep_cache_interval, n_iters: int,
                        final_step_f32: bool = False) -> tuple:
    """The kind of each of a stamp's n_iters model calls (MODEL_CALL_KINDS).
    An int interval p: call s is full where s % p == 0, else shallow (p 1:
    every call exact). A pattern: 'F' full, 'S' shallow; it must match
    n_iters and start with 'F' (a shallow call reads the latest cache).
    final_step_f32: the last call is the fp32 eval, forced full where the
    interval would make it shallow; a pattern must end in 'F' for it.
    Raises ValueError as the JAX package's _cache_flags and make_stamp_fn
    do (pipeline/inpaint.py:79-147)."""
    if isinstance(deep_cache_interval, int):
        if deep_cache_interval < 1:
            raise ValueError(f"DeepCache interval {deep_cache_interval}: "
                             "must be >= 1")
        p = deep_cache_interval
        kinds = ["exact" if p == 1 else "shallow" if s % p else "full"
                 for s in range(n_iters)]
    else:
        pattern = str(deep_cache_interval).upper()
        if set(pattern) - {"F", "S"}:
            raise ValueError(f"deep-cache pattern {pattern!r}: only 'F'/'S'")
        if len(pattern) != n_iters:
            raise ValueError(f"deep-cache pattern {pattern!r} length "
                             f"{len(pattern)} != scheduler iterations "
                             f"{n_iters}")
        if pattern[0] != "F":
            raise ValueError(f"deep-cache pattern {pattern!r} must start "
                             "with 'F' (a shallow step consumes the latest "
                             "cache)")
        if final_step_f32 and pattern[-1] == "S":
            raise ValueError("final_step_f32 requires the final step to be "
                             "a full ('F') eval, not a shallow one")
        kinds = ["full" if c == "F" else "shallow" for c in pattern]
    if final_step_f32:
        kinds[-1] = "final"
    return tuple(kinds)


@contextlib.contextmanager
def ieee_fp32():
    """fp32 convolutions and matmuls of the library in IEEE fp32 inside: no
    TF32 in cuDNN (whose default allows it) nor in cuBLAS (PyTorch's
    default already refuses it there); both settings are put back after.
    bf16 work is untouched."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, torch.get_float32_matmul_precision()
    cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def make_stamp_fn(unet, vae_encoder, vae_decoder, num_steps: int,
                  vae_scaling: float = 0.18215,
                  scheduler_name: str = "DDIM", deep_cache_interval=1,
                  final_step_f32: bool = False, unet_full=None,
                  unet_shallow=None, unet_final=None):
    """Returns stamp(canvas_u8 (1,H,W,4) uint8, brush (1,H,W,3) in [0,1],
    cond (1,L,D), uncond (1,L,D), enc_noise (2,H/8,W/8,4),
    init_latents (1,H/8,W/8,4), cfg_weight, tg_weight, tg_steps,
    context_pad, step_noise=None (n_iters,1,H/8,W/8,4), or None where the
    scheduler is not stochastic) -> (raw_u8 (H,W,3), composited_u8
    (H,W,3)). n_iters = stamp.scheduler.num_iterations() (PNDM: steps +
    1); texture guidance is active while the call index is below
    tg_steps.

    deep_cache_interval and final_step_f32 give stamp.schedule
    (model_call_schedule). unet_full(sample, t, ctx) -> (eps, cache) and
    unet_shallow(sample, t, ctx, cache) -> eps default to the UNet's
    forward_full and forward_shallow; unet_final(sample, t, ctx) -> eps,
    the fp32 eval, is needed where final_step_f32. The whole stamp runs
    under ieee_fp32(). stamp.batched(...) takes B requests at once (its
    docstring); stamp(...) is its B = 1 case, batched(...)[0];
    stamp.run(...) is batched with the settings as (B,) device tensors."""
    scheduler = make_scheduler(scheduler_name).set_timesteps(num_steps)
    rows = scheduler.rows()
    schedule = model_call_schedule(deep_cache_interval,
                                   scheduler.num_iterations(), final_step_f32)
    if "full" in schedule:
        unet_full = unet_full or unet.forward_full
        unet_shallow = unet_shallow or unet.forward_shallow
    if final_step_f32 and unet_final is None:
        raise ValueError("final_step_f32 requires unet_final")

    def model_call(kind, unet_in, t, embeddings, cache):
        """(eps, the cache after this call)."""
        if kind == "exact":
            return unet(unet_in, t, embeddings), cache
        if kind == "full":
            return unet_full(unet_in, t, embeddings)
        if kind == "shallow":
            return unet_shallow(unet_in, t, embeddings, cache), cache
        return unet_final(unet_in, t, embeddings), cache

    @torch.inference_mode()
    def run(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
            cfg_weight, tg_weight, tg_steps, context_pad, step_noise=None):
        """batched() with every setting a (B,) tensor on the canvas's
        device (cfg_weight and tg_weight float32, tg_steps and context_pad
        int64): nothing of a request is read on the host, so a captured
        CUDA graph of it serves any request (core/engine.py)."""
        require_kernels("stamp")
        if scheduler.stochastic and step_noise is None:
            raise ValueError(f"{scheduler_name} is stochastic: the stamp "
                             "needs its step_noise")
        with ieee_fp32():
            return body(canvas_u8, brush, cond, uncond, enc_noise,
                        init_latents, cfg_weight, tg_weight, tg_steps,
                        context_pad, step_noise)

    def batched(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
                cfg_weight, tg_weight, tg_steps, context_pad,
                step_noise=None):
        """B stamps: canvas_u8 (B,H,W,4), brush (B,H,W,3), cond and uncond
        (B,L,D), enc_noise (2B,H/8,W/8,4) branch-major (every request's
        masked-image draw, then every request's context draw),
        init_latents (B,H/8,W/8,4), step_noise (n_iters,B,H/8,W/8,4) or
        None; each setting a host number (every request's) or a sequence
        of B. Returns (raw_u8, composited_u8), each (B,H,W,3)."""
        require_kernels("stamp")
        B, dev = canvas_u8.shape[0], canvas_u8.device
        settings = [setting_tensor(v, B, dt, dev) for v, dt in
                    zip((cfg_weight, tg_weight, tg_steps, context_pad),
                        SETTING_DTYPES)]
        return run(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
                   *settings, step_noise)

    def stamp(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
              cfg_weight, tg_weight, tg_steps, context_pad, step_noise=None):
        raw, comp = batched(canvas_u8, brush, cond, uncond, enc_noise,
                            init_latents, cfg_weight, tg_weight, tg_steps,
                            context_pad, step_noise)
        return raw[0], comp[0]

    def body(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
             cfg_weight, tg_weight, tg_steps, context_pad, step_noise):
        B = canvas_u8.shape[0]
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
        masked_latents = torch.cat([lat[:B], lat[:B], lat[B:]], dim=0)
        embeddings = torch.cat([uncond.float(), cond.float(), cond.float()],
                               dim=0)
        # call i's texture-guidance scale is tg_weight where i < tg_steps,
        # else 0 (JAX pipeline/inpaint.py:200), computed on the device
        cfg = cfg_weight.view(B, 1, 1, 1)
        tgw = tg_weight.view(B, 1, 1, 1)
        tgs = tg_steps.view(B, 1, 1, 1)

        latents = init_latents.float() * scheduler.init_noise_sigma
        state = scheduler.init_state(latents)
        cache = None
        for i, (row, kind) in enumerate(zip(rows, schedule)):
            lat_in = scheduler.scale_model_input(
                torch.cat([latents] * 3, dim=0), row)
            unet_in = torch.cat([lat_in, mask_lat, masked_latents], dim=-1)
            t = torch.full((3 * B,), float(row["timestep"]),
                           device=latents.device)
            out, cache = model_call(kind, unet_in, t, embeddings, cache)
            eps_u, eps_c, eps_tg = out.chunk(3)
            tg_scale = torch.where(tgs > i, tgw, 0.0)
            eps = (eps_u + cfg * (eps_c - eps_u)
                   + tg_scale * (eps_tg - eps_c))
            noise = (step_noise[i].float() if scheduler.stochastic
                     else None)
            latents, state = scheduler.step(eps, latents, row, state, noise)

        decoded = vae_decoder(latents / vae_scaling)
        result = torch.clamp(decoded / 2.0 + 0.5, 0.0, 1.0)
        composited = canvas[..., :3] * mask + result * (1.0 - mask)
        return _to_u8(result), _to_u8(composited)

    stamp.batched = batched
    stamp.run = run
    stamp.scheduler = scheduler
    stamp.schedule = schedule
    return stamp


# the dtypes of run()'s settings: cfg_weight, tg_weight, tg_steps, context_pad
SETTING_DTYPES = (torch.float32, torch.float32, torch.int64, torch.int64)


def per_request(value, B: int) -> list:
    """A stamp setting as B host values: a number is every request's, a
    sequence (a list, a numpy array, a CPU tensor) must hold B."""
    if isinstance(value, torch.Tensor):
        value = value.tolist()
    if hasattr(value, "__len__"):
        values = list(value)
        if len(values) != B:
            raise ValueError(f"a setting of {len(values)} values for a "
                             f"batch of {B}")
        return values
    return [value] * B


def fill_values(out, values) -> None:
    """out (B,) := values, B host numbers, one fill_ a value: each value
    travels as a kernel argument, so no copy from host memory waits for
    the stream."""
    for i, v in enumerate(values):
        out[i].fill_(v)


def setting_tensor(value, B: int, dtype, device):
    """A stamp setting (per_request's host values) as run() takes it, a
    (B,) `dtype` tensor on `device`."""
    out = torch.empty(B, dtype=dtype, device=device)
    fill_values(out, per_request(value, B))
    return out


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
                    vae_scaling: float = 0.18215,
                    scheduler_name: str = "DDIM"):
    """Brush preview: the stamp on preview_canvas_u8(brush)."""
    stamp = make_stamp_fn(unet, vae_encoder, vae_decoder, num_steps,
                          vae_scaling, scheduler_name)

    def preview(brush, cond, uncond, enc_noise, init_latents, cfg_weight,
                tg_weight, tg_steps, context_pad, step_noise=None):
        return stamp(preview_canvas_u8(brush), brush, cond, uncond,
                     enc_noise, init_latents, cfg_weight, tg_weight,
                     tg_steps, context_pad, step_noise)

    return preview
