"""LoRA + patch-encoder finetuning: the loss, the optimizer, the train step.

Port of diffusiontexturepainting_tpu/training/trainer.py, one process, one
device. The training semantics are the JAX package's
(train_texture_inpaint_lora.py:640-715 of the reference):
  - frozen: the SD UNet base, the VAE encoder, CLIP; trainable: LoRA
    factors (rank 4 on every attention projection) and the patch-encoder
    head (everything of it but CLIP)
  - DDPM scaled-linear 1000-step noising; epsilon or v-prediction target
  - optional noise offset; optional min-SNR-gamma loss weighting
  - per-sample conditioning dropout blending the learned uncond vector
  - AdamW + global-norm grad clip 1.0, optionally a linear warm-up and
    gradient accumulation

The optimizer is the arithmetic of the JAX package's optax chain, copied
(`Optimizer`): clip_by_global_norm passes the gradients through below the
limit and takes g / |g| * max above it; adamw decays every leaf, lr *
(m_hat / (sqrt(v_hat) + eps) + wd * p); linear_schedule gives lr 0 at the
first update; MultiSteps keeps the running mean acc + (g - acc) / (n + 1)
and hands that mean to the chain (clipped as a whole) on the micro-step
that emits, the only one on which the inner count and the schedule move.

Precision follows the JAX train.py build_models: parameters stay fp32; the
compute dtype is bf16 on CUDA and fp32 on the CPU. The frozen towers are
cast to the compute dtype once; each step merges the LoRA factors into the
fp32 attention projections (models/lora.py), casts the merged weights to
the compute dtype and runs the UNet on them through
torch.func.functional_call, and casts the fp32 head the same way (its
final LayerNorm, proj_out and uncond vector stay fp32, as in the JAX
module). The models are the module legs (UNetConfig's fused_* False,
VAEEncoder(fused=False)).

The step runs inside ops.conv3x3.conv_impl("plain"), the JAX trainer's
conv_impl("xla") scope: every conv and attention is its plain PyTorch
version, differentiated by autograd, and no kernel launches (the serving
kernels have no backward; the JAX package's custom VJPs are XLA
re-derivations, which its trainer routes around the same way).

Every random draw of a step is an input (`draws`): the two VAE posterior
samples' noise, the noise, the offset noise and the timesteps; by default
they come from a torch.Generator seeded with (seed, step), so a resumed
run draws what the unbroken one drew.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.lora import attention_projections, init_lora_params, merge_lora
from ..models.vae import sample_latents
from ..ops.conv3x3 import conv_impl
from ..ops.resize import nearest_downsample
from ..schedulers.base import alphas_cumprod_from_betas, scaled_linear_betas

# head entries the JAX module keeps in fp32 (dtype and param_dtype f32)
_FP32_HEAD = ("final_layer_norm.", "proj_out.", "uncond_vector")


@dataclass(frozen=True)
class TrainConfig:
    resolution: int = 256
    lora_rank: int = 4
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    snr_gamma: Optional[float] = None
    prediction_type: str = "epsilon"  # or "v_prediction"
    noise_offset: float = 0.0
    num_train_timesteps: int = 1000
    vae_scaling: float = 0.18215
    gradient_accumulation_steps: int = 1
    lr_warmup_steps: int = 0
    max_train_steps: int = 15000
    seed: int = 0


def split_patch_encoder_params(pe_state: dict):
    """(head, clip) of a patch-encoder state_dict: the reference freezes
    CLIP inside the encoder (training/image_encoder.py:40-41) and trains
    everything else."""
    head = {k: v for k, v in pe_state.items() if not k.startswith("clip.")}
    clip = {k: v for k, v in pe_state.items() if k.startswith("clip.")}
    return head, clip


# --- the optax chain's arithmetic ---


def _f32(v) -> float:
    """v rounded to fp32, as a Python float (exact in a tensor op)."""
    return float(np.float32(v))


class Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr or
    linear_schedule(0, lr, warm-up), b1, b2, eps, weight_decay)), inside
    optax.MultiSteps where gradient_accumulation_steps > 1, over a flat
    {name: fp32 tensor} of parameters. `state` holds what the optax states
    hold: the Adam count, mu and nu, the schedule's count, and under
    MultiSteps the mini-step, the gradient step and the accumulated mean."""

    def __init__(self, cfg: TrainConfig, params: dict):
        self.cfg = cfg
        self.k = cfg.gradient_accumulation_steps
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        self.state = {"count": 0, "lr_count": 0, "mu": zeros(),
                      "nu": zeros()}
        if self.k > 1:
            self.state.update(mini_step=0, gradient_step=0, acc=zeros())

    def learning_rate(self, count: int) -> float:
        """The schedule at `count` in fp32 (optax polynomial_schedule,
        power 1, from 0 to lr over lr_warmup_steps; the constant lr without
        a warm-up)."""
        cfg = self.cfg
        lr = np.float32(cfg.learning_rate)
        if cfg.lr_warmup_steps <= 0:
            return float(lr)
        c = np.float32(min(max(count, 0), cfg.lr_warmup_steps))
        frac = np.float32(1.0) - c / np.float32(cfg.lr_warmup_steps)
        return float(np.float32(-lr) * frac + lr)

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        """One update (one micro-step under MultiSteps) of `params` in
        place."""
        if self.k == 1:
            self._inner(params, grads)
            return
        st = self.state
        n = _f32(st["mini_step"] + 1)
        for name, g in grads.items():
            acc = st["acc"][name]
            acc.add_((g - acc) / n)
        if st["mini_step"] != self.k - 1:
            st["mini_step"] += 1
            return
        self._inner(params, st["acc"])
        for acc in st["acc"].values():
            acc.zero_()
        st["mini_step"] = 0
        st["gradient_step"] += 1

    def _inner(self, params: dict, grads: dict) -> None:
        cfg, st = self.cfg, self.state
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        g_norm = global_norm(grads)
        keep = g_norm < cfg.max_grad_norm
        count = st["count"] + 1
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
        step_size = -self.learning_rate(st["lr_count"])
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm)
            mu, nu = st["mu"][name], st["nu"][name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_epsilon)
            u = u + cfg.adam_weight_decay * p
            p.add_(step_size * u)
        st["count"] = count
        st["lr_count"] += 1

    def state_dict(self) -> dict:
        return {k: ({n: t.detach().cpu() for n, t in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in self.state.items()}

    def load_state_dict(self, state: dict) -> None:
        if set(state) != set(self.state):
            raise ValueError("optimizer state does not match the "
                             "configuration (gradient accumulation?)")
        for k, v in state.items():
            if isinstance(v, dict):
                for n, t in v.items():
                    self.state[k][n].copy_(t)
            else:
                self.state[k] = int(v)


def global_norm(tensors: dict) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squares, fp32."""
    total = sum(t.float().square().sum() for t in tensors.values())
    return torch.sqrt(total)


# --- the loss ---


DRAW_NAMES = ("latent_noise", "noise", "offset_noise", "timesteps",
              "masked_latent_noise")


def make_draws(batch_size: int, latent_hw, num_train_timesteps: int,
               generator: torch.Generator, device) -> dict:
    """A step's random draws, in the JAX loss's order (r_lat, r_noise,
    r_off, r_t, r_mask): standard normals of the latents' shape (B, h, w,
    4), the offset noise (B, 1, 1, 4) and integer timesteps (B,)."""
    h, w = latent_hw
    shape = (batch_size, h, w, 4)
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    return {
        "latent_noise": torch.randn(shape, **kw),
        "noise": torch.randn(shape, **kw),
        "offset_noise": torch.randn((batch_size, 1, 1, 4), **kw),
        "timesteps": torch.randint(0, num_train_timesteps, (batch_size,),
                                   generator=generator, device=device),
        "masked_latent_noise": torch.randn(shape, **kw),
    }


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The default draws' generator of micro-step `step`."""
    return torch.Generator(device=device).manual_seed(
        (seed << 32) + step)


class Trainer:
    """The trainable state and the step over frozen towers.

    models: {"unet", "vae_encoder", "patch_encoder"} modules on `device`
    in the compute dtype, their frozen weights loaded, in eval mode;
    weights: {"unet", "patch_encoder"} fp32 state_dicts (any device), the
    source of the fp32 attention projections and of the head's fp32
    masters; lora: {name: {"down", "up"}} factors, else init_lora_params
    from a generator seeded with cfg.seed."""

    def __init__(self, cfg: TrainConfig, models: dict, weights: dict,
                 device, dtype=torch.float32, lora: dict | None = None):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.unet = models["unet"]
        self.vae_encoder = models["vae_encoder"]
        self.patch_encoder = models["patch_encoder"]
        for m in (self.unet, self.vae_encoder, self.patch_encoder):
            m.requires_grad_(False)
        names = list(attention_projections(self.unet))
        self.proj_base = {f"{n}.weight": weights["unet"][f"{n}.weight"]
                          .to(self.device, torch.float32) for n in names}
        if lora is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            lora = init_lora_params(self.unet, cfg.lora_rank, gen)
        head, _ = split_patch_encoder_params(weights["patch_encoder"])
        self.params = {}
        for n in names:
            for k in ("down", "up"):
                self.params[f"lora/{n}/{k}"] = lora[n][k]
        for k, v in head.items():
            self.params[f"patch_encoder/{k}"] = v
        self.params = {k: v.detach().to(self.device, torch.float32).clone()
                       .requires_grad_(True) for k, v in self.params.items()}
        self.optimizer = Optimizer(cfg, self.params)
        self.step = 0
        self.alphas_cumprod = torch.as_tensor(alphas_cumprod_from_betas(
            scaled_linear_betas(cfg.num_train_timesteps)),
            dtype=torch.float32, device=self.device)

    # --- views of the trainables ---

    def lora(self) -> dict:
        out = {}
        for key, t in self.params.items():
            if key.startswith("lora/"):
                _, name, part = key.split("/")
                out.setdefault(name, {})[part] = t
        return out

    def head(self) -> dict:
        return {k[len("patch_encoder/"):]: t for k, t in self.params.items()
                if k.startswith("patch_encoder/")}

    def unet_overrides(self, dtype=None) -> dict:
        """The merged projections, {name.weight: (W + up @ down) in fp32,
        cast to `dtype` (the compute dtype by default)}."""
        return merge_lora(self.proj_base, self.lora(),
                          dtype=dtype or self.dtype)

    def head_overrides(self) -> dict:
        """The head's fp32 masters cast to the compute dtype, but for the
        entries the JAX module keeps in fp32."""
        return {k: v if k.startswith(_FP32_HEAD) else v.to(self.dtype)
                for k, v in self.head().items()}

    def encode_patches(self, cond_patches):
        """(cond (B, total, D) fp32, uncond (1, total, D) fp32) with the
        current head; CLIP under no_grad."""
        with torch.no_grad():
            tokens = self.patch_encoder.clip_tokens(cond_patches)
        return functional_call(self.patch_encoder, self.head_overrides(),
                               (None,), {"clip_tokens": tokens})

    # --- the loss and the step ---

    def loss(self, batch: dict, draws: dict) -> torch.Tensor:
        """The JAX make_loss_fn (trainer.py:116-166) over the current
        trainables, term by term.

        batch: image (B, H, W, 3) in [-1, 1]; mask (B, H, W, 1), 1 =
        generate; masked_image (B, H, W, 3); cond_patches (B, P, S, S, 3)
        CLIP-normalized; drop_cond (B,) 0/1. draws: make_draws's."""
        cfg = self.cfg
        with torch.no_grad():
            moments = self.vae_encoder(batch["image"])
            m_moments = self.vae_encoder(batch["masked_image"])
        latents = sample_latents(moments, draws["latent_noise"]) \
            * cfg.vae_scaling
        noise = draws["noise"]
        if cfg.noise_offset:
            noise = noise + cfg.noise_offset * draws["offset_noise"]
        b = latents.shape[0]
        t = draws["timesteps"]
        a = self.alphas_cumprod[t][:, None, None, None]
        noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
        masked_latents = sample_latents(
            m_moments, draws["masked_latent_noise"]) * cfg.vae_scaling
        mask_lat = nearest_downsample(batch["mask"], 8)
        unet_in = torch.cat([noisy, mask_lat, masked_latents], dim=-1)

        cond, uncond = self.encode_patches(batch["cond_patches"])
        drop = batch["drop_cond"].reshape(b, 1, 1).float()
        ehs = (1.0 - drop) * cond + drop * uncond.expand_as(cond)

        pred = functional_call(self.unet, self.unet_overrides(),
                               (unet_in, t.float(), ehs))
        if cfg.prediction_type == "epsilon":
            target = noise
        elif cfg.prediction_type == "v_prediction":
            target = torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * latents
        else:
            raise ValueError(cfg.prediction_type)
        per_sample = (pred.float() - target).square().mean(dim=(1, 2, 3))
        if cfg.snr_gamma is not None:
            snr = a[:, 0, 0, 0] / (1.0 - a[:, 0, 0, 0])
            per_sample = per_sample * (torch.clamp(snr, max=cfg.snr_gamma)
                                       / snr)
        return per_sample.mean()

    def draws(self, batch: dict) -> dict:
        """The default draws of the current micro-step."""
        b, h, w = batch["image"].shape[:3]
        return make_draws(b, (h // 8, w // 8), self.cfg.num_train_timesteps,
                          step_generator(self.cfg.seed, self.step,
                                         self.device), self.device)

    def value_and_grad(self, batch: dict, draws: dict | None = None):
        """(loss, {name: gradient}) of the current micro-step, inside the
        plain scope (no kernel launches)."""
        draws = draws if draws is not None else self.draws(batch)
        names = list(self.params)
        with conv_impl("plain"):
            loss = self.loss(batch, draws)
            grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def train_step(self, batch: dict, draws: dict | None = None) -> dict:
        """One micro-step: the loss and its gradients, the optimizer's
        update. Returns {"loss", "grad_norm" (before the clip)} as device
        scalars."""
        loss, grads = self.value_and_grad(batch, draws)
        self.optimizer.step(self.params, grads)
        self.step += 1
        return {"loss": loss, "grad_norm": global_norm(grads)}

    # --- checkpoints and export ---

    def state_dict(self) -> dict:
        return {"step": self.step,
                "params": {k: v.detach().cpu() for k, v in
                           self.params.items()},
                "optimizer": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if set(state["params"]) != set(self.params):
            raise ValueError("checkpoint trainables do not match the model")
        for k, v in state["params"].items():
            self.params[k].copy_(v)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    @torch.no_grad()
    def export_state_dicts(self, weights: dict) -> dict:
        """fp32 CPU state_dicts of the trained pipeline: `weights`' unet
        with the LoRA merged in fp32, its patch encoder with the trained
        head; the other components as given."""
        out = dict(weights)
        merged = {k: v.cpu() for k, v in
                  self.unet_overrides(torch.float32).items()}
        out["unet"] = {**weights["unet"], **merged}
        head = {k: v.detach().cpu() for k, v in self.head().items()}
        out["patch_encoder"] = {**weights["patch_encoder"], **head}
        return out


def batch_to_device(batch: dict, device) -> dict:
    """A dataset batch (numpy) -> float32 tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        device, non_blocking=True) for k, v in batch.items()}
