"""Euler-Ancestral scheduler.

Port of diffusiontexturepainting_tpu/schedulers/euler_ancestral.py: SD
scaled-linear betas (0.0001/0.02), linspace float timesteps, sigmas
interpolated onto them, per-step ancestral noise with precomputed (dt,
sigma_up) tables, and 1/sqrt(sigma^2 + 1) model-input scaling
(`latent_scale`). Stochastic: each step adds `noise * sigma_up`, the noise
an input of the stamp (pipeline/inpaint.py `step_noise`).
"""

from __future__ import annotations

import numpy as np

from .base import (
    Scheduler,
    alphas_cumprod_from_betas,
    linspace_sigmas,
    scaled_linear_betas,
    sigmas_from_alphas,
)


class EulerAncestralScheduler(Scheduler):
    stochastic = True

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001, beta_end: float = 0.02,
                 prediction_type: str = "epsilon"):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(prediction_type)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self._sigmas_full = sigmas_from_alphas(alphas_cumprod_from_betas(
            scaled_linear_betas(num_train_timesteps, beta_start, beta_end)))

    def set_timesteps(self, num_inference_steps: int):
        n = int(num_inference_steps)
        self.num_inference_steps = n
        timesteps, sigmas = linspace_sigmas(self._sigmas_full,
                                            self.num_train_timesteps, n)
        self.timesteps = timesteps.astype(np.float32)
        self.sigmas = sigmas.astype(np.float32)
        self.init_noise_sigma = float(sigmas.max())
        s_from, s_to = sigmas[:-1], sigmas[1:]
        sigma_up = np.sqrt(np.maximum(
            s_to**2 * (s_from**2 - s_to**2)
            / np.maximum(s_from**2, 1e-20), 0.0))
        sigma_down = np.sqrt(np.maximum(s_to**2 - sigma_up**2, 0.0))
        self.dts = (sigma_down - s_from).astype(np.float32)
        self.sigmas_up = sigma_up.astype(np.float32)
        return self

    def scan_rows(self):
        return {
            "timestep": self.timesteps,
            "sigma": self.sigmas[:-1].astype(np.float32),
            "dt": self.dts,
            "sigma_up": self.sigmas_up,
            "latent_scale": (1.0 / np.sqrt(self.sigmas[:-1] ** 2 + 1.0)
                             ).astype(np.float32),
        }

    def scale_model_input(self, sample, row):
        return sample * float(row["latent_scale"])

    def step(self, model_output, sample, row, state=None, noise=None):
        sigma = row["sigma"]
        if self.prediction_type == "epsilon":
            pred_x0 = sample - float(sigma) * model_output
        else:
            pred_x0 = (model_output * float(-sigma / np.sqrt(sigma**2 + 1.0))
                       + sample / float(sigma**2 + 1.0))
        derivative = (sample - pred_x0) / float(sigma)
        prev = sample + derivative * float(row["dt"])
        if noise is not None:
            prev = prev + noise * float(row["sigma_up"])
        return prev, (state if state is not None else {})
