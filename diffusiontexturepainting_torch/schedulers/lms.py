"""LMS (linear multistep) scheduler.

Port of diffusiontexturepainting_tpu/schedulers/lms.py: SD betas
0.00085/0.012, linspace float timesteps, interpolated sigmas, order-4
Adams-Bashforth coefficients integrated with scipy.integrate.quad when the
tables are built (scipy is imported there, as the JAX module does, so both
packages integrate the same functions with the same routine), and
1/sqrt(sigma^2 + 1) model-input scaling. The derivative history is a
(4, ...) newest-first stack carried as state; the first steps' lower
orders are zero-padded coefficient rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.constants import device_constant
from .base import (
    Scheduler,
    alphas_cumprod_from_betas,
    linspace_sigmas,
    scaled_linear_betas,
    sigmas_from_alphas,
)


class LMSDiscreteScheduler(Scheduler):
    order = 4

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 prediction_type: str = "epsilon"):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(prediction_type)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self._sigmas_full = sigmas_from_alphas(alphas_cumprod_from_betas(
            scaled_linear_betas(num_train_timesteps, beta_start, beta_end)))

    def set_timesteps(self, num_inference_steps: int):
        from scipy import integrate

        n = int(num_inference_steps)
        self.num_inference_steps = n
        timesteps, sigmas = linspace_sigmas(self._sigmas_full,
                                            self.num_train_timesteps, n)
        self.timesteps = timesteps.astype(np.float32)
        self.sigmas = sigmas.astype(np.float64)
        self.init_noise_sigma = float(sigmas.max())

        coeffs = np.zeros((n, self.order), dtype=np.float32)
        for i in range(n):
            cur_order = min(i + 1, self.order)
            for k in range(cur_order):
                def lms_derivative(tau, k=k, i=i, cur_order=cur_order):
                    prod = 1.0
                    for m in range(cur_order):
                        if m == k:
                            continue
                        prod *= ((tau - self.sigmas[i - m])
                                 / (self.sigmas[i - k] - self.sigmas[i - m]))
                    return prod

                coeffs[i, k] = integrate.quad(
                    lms_derivative, self.sigmas[i], self.sigmas[i + 1],
                    epsrel=1e-4)[0]
        self.lms_coeffs = coeffs
        return self

    def scan_rows(self):
        s = self.sigmas[:-1].astype(np.float32)
        return {
            "timestep": self.timesteps,
            "sigma": s,
            "coeffs": self.lms_coeffs,
            "latent_scale": (1.0 / np.sqrt(s.astype(np.float64) ** 2 + 1.0)
                             ).astype(np.float32),
        }

    def scale_model_input(self, sample, row):
        return sample * float(row["latent_scale"])

    def init_state(self, sample):
        return {"derivs": torch.zeros((self.order,) + tuple(sample.shape),
                                      dtype=torch.float32,
                                      device=sample.device)}

    def step(self, model_output, sample, row, state, noise=None):
        sigma = row["sigma"]
        if self.prediction_type == "epsilon":
            pred_x0 = sample - float(sigma) * model_output
        else:
            pred_x0 = (model_output * float(-sigma / np.sqrt(sigma**2 + 1.0))
                       + sample / float(sigma**2 + 1.0))
        derivative = (sample - pred_x0) / float(sigma)
        derivs = torch.cat([derivative[None], state["derivs"][:-1]], dim=0)
        coeffs = device_constant(row["coeffs"], derivs.device)
        prev = sample + torch.tensordot(coeffs, derivs, dims=1)
        return prev, {"derivs": derivs}
