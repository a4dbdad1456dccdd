"""DDIM scheduler (eta = 0) with precomputed per-step tables.

Port of diffusiontexturepainting_tpu/schedulers/base.py + ddim.py, whose
modules import jax: the tables are rebuilt here in float64 numpy
(scaled-linear betas, steps_offset=1, set_alpha_to_one=False, "leading"
spacing) and rounded to float32 at the end, as the JAX package does;
`step` is torch math on float32 coefficients.
"""

from __future__ import annotations

import numpy as np


def scaled_linear_betas(num_train_timesteps: int = 1000,
                        beta_start: float = 0.0001,
                        beta_end: float = 0.02) -> np.ndarray:
    """float64 betas = linspace(sqrt(beta_start), sqrt(beta_end), N)^2."""
    return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                       dtype=np.float64) ** 2


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas.astype(np.float64), axis=0)


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 1) -> np.ndarray:
    """Descending inference timesteps: round(i * N/n) + steps_offset."""
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    return timesteps.astype(np.int64) + steps_offset


class DDIMScheduler:
    """Deterministic (eta = 0) DDIM with epsilon prediction."""

    init_noise_sigma = 1.0

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.0001, beta_end: float = 0.02,
                 steps_offset: int = 1):
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        betas = scaled_linear_betas(num_train_timesteps, beta_start, beta_end)
        self._alphas_cumprod_full = alphas_cumprod_from_betas(betas)
        # set_alpha_to_one=False: the final alpha is alphas_cumprod[0]
        self.final_alpha_cumprod = self._alphas_cumprod_full[0]

    def set_timesteps(self, num_inference_steps: int) -> "DDIMScheduler":
        n = int(num_inference_steps)
        self.num_inference_steps = n
        self.timesteps = leading_timesteps(self.num_train_timesteps, n,
                                           self.steps_offset)
        ac = self._alphas_cumprod_full
        self.alpha_prod = ac[self.timesteps].astype(np.float32)
        # prev index = idx + 1 (timesteps descend); past the end -> final
        self.alpha_prod_prev = np.concatenate(
            [self.alpha_prod[1:], np.float32([self.final_alpha_cumprod])]
        ).astype(np.float32)
        step_ratio = self.num_train_timesteps // n
        prev_t = self.timesteps - step_ratio
        alpha_t = ac[self.timesteps]
        alpha_prev = np.where(prev_t >= 0, ac[np.clip(prev_t, 0, None)],
                              self.final_alpha_cumprod)
        self.variance = (((1.0 - alpha_prev) / (1.0 - alpha_t))
                         * (1.0 - alpha_t / alpha_prev)).astype(np.float32)
        # eta = 0 update coefficients, evaluated in float32 as the JAX
        # package's step does on its float32 rows
        one = np.float32(1.0)
        self._sqrt_beta = np.sqrt(one - self.alpha_prod)
        self._sqrt_alpha = np.sqrt(self.alpha_prod)
        self._sqrt_alpha_prev = np.sqrt(self.alpha_prod_prev)
        self._sqrt_dir = np.sqrt(one - self.alpha_prod_prev)
        return self

    def scan_rows(self) -> dict:
        """Per-step float32 tables, keyed as the JAX scheduler's rows."""
        return {
            "timestep": self.timesteps.astype(np.float32),
            "alpha_prod": self.alpha_prod,
            "alpha_prod_prev": self.alpha_prod_prev,
            "variance": self.variance,
        }

    def num_iterations(self) -> int:
        return len(self.timesteps)

    def step(self, model_output, sample, i: int):
        """x_{t-1} from predicted noise `model_output` at step index i."""
        pred_x0 = (sample - float(self._sqrt_beta[i]) * model_output) \
            / float(self._sqrt_alpha[i])
        pred_dir = float(self._sqrt_dir[i]) * model_output
        return float(self._sqrt_alpha_prev[i]) * pred_x0 + pred_dir
