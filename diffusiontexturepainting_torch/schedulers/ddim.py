"""DDIM scheduler (eta = 0), the serving default.

Port of diffusiontexturepainting_tpu/schedulers/ddim.py: scaled-linear
betas, steps_offset=1, set_alpha_to_one=False, "leading" spacing, epsilon
prediction. Its eta = 0 update coefficients are evaluated once on the host
in float32, in the order the JAX package's step evaluates them on its
float32 rows, and ride in each row beside the JAX package's four tables.
"""

from __future__ import annotations

import numpy as np

from .base import (
    Scheduler,
    alphas_cumprod_from_betas,
    leading_timesteps,
    scaled_linear_betas,
)

# the host-evaluated coefficients each row carries besides scan_rows()
_COEFFS = ("sqrt_beta", "sqrt_alpha", "sqrt_alpha_prev", "sqrt_dir")


class DDIMScheduler(Scheduler):
    """Deterministic (eta = 0) DDIM with epsilon prediction."""

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
        self.sqrt_beta = np.sqrt(one - self.alpha_prod)
        self.sqrt_alpha = np.sqrt(self.alpha_prod)
        self.sqrt_alpha_prev = np.sqrt(self.alpha_prod_prev)
        self.sqrt_dir = np.sqrt(one - self.alpha_prod_prev)
        return self

    def scan_rows(self) -> dict:
        """Per-step float32 tables, keyed as the JAX scheduler's rows."""
        return {
            "timestep": self.timesteps.astype(np.float32),
            "alpha_prod": self.alpha_prod,
            "alpha_prod_prev": self.alpha_prod_prev,
            "variance": self.variance,
        }

    def rows(self) -> list:
        rows = super().rows()
        for i, row in enumerate(rows):
            row.update({k: getattr(self, k)[i] for k in _COEFFS})
        return rows

    def step(self, model_output, sample, row, state=None, noise=None):
        """x_{t-1} from the predicted noise; the state is unused."""
        pred_x0 = (sample - float(row["sqrt_beta"]) * model_output) \
            / float(row["sqrt_alpha"])
        pred_dir = float(row["sqrt_dir"]) * model_output
        prev = float(row["sqrt_alpha_prev"]) * pred_x0 + pred_dir
        return prev, (state if state is not None else {})
