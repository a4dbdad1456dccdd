"""Scheduler base: per-step tables built on the host, step math in torch.

Port of diffusiontexturepainting_tpu/schedulers/base.py, whose package
imports jax. Each scheduler builds its tables in float64 numpy for a step
count (`set_timesteps`) and rounds them to float32 at the end, as the JAX
package does; `scan_rows()` returns them keyed as the JAX scheduler's
rows. The denoise loop (pipeline/inpaint.py) walks `rows()`, one dict of
float32 numpy scalars (or small arrays) per model call, and calls

    step(model_output, sample, row, state, noise) -> (prev_sample, state)

on torch tensors on the sample's device. `noise` is a standard normal of
the sample's shape, used only where `stochastic` is True; `state` is the
multistep history (`init_state`). A scalar of a row enters the tensor math
as a Python float holding the float32 value, so each product is the
float32 product the JAX package computes.
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


def sigmas_from_alphas(ac: np.ndarray) -> np.ndarray:
    """k-diffusion sigmas sqrt((1 - alpha_bar) / alpha_bar), float64."""
    return np.sqrt((1.0 - ac) / ac)


def linspace_sigmas(sigmas_full: np.ndarray, num_train_timesteps: int,
                    n: int):
    """(float64 timesteps linspace(0, N-1, n) descending, float64 sigmas
    interpolated onto them with a final 0): EulerA's and LMS's tables."""
    timesteps = np.linspace(0, num_train_timesteps - 1, n,
                            dtype=np.float64)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(num_train_timesteps),
                       sigmas_full)
    return timesteps, np.concatenate([sigmas, [0.0]])


class Scheduler:
    """Common interface (JAX base.py:51-84). Subclasses define
    set_timesteps(n), scan_rows() and step(); `init_state(sample)` returns
    the carried history as tensors like `sample` ({} when none)."""

    init_noise_sigma = 1.0
    stochastic = False  # takes per-step noise

    def num_iterations(self) -> int:
        """Model calls of the loop: len(scan_rows()['timestep']) (PNDM runs
        steps + 1)."""
        return len(self.scan_rows()["timestep"])

    def rows(self) -> list:
        """scan_rows() cut into one dict a model call."""
        table = self.scan_rows()
        return [{k: v[i] for k, v in table.items()}
                for i in range(self.num_iterations())]

    def init_state(self, sample) -> dict:
        return {}

    def scale_model_input(self, sample, row):
        """The UNet input (identity here; sigma scaling for the
        k-diffusion schedulers)."""
        return sample
