"""PNDM (PLMS) scheduler.

Port of diffusiontexturepainting_tpu/schedulers/pndm.py: SD betas
0.00085/0.012, PRK steps skipped, the second timestep repeated (n
requested steps run n + 1 model calls), Adams-Bashforth blending of the
last <= 4 epsilon predictions with the startup sequence
  call 0: plain epsilon (caches the sample)
  call 1: the average with the previous epsilon, stepped from the CACHED
          sample
  call 2: AB2; call 3: AB3; call >= 4: AB4.

The same rows as the JAX package's (blend weights over [current output,
history], push / use_cached / cache flags), and the same branch-free step
over them: the history `ets` is a (4, ...) newest-first stack and the
cached sample are carried as state. The cached sample replaces the sample
before the v-prediction conversion, as the reference does on the repeated
call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.constants import device_constant
from .base import Scheduler, alphas_cumprod_from_betas, scaled_linear_betas


class PNDMScheduler(Scheduler):
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 steps_offset: int = 0, prediction_type: str = "epsilon"):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(prediction_type)
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.prediction_type = prediction_type
        self._ac = alphas_cumprod_from_betas(
            scaled_linear_betas(num_train_timesteps, beta_start, beta_end))
        self.final_alpha_cumprod = self._ac[0]

    def set_timesteps(self, num_inference_steps: int):
        n = int(num_inference_steps)
        self.num_inference_steps = n
        step_ratio = self.num_train_timesteps // n
        base = (np.arange(0, n) * step_ratio).round().astype(np.int64)
        base += self.steps_offset
        # skip PRK; repeat the second-to-last ascending entry
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        self.timesteps = plms.copy()

        ac, final = self._ac, self.final_alpha_cumprod
        ac_prev_full = np.roll(ac, step_ratio)
        ac_prev_full[:step_ratio] = final
        sample_coeff = np.sqrt(ac_prev_full / ac)
        beta_c = 1.0 - ac
        beta_c_prev = 1.0 - ac_prev_full
        denom = ac * np.sqrt(beta_c_prev) + np.sqrt(ac * beta_c * ac_prev_full)

        t = self.timesteps
        self.ac_idx = ac[t].astype(np.float32)
        self.beta_c_idx = beta_c[t].astype(np.float32)
        self.ac_prev_idx = ac_prev_full[t].astype(np.float32)
        self.sample_coeff_idx = sample_coeff[t].astype(np.float32)
        self.denom_idx = denom[t].astype(np.float32)

        # blend weights over [current output, hist0..hist3] (hist the
        # newest-first stack after the conditional push)
        iters = len(t)
        w = np.zeros((iters, 5), dtype=np.float32)
        push = np.ones(iters, dtype=np.float32)
        use_cached = np.zeros(iters, dtype=np.float32)
        cache = np.zeros(iters, dtype=np.float32)
        cache[0] = 1.0  # call 0 caches its input sample
        for i in range(iters):
            if i == 0:
                w[i, 1] = 1.0
            elif i == 1:
                push[i] = 0.0
                use_cached[i] = 1.0
                w[i, 0] = w[i, 1] = 0.5
            elif i == 2:
                w[i, 1], w[i, 2] = 1.5, -0.5
            elif i == 3:
                w[i, 1], w[i, 2], w[i, 3] = 23 / 12, -16 / 12, 5 / 12
            else:
                w[i, 1:5] = np.array([55, -59, 37, -9]) / 24.0
        self.blend_weights = w
        self.push_flag = push
        self.use_cached_flag = use_cached
        self.cache_flag = cache
        return self

    def scan_rows(self):
        return {
            "timestep": self.timesteps.astype(np.float32),
            "ac": self.ac_idx,
            "beta_c": self.beta_c_idx,
            "ac_prev": self.ac_prev_idx,
            "sample_coeff": self.sample_coeff_idx,
            "denom": self.denom_idx,
            "w": self.blend_weights,
            "push": self.push_flag,
            "use_cached": self.use_cached_flag,
            "cache": self.cache_flag,
        }

    def init_state(self, sample):
        return {
            "ets": torch.zeros((4,) + tuple(sample.shape),
                               dtype=torch.float32, device=sample.device),
            "cached_sample": torch.zeros_like(sample, dtype=torch.float32),
        }

    def step(self, model_output, sample, row, state, noise=None):
        one = np.float32(1.0)
        push = row["push"]
        pushed = torch.cat([model_output[None], state["ets"][:-1]], dim=0)
        ets = float(push) * pushed + float(one - push) * state["ets"]

        w = np.asarray(row["w"])
        eff = float(w[0]) * model_output + torch.tensordot(
            device_constant(w[1:], ets.device), ets, dims=1)

        # the cached sample replaces the sample BEFORE the v-prediction
        # conversion, as the reference's repeated call does
        use_cached = row["use_cached"]
        s = (float(use_cached) * state["cached_sample"]
             + float(one - use_cached) * sample)
        if self.prediction_type == "v_prediction":
            eff = (float(np.sqrt(row["ac"])) * eff
                   + float(np.sqrt(row["beta_c"])) * s)

        prev = (float(row["sample_coeff"]) * s
                - float(row["ac_prev"] - row["ac"]) * eff
                / float(row["denom"]))
        cache = row["cache"]
        cached = (float(cache) * sample
                  + float(one - cache) * state["cached_sample"])
        return prev, {"ets": ets, "cached_sample": cached}
