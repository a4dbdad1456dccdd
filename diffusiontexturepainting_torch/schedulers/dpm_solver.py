"""DPM-Solver(++) multistep scheduler, orders 1/2/3.

Port of diffusiontexturepainting_tpu/schedulers/dpm_solver.py: SD betas
0.00085/0.012, timesteps linspace(0, N-1, n+1).round()[::-1][:-1], the
lower-order warm-up ladder and lower_order_final, algorithm_type
dpmsolver++/dpmsolver, solver_type midpoint/heun. The tables (the same
float64 numpy, the same `_safe`/`_finite` guards, rounded to float32) fold
every coefficient and the per-step order into one-hot rows; the step is
the JAX package's branch-free combination, the history (the two previous
converted model outputs) carried as state.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Scheduler, alphas_cumprod_from_betas, scaled_linear_betas


class DPMSolverMultistepScheduler(Scheduler):
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 solver_order: int = 2, lower_order_final: bool = True,
                 algorithm_type: str = "dpmsolver++",
                 solver_type: str = "midpoint",
                 prediction_type: str = "epsilon"):
        if solver_order not in (1, 2, 3):
            raise ValueError("solver_order must be 1, 2 or 3")
        if algorithm_type not in ("dpmsolver++", "dpmsolver"):
            raise ValueError(algorithm_type)
        if solver_type not in ("midpoint", "heun"):
            raise ValueError(solver_type)
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(prediction_type)
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        self.prediction_type = prediction_type
        ac = alphas_cumprod_from_betas(
            scaled_linear_betas(num_train_timesteps, beta_start, beta_end))
        self._alpha_t = np.sqrt(ac)
        self._sigma_t = np.sqrt(1.0 - ac)
        self._lambda_t = np.log(self._alpha_t) - np.log(self._sigma_t)

    def set_timesteps(self, num_inference_steps: int):
        n = int(num_inference_steps)
        self.num_inference_steps = n
        ts = (np.linspace(0, self.num_train_timesteps - 1, n + 1)
              .round()[::-1][:-1].copy().astype(np.int64))
        self.timesteps = ts

        lam, al, sg = self._lambda_t, self._alpha_t, self._sigma_t
        prev_ts = np.concatenate([ts[1:], [0]])
        h = lam[prev_ts] - lam[ts]
        plus = self.algorithm_type == "dpmsolver++"
        midpoint = self.solver_type == "midpoint"

        # first order. ++: x = (s_p/s)x - a_p(e^{-h}-1)D0;
        #          non-++: x = (a_p/a)x - s_p(e^{h}-1)D0
        if plus:
            self.c1_0 = (sg[prev_ts] / sg[ts]).astype(np.float32)
            self.c1_1 = (al[prev_ts] * (np.exp(-h) - 1.0)).astype(np.float32)
        else:
            self.c1_0 = (al[prev_ts] / al[ts]).astype(np.float32)
            self.c1_1 = (sg[prev_ts] * (np.exp(h) - 1.0)).astype(np.float32)
        # second order, x = c2_0 x - c2_1 D0 - c2_2 D1 with the heun /
        # midpoint and ++ / non-++ signs folded into c2_2
        self.c2_0, self.c2_1 = self.c1_0, self.c1_1
        if plus:
            c2_2 = (0.5 * al[prev_ts] * (np.exp(-h) - 1.0) if midpoint else
                    -al[prev_ts] * ((np.exp(-h) - 1.0) / _safe(h) + 1.0))
        else:
            c2_2 = (0.5 * sg[prev_ts] * (np.exp(h) - 1.0) if midpoint else
                    sg[prev_ts] * ((np.exp(h) - 1.0) / _safe(h) - 1.0))
        self.c2_2 = c2_2.astype(np.float32)
        # third order, x = c3_0 x - c3_1 D0 - c3_2 D1 - c3_3 D2
        self.c3_0, self.c3_1 = self.c1_0, self.c1_1
        if plus:
            c3_2 = -al[prev_ts] * ((np.exp(-h) - 1.0) / _safe(h) + 1.0)
            c3_3 = al[prev_ts] * ((np.exp(-h) - 1.0 + h) / _safe(h) ** 2
                                  - 0.5)
        else:
            c3_2 = sg[prev_ts] * ((np.exp(h) - 1.0) / _safe(h) - 1.0)
            c3_3 = sg[prev_ts] * ((np.exp(h) - 1.0 - h) / _safe(h) ** 2
                                  - 0.5)
        self.c3_2 = c3_2.astype(np.float32)
        self.c3_3 = c3_3.astype(np.float32)

        # difference weights: s0 = ts[i], s1 = ts[i-1], s2 = ts[i-2]
        s1 = np.concatenate([[ts[0]], ts[:-1]])
        s2 = np.concatenate([[ts[0], ts[0]], ts[:-2]])
        r0 = (lam[ts] - lam[s1]) / _safe(h)
        r1 = (lam[s1] - lam[s2]) / _safe(h)
        self.inv_r0 = _finite(1.0 / _safe(r0)).astype(np.float32)
        self.inv_r1 = _finite(1.0 / _safe(r1)).astype(np.float32)
        self.w01 = _finite(r0 / _safe(r0 + r1)).astype(np.float32)
        self.inv_r01 = _finite(1.0 / _safe(r0 + r1)).astype(np.float32)

        # the order of each step (one-hot): warm-up ladder, then the
        # lower_order_final step-down below 15 steps
        orders = np.zeros((3, n), np.float32)
        final_ladder = self.lower_order_final and n < 15
        for i in range(n):
            order = min(self.solver_order, i + 1)
            if final_ladder:
                if i == n - 1:
                    order = 1
                elif i == n - 2 and self.solver_order >= 3:
                    order = min(order, 2)
            orders[order - 1, i] = 1.0
        self.o1, self.o2, self.o3 = orders
        self.alpha_s = al[ts].astype(np.float32)
        self.sigma_s = sg[ts].astype(np.float32)
        return self

    def scan_rows(self):
        return {
            "timestep": self.timesteps.astype(np.float32),
            "alpha_s": self.alpha_s,
            "sigma_s": self.sigma_s,
            "c1_0": self.c1_0, "c1_1": self.c1_1,
            "c2_0": self.c2_0, "c2_1": self.c2_1, "c2_2": self.c2_2,
            "c3_0": self.c3_0, "c3_1": self.c3_1,
            "c3_2": self.c3_2, "c3_3": self.c3_3,
            "inv_r0": self.inv_r0, "inv_r1": self.inv_r1,
            "w01": self.w01, "inv_r01": self.inv_r01,
            "o1": self.o1, "o2": self.o2, "o3": self.o3,
        }

    def init_state(self, sample):
        return {"m_prev": torch.zeros_like(sample, dtype=torch.float32),
                "m_prev2": torch.zeros_like(sample, dtype=torch.float32)}

    def step(self, model_output, sample, row, state, noise=None):
        r = {k: float(v) for k, v in row.items()}
        # ++ solves in data space (the x0 prediction), non-++ in epsilon
        # space
        if self.algorithm_type == "dpmsolver++":
            if self.prediction_type == "epsilon":
                m0 = (sample - r["sigma_s"] * model_output) / r["alpha_s"]
            else:
                m0 = r["alpha_s"] * sample - r["sigma_s"] * model_output
        elif self.prediction_type == "epsilon":
            m0 = model_output
        else:
            m0 = r["alpha_s"] * model_output + r["sigma_s"] * sample

        d1_0 = (m0 - state["m_prev"]) * r["inv_r0"]
        d1_1 = (state["m_prev"] - state["m_prev2"]) * r["inv_r1"]
        d1_3 = d1_0 + r["w01"] * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) * r["inv_r01"]

        x1 = r["c1_0"] * sample - r["c1_1"] * m0
        x2 = r["c2_0"] * sample - r["c2_1"] * m0 - r["c2_2"] * d1_0
        x3 = (r["c3_0"] * sample - r["c3_1"] * m0
              - r["c3_2"] * d1_3 - r["c3_3"] * d2)
        prev = r["o1"] * x1 + r["o2"] * x2 + r["o3"] * x3
        return prev, {"m_prev": m0, "m_prev2": state["m_prev"]}


def _safe(x):
    """Zeros replaced by 1, so unused table slots divide cleanly (the
    one-hot order rows zero out any branch whose inputs were guarded)."""
    x = np.asarray(x, np.float64)
    return np.where(x == 0.0, 1.0, x)


def _finite(x):
    return np.where(np.isfinite(x), x, 0.0)
