"""DDIM sampler: v-prediction, zero-SNR beta rescale, trailing timestep
spacing. Counterpart of ``mimo_tpu/schedulers/ddim.py``: the schedule tables
are the same numpy constants; ``step_v`` runs on torch tensors in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mimo_tpu_torch.config import SchedulerConfig


def _make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    else:
        raise ValueError(cfg.beta_schedule)
    acp = np.cumprod(1.0 - betas)
    if cfg.rescale_betas_zero_snr:
        sqrt_acp = np.sqrt(acp)
        a0, aT = sqrt_acp[0], sqrt_acp[-1]
        sqrt_acp = (sqrt_acp - aT) * (a0 / (a0 - aT))
        acp = sqrt_acp ** 2
    return acp


@dataclass(frozen=True)
class DDIM:
    """Precomputed DDIM tables for a fixed number of inference steps."""

    timesteps: np.ndarray          # (S,) int32, descending
    alpha_t: np.ndarray            # (S,) alpha_cumprod at t
    alpha_prev: np.ndarray         # (S,) alpha_cumprod at prev t (1.0 past end)

    init_noise_sigma: float = 1.0

    @staticmethod
    def create(cfg: SchedulerConfig, num_inference_steps: int) -> "DDIM":
        T = cfg.num_train_timesteps
        S = num_inference_steps
        acp = _make_alphas_cumprod(cfg)
        if cfg.timestep_spacing == "trailing":
            ts = np.round(np.arange(T, 0, -T / S)).astype(np.int64) - 1
        elif cfg.timestep_spacing == "leading":
            ts = (np.arange(0, S) * (T // S)).round()[::-1].astype(np.int64)
            ts += cfg.steps_offset
        else:
            raise ValueError(cfg.timestep_spacing)
        prev_ts = ts - T // S
        alpha_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, T - 1)],
                              1.0)
        return DDIM(timesteps=ts.astype(np.int32),
                    alpha_t=acp[ts].astype(np.float32),
                    alpha_prev=alpha_prev.astype(np.float32))

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step_v(self, v: torch.Tensor, step_index: int, x: torch.Tensor,
               alpha_t: Optional[float] = None,
               alpha_prev: Optional[float] = None) -> torch.Tensor:
        """One eta=0 DDIM update under v-prediction, fp32 inside (the
        coefficients are fp32 square roots, as in the JAX version)."""
        a_t = np.float32(self.alpha_t[step_index] if alpha_t is None
                         else alpha_t)
        a_p = np.float32(self.alpha_prev[step_index] if alpha_prev is None
                         else alpha_prev)
        one = np.float32(1.0)
        sqrt_a, sqrt_b = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        xf, vf = x.float(), v.float()
        x0 = sqrt_a * xf - sqrt_b * vf
        eps = sqrt_a * vf + sqrt_b * xf
        prev = float(np.sqrt(a_p)) * x0 + float(np.sqrt(one - a_p)) * eps
        return prev.to(x.dtype)
