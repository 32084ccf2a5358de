"""Gaussian diffusion process math used by the samplers.

Port of the sampling half of `safediffcon_tpu/core/diffusion.py` (the
DDIM sampler's fields of `DiffusionConfig`); the training loss
(`p_losses`) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from safediffcon_torch.core.schedules import DiffusionSchedule, extract


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Static configuration of the diffusion process."""

    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None  # None -> as many steps as timesteps
    objective: str = "pred_noise"
    beta_schedule: str = "sigmoid"
    ddim_eta: float = 0.0


def predict_start_from_noise(sched: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def predict_noise_from_start(sched: DiffusionSchedule, x_t, t, x0):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)
