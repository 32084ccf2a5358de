"""Diffusion noise schedules, precomputed buffers and guidance step sizes.

Port of `safediffcon_tpu/core/schedules.py`: the tables are built once in
float64 numpy, exactly as there, and stored as float32 tensors on a device.
The guidance step-size schedulers (`get_J_scheduler`) map a sampler's
integer timestep to a float32 step size read from the same kind of table.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """All per-timestep buffers needed by sampling and guidance."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor
    # float32 host copies of `alphas`, `alphas_prev` and `alphas_cumprod`,
    # from which the samplers compute their per-step coefficients (a copy
    # from the card inside a captured sampler call would wait for it)
    host: Dict[str, np.ndarray]

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear schedule scaled so that 1000-step behavior is preserved."""
    scale = 1000 / timesteps
    beta_start = scale * 0.0001
    beta_end = scale * 0.02
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal); the Burgers task's default."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1
) -> np.ndarray:
    """Sigmoid schedule (arXiv 2212.11972 Fig. 8); the smoke task's default."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    v_start = 1 / (1 + np.exp(-start / tau))
    v_end = 1 / (1 + np.exp(-end / tau))
    alphas_cumprod = (-1 / (1 + np.exp(-((x * (end - start) + start) / tau))) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def make_schedule(
    timesteps: int = 1000,
    beta_schedule: str = "sigmoid",
    objective: str = "pred_noise",
    device="cuda",
) -> DiffusionSchedule:
    """Build the full buffer set for a diffusion process on `device`."""
    if beta_schedule not in _BETA_SCHEDULES:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    betas = _BETA_SCHEDULES[beta_schedule](timesteps)

    alphas = 1.0 - betas
    alphas_prev = np.concatenate([[1.0], alphas[:-1]])
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

    snr = alphas_cumprod / (1 - alphas_cumprod)
    if objective == "pred_noise":
        loss_weight = np.ones_like(snr)
    elif objective == "pred_x0":
        loss_weight = snr
    elif objective == "pred_v":
        loss_weight = snr / (snr + 1)
    else:
        raise ValueError(f"unknown objective {objective!r}")

    def as_f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    host = {"alphas": alphas, "alphas_prev": alphas_prev, "alphas_cumprod": alphas_cumprod}

    return DiffusionSchedule(
        betas=as_f32(betas),
        alphas=as_f32(alphas),
        alphas_prev=as_f32(alphas_prev),
        alphas_cumprod=as_f32(alphas_cumprod),
        alphas_cumprod_prev=as_f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=as_f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=as_f32(posterior_variance),
        posterior_log_variance_clipped=as_f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
        posterior_mean_coef1=as_f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=as_f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        loss_weight=as_f32(loss_weight),
        host={k: np.asarray(v, dtype=np.float32) for k, v in host.items()},
    )


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars for a batch of timesteps `t` (B,) and
    shape them (B, 1, ..., 1) for broadcasting against an ndim-tensor."""
    out = buf[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


# Guidance step-size schedulers (reference: 1D/model/model_utils.py:91-180):
# functions of the sampler's integer timestep that scale the guidance
# gradient, each read from a float32 table as in JAX.

def _table_scheduler(table: np.ndarray):
    table = np.asarray(table, dtype=np.float32)

    def scheduler(t: int) -> float:
        return float(table[t])

    return scheduler


def cosine_beta_J_schedule(timesteps: int = 1000):
    """beta(t) of the cosine schedule, used as an increasing step size."""
    return _table_scheduler(cosine_beta_schedule(timesteps))


def sigmoid_J_schedule(timesteps: int = 1000):
    return _table_scheduler(sigmoid_beta_schedule(timesteps))


def sigmoid_flip_J_schedule(timesteps: int = 1000):
    return _table_scheduler(sigmoid_beta_schedule(timesteps)[::-1])


def plain_cosine_J_schedule(s: float = 0.0, timesteps: int = 1000):
    """Flipped plain cosine: t = 0 gets the smallest step (reference:
    1D/model/model_utils.py:173-180 plain_cosine_schedule)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    return _table_scheduler(np.cos((x + s) / (timesteps + s))[::-1])


def get_J_scheduler(name):
    """Scheduler name -> callable t -> step size (1 for None / "constant")
    (reference: 1D/model/model_utils.py:160-180 get_scheduler)."""
    if name is None or name == "constant":
        return lambda t: 1.0
    factories = {
        "cosine": cosine_beta_J_schedule,
        "plain_cosine": plain_cosine_J_schedule,
        "sigmoid": sigmoid_J_schedule,
        "sigmoid_flip": sigmoid_flip_J_schedule,
    }
    if name not in factories:
        raise ValueError(f"unknown J scheduler {name!r}")
    return factories[name]()


# The reference threads a separate `w_scheduler` name through its sample
# kwargs but resolves it with the same registry (1D/utils/common.py usage of
# get_scheduler); the JAX package keeps that equivalence as an alias.
get_w_scheduler = get_J_scheduler
