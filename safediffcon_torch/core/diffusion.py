"""Gaussian diffusion process: q/p math and the training loss.

Port of `safediffcon_tpu/core/diffusion.py` (reference:
1D/model/diffusion.py:193-224,629-746) over channels-last tensors.
`apply_fn(x, t)` is the denoiser with its weights bound. Random timesteps
and noise come from an explicit `torch.Generator`, or are handed in (`t=`,
`noise=`), which is how the parity tests replay JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from safediffcon_torch.core.conditioning import IdentityConditioner
from safediffcon_torch.core.schedules import DiffusionSchedule, extract
from safediffcon_torch.parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Static configuration of the diffusion process."""

    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None  # None -> as many steps as timesteps
    objective: str = "pred_noise"
    beta_schedule: str = "sigmoid"
    ddim_eta: float = 0.0
    clip_denoised: bool = True  # ancestral sampler: clamp x_start to [-1, 1]
    # DPM-Solver++ only: impose conditions at the iterate's own noise level
    # (q_sample of the clean condition values) at intermediate steps instead
    # of writing clean values into a noisy iterate (RePaint-style,
    # arXiv 2201.09865); the final sample still gets the clean values. Off
    # by default: the U-Nets are trained with clean conditions written into
    # the noised input, so noised conditions are out of distribution.
    noise_matched_cond: bool = False

    @property
    def is_ddim(self) -> bool:
        """Whether `core.sampling.sample` takes the DDIM sampler: fewer
        sampling steps than diffusion steps."""
        return self.sampling_timesteps is not None and self.sampling_timesteps < self.timesteps


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Diffuse x_start to timestep t (reference: 1D/model/diffusion.py:629-636)."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_v(sched: DiffusionSchedule, x_start, t, noise):
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * noise
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
    )


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


def predict_start_from_v(sched: DiffusionSchedule, x_t, t, v):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def q_posterior(sched: DiffusionSchedule, x_start, x_t, t):
    """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    var = extract(sched.posterior_variance, t, nd)
    log_var = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, var, log_var


def p_losses(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    cond=None,
) -> torch.Tensor:
    """Per-sample denoising loss, shape (B,): noise x_start to t, condition
    the noised input, run the denoiser, zero the target at conditioned
    cells, drop padded cells, per-sample MSE times the SNR loss weight
    (reference: 1D/model/diffusion.py:638-733)."""
    cond = cond if cond is not None else IdentityConditioner()
    x = q_sample(sched, x_start, t, noise)
    x = cond.apply_train(x, x_start) if hasattr(cond, "apply_train") else cond.apply(x)

    model_out = apply_fn(x, t)

    if cfg.objective == "pred_noise":
        target = noise
    elif cfg.objective == "pred_x0":
        target = x_start
    elif cfg.objective == "pred_v":
        target = predict_v(sched, x_start, t, noise)
    else:
        raise ValueError(f"unknown objective {cfg.objective!r}")

    target = cond.loss_target(target)
    model_out = cond.mask_output(model_out, target)

    sq = (model_out - target) ** 2
    per_sample = sq.reshape(sq.shape[0], -1).mean(dim=-1)
    return per_sample * sched.loss_weight[t]


def draw_t_noise(cfg: DiffusionConfig, x_start: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
    """Uniform timesteps in [0, timesteps) and standard normal noise for a
    batch, on x_start's device; a rank's share of a data-parallel batch
    takes its rows of the global draws (`parallel.mesh.SlicedGenerator`)."""
    t = pmesh.randint(cfg.timesteps, (x_start.shape[0],), generator, device=x_start.device)
    noise = pmesh.randn(x_start.shape, generator, dtype=x_start.dtype, device=x_start.device)
    return t, noise


def diffusion_loss(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x_start: torch.Tensor,
    cond=None,
    weights: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean training loss over random timesteps and noise (`t`, `noise`
    when given); `weights` are per-sample reweights (conformal
    post-training, reference: 1D/posttrain/post_train.py:206-210)."""
    if t is None or noise is None:
        t, noise = draw_t_noise(cfg, x_start, generator)
    per_sample = p_losses(apply_fn, sched, cfg, x_start, t, noise, cond)
    if weights is not None:
        per_sample = per_sample * weights
    return per_sample.mean()


class GaussianDiffusion:
    """Convenience bundle of (denoiser, schedule, config): a thin object
    over the functional API, as the JAX class is. `apply_fn(x, t)` is the
    denoiser with its weights bound (a model module will do). Timesteps and
    noise are drawn from `generator`, or handed in (`t=`, `noise=`)."""

    def __init__(self, apply_fn: Callable, sched: DiffusionSchedule, cfg: DiffusionConfig):
        self.apply_fn = apply_fn
        self.sched = sched
        self.cfg = cfg

    def loss(self, x_start, cond=None, weights=None,
             generator: Optional[torch.Generator] = None, t=None, noise=None):
        return diffusion_loss(self.apply_fn, self.sched, self.cfg, x_start, cond, weights,
                              generator, t, noise)

    def per_sample_loss(self, x_start, cond=None,
                        generator: Optional[torch.Generator] = None, t=None, noise=None):
        if t is None or noise is None:
            t, noise = draw_t_noise(self.cfg, x_start, generator)
        return p_losses(self.apply_fn, self.sched, self.cfg, x_start, t, noise, cond)
