"""Guided DDIM sampling.

Port of `model_predictions`, `_ddim_times`, `ddim_sample` and `sample` of
`safediffcon_tpu/core/sampling.py`. The JAX sampler is one `lax.scan` that
draws each step's noise from a split key; here the loop is plain Python and
the noise is either handed in (`init_noise`, `step_noise`) or drawn from an
explicit `torch.Generator`. The parity tests replay the JAX key chain and
pass its noise in, since the two frameworks' generators differ.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from safediffcon_torch.core.conditioning import IdentityConditioner
from safediffcon_torch.core.diffusion import (
    DiffusionConfig,
    predict_noise_from_start,
    predict_start_from_noise,
)
from safediffcon_torch.core.schedules import DiffusionSchedule


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def model_predictions(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    x: torch.Tensor,
    time: int,
    *,
    guidance_grad: Optional[Callable] = None,
    j_scale: float = 1.0,
    clip_x_start: bool = False,
    rederive_pred_noise: bool = False,
) -> ModelPrediction:
    """One denoiser evaluation with optional guidance on the predicted x0
    (reference: 1D/model/diffusion.py:226-286): the guidance gradient at the
    (maybe clipped) x_start, times the step size `j_scale`, is added to
    pred_noise, then x_start is derived again. `apply_fn(x, t)` is the
    denoiser with its weights bound. The "pred_noise" objective only, the one
    every task's sampler uses."""
    if cfg.objective != "pred_noise":
        raise ValueError(f"objective {cfg.objective!r} is not ported")
    t = torch.full((x.shape[0],), time, dtype=torch.long, device=x.device)
    pred_noise = apply_fn(x, t)

    clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
    x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
    if guidance_grad is not None:
        pred_noise = pred_noise + guidance_grad(x_start.detach()) * j_scale
    x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
    if clip_x_start and rederive_pred_noise:
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    return ModelPrediction(pred_noise, x_start)


def _ddim_times(cfg: DiffusionConfig):
    """Reversed DDIM time pairs [(T-1, ...), ..., (t1, -1)] as Python ints,
    from torch.linspace(-1, T-1, S+1) int truncation
    (reference: 1D/model/diffusion.py:460-462)."""
    s = cfg.sampling_timesteps or cfg.timesteps
    times = np.linspace(-1, cfg.timesteps - 1, s + 1)
    times = list(reversed(times.astype(np.int64).tolist()))
    return list(zip(times[:-1], times[1:]))


def _ddim_coefficients(alphas_cumprod: np.ndarray, time: int, time_next: int,
                      eta: float):
    """(sqrt(alpha_next), c, sigma) of one DDIM update as float32 values,
    from the float32 table in the JAX sampler's order of operations.
    c^2 = 1 - alpha_next - sigma^2 is rounded once, as XLA contracts it into
    a fused multiply-add: at the start of an eta = 1 chain it is the
    difference of two nearly equal numbers, where a rounded sigma^2 moves c
    by ~6 %."""
    f = np.float32
    a, an = f(alphas_cumprod[time]), f(alphas_cumprod[time_next])
    sigma = f(f(eta) * np.sqrt(f((f(1) - a / an) * (f(1) - an) / (f(1) - a))))
    c2 = f(np.float64(f(1) - an) - np.float64(sigma) ** 2)
    return float(np.sqrt(an)), float(np.sqrt(c2)), float(sigma)


def ddim_sample(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    shape,
    cond=None,
    guidance_grad: Optional[Callable] = None,
    j_scheduler: Optional[Callable[[int], float]] = None,
    final_step_grad: bool = False,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Guided DDIM sampling.

    Args:
        apply_fn: (x, t) -> model output, weights bound.
        cond: conditioner; `cond.apply` is re-applied after every update
            (and once to the initial noise), but not after the final step.
        guidance_grad: x_start -> dJ/dx_start (already includes any weights).
        j_scheduler: timestep -> guidance step size, called in every step
            and in the final one (`core.schedules.get_J_scheduler`); None is
            a constant 1.
        final_step_grad: all steps but the last run without autograd, so
            gradients w.r.t. the model's weights flow through the final
            denoise step only (InfFT semantics). Otherwise every step runs
            in the caller's grad mode.
        init_noise, step_noise: the initial noise and the noise of each of
            the len(pairs) - 1 stochastic steps; drawn from `generator` on
            the device of the schedule where not given.
    """
    cond = cond if cond is not None else IdentityConditioner()
    j_scheduler = j_scheduler or (lambda t: 1.0)
    pairs = _ddim_times(cfg)
    if pairs[-1][1] >= 0:
        raise ValueError("last DDIM pair must end at t=-1")
    device = sched.alphas_cumprod.device
    if step_noise is not None and len(step_noise) != len(pairs) - 1:
        raise ValueError(
            f"step_noise holds {len(step_noise)} draws, the sampler takes {len(pairs) - 1}")

    def draw():
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    img = init_noise if init_noise is not None else draw()
    img = cond.apply(img)
    alphas_cumprod = sched.alphas_cumprod.cpu().numpy()

    scan_ctx = torch.no_grad() if final_step_grad else contextlib.nullcontext()
    with scan_ctx:
        for i, (time, time_next) in enumerate(pairs[:-1]):
            pred = model_predictions(apply_fn, sched, cfg, img, time,
                                     guidance_grad=guidance_grad, j_scale=j_scheduler(time),
                                     clip_x_start=True, rederive_pred_noise=True)
            sqrt_an, c, sigma = _ddim_coefficients(alphas_cumprod, time, time_next, cfg.ddim_eta)
            noise = step_noise[i] if step_noise is not None else draw()
            img = pred.pred_x_start * sqrt_an + c * pred.pred_noise + sigma * noise
            img = cond.apply(img)

    if final_step_grad:
        img = img.detach()
    # Final step: img = x_start, no condition re-imposition
    # (reference 1D/model/diffusion.py:495-498).
    final_ctx = torch.enable_grad() if final_step_grad else contextlib.nullcontext()
    with final_ctx:
        pred = model_predictions(apply_fn, sched, cfg, img, pairs[-1][0],
                                 guidance_grad=guidance_grad,
                                 j_scale=j_scheduler(pairs[-1][0]), clip_x_start=True,
                                 rederive_pred_noise=True)
    return pred.pred_x_start


def sample(apply_fn: Callable, sched: DiffusionSchedule, cfg: DiffusionConfig, shape,
           **kw) -> torch.Tensor:
    """DDIM when `cfg.is_ddim` (fewer sampling steps than timesteps), else
    the ancestral sampler (reference: 1D/model/diffusion.py:557-607), which
    is not ported yet. `kw` are `ddim_sample`'s."""
    if not cfg.is_ddim:
        raise NotImplementedError("the ancestral sampler is not ported yet; set "
                                  "sampling_timesteps below timesteps for DDIM")
    return ddim_sample(apply_fn, sched, cfg, shape, **kw)
