"""Guided samplers: DDIM, ancestral (DDPM) and DPM-Solver++(2M).

Port of `safediffcon_tpu/core/sampling.py`. Each JAX sampler is one
`lax.scan` that draws its noise from split keys; here the loop is plain
Python and the draws are either handed in (`init_noise`, `step_noise`) or
drawn from an explicit `torch.Generator`. The parity tests replay the JAX
key chain and pass its draws in, since the two frameworks' generators
differ. `step_noise` holds the draws a sampler takes after its initial
noise, in the order it takes them (each sampler's docstring says which).

A denoiser is `apply_fn(x, t)` with its weights bound; the per-step scalars
of each update are computed on the host from the float32 tables, once per
step, as Python floats, from the schedule's host copies (`sched.host`), so
that a whole sampler call can be captured as one CUDA graph after an eager
first call: nothing in a sampler's chain copies to the host or waits for
the card. `sampler_draws` draws a call's noise ahead of it, as the sampler
would draw it, for such a graph's static buffers.
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
    predict_start_from_v,
    q_posterior,
)
from safediffcon_torch.core.guidance import additive
from safediffcon_torch.core.schedules import DiffusionSchedule
from safediffcon_torch.parallel import mesh as pmesh


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
    proj_guidance: Optional[Callable] = None,
) -> ModelPrediction:
    """One denoiser evaluation with optional guidance on the predicted x0
    (reference: 1D/model/diffusion.py:226-286). For the "pred_noise"
    objective the guidance gradient at the (maybe clipped) x_start, times
    the step size `j_scale`, joins pred_noise (added, or through
    `proj_guidance(ep, nabla_J)`, e.g. `core.guidance.get_proj_ep_orthogonal`),
    then x_start is derived again (and, with clipping and
    `rederive_pred_noise`, pred_noise from the clipped x_start). "pred_x0"
    and "pred_v" models take no guidance, as in the JAX package: their
    x_start is the (clipped) model output, or derived from v, and pred_noise
    follows from it."""
    t = torch.full((x.shape[0],), time, dtype=torch.long, device=x.device)
    model_out = apply_fn(x, t)

    clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
    if cfg.objective == "pred_noise":
        pred_noise = model_out
        x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
        if guidance_grad is not None:
            pred_noise = (proj_guidance or additive)(
                pred_noise, guidance_grad(x_start.detach()) * j_scale)
        x_start = clip(predict_start_from_noise(sched, x, t, pred_noise))
        if clip_x_start and rederive_pred_noise:
            pred_noise = predict_noise_from_start(sched, x, t, x_start)
    elif cfg.objective == "pred_x0":
        x_start = clip(model_out)
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    elif cfg.objective == "pred_v":
        x_start = clip(predict_start_from_v(sched, x, t, model_out))
        pred_noise = predict_noise_from_start(sched, x, t, x_start)
    else:
        raise ValueError(f"unknown objective {cfg.objective!r}")
    return ModelPrediction(pred_noise, x_start)


def compose_two_model_apply(
    apply_uw: Callable,
    apply_w: Callable,
    *,
    prior_beta: float = 1.0,
    normalize_beta: bool = False,
    w_scheduler: Optional[Callable[[int], float]] = None,
    mask_w_input: Optional[Callable] = None,
    mask_w_output: Optional[Callable] = None,
) -> Callable:
    """Two-model composed denoiser: p(u, w) corrected by a p(w)-only model
    (reference eval_two_models, 1D/model/diffusion.py:226-238).

    `apply_uw(params, x, t)` and `apply_w(params, x, t)` are the two
    denoisers on given weights. The w-model sees the input through
    `mask_w_input` (the unseen u rows zeroed) and its output is restricted
    to the w channel by `mask_w_output`; the composition is
    `out - (1 - prior_beta) * eta * out_w` with eta = `w_scheduler(t)` (1
    when None), or with `normalize_beta` the normalized
    `(out - (1 - prior_beta) * out_w) / prior_beta`.

    Returns `apply_fn(params, x, t)` over params = (params_uw, params_w);
    bind the pair (`functools.partial(apply_fn, params)`) to hand it to any
    sampler here.
    """
    mask_w_input = mask_w_input or (lambda x: x)
    mask_w_output = mask_w_output or (lambda out: out)

    def apply_fn(params, x, t):
        params_uw, params_w = params
        out = apply_uw(params_uw, x, t)
        out_w = mask_w_output(apply_w(params_w, mask_w_input(x), t))
        if normalize_beta:
            return (out - (1.0 - prior_beta) * out_w) / prior_beta
        eta = 1.0 if w_scheduler is None else w_scheduler(int(t[0]))
        return out - (1.0 - prior_beta) * eta * out_w

    return apply_fn


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


def _step_draws(shape, device, generator, step_noise, n: int):
    """The `n` draws a sampler takes after its initial noise: `step_noise`
    (its length checked), else fresh ones from `generator`, drawn as the
    sampler takes them."""
    if step_noise is not None:
        if len(step_noise) != n:
            raise ValueError(f"step_noise holds {len(step_noise)} draws, the sampler takes {n}")
        return iter(step_noise)
    return (pmesh.randn(shape, generator, dtype=torch.float32, device=device)
            for _ in range(n))


def draws_kw(noise, generator, shard: pmesh.BatchShard) -> dict:
    """A sampler call's draw arguments: the next (init_noise, step_noise) of
    the iterator `noise`, else `generator`; under a data-parallel `shard`,
    this rank's rows of the global draws."""
    if noise is None:
        return dict(generator=shard.generator(generator))
    init_noise, step_noise = shard.draws(next(noise))
    return dict(init_noise=init_noise, step_noise=step_noise)


def _initial_noise(shape, device, generator, init_noise):
    if init_noise is not None:
        return init_noise
    return pmesh.randn(shape, generator, dtype=torch.float32, device=device)


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
    proj_guidance: Optional[Callable] = None,
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
        proj_guidance: how the guidance gradient joins the predicted noise
            (`model_predictions`); None adds it.
    """
    cond = cond if cond is not None else IdentityConditioner()
    j_scheduler = j_scheduler or (lambda t: 1.0)
    pairs = _ddim_times(cfg)
    if pairs[-1][1] >= 0:
        raise ValueError("last DDIM pair must end at t=-1")
    device = sched.alphas_cumprod.device
    draws = _step_draws(shape, device, generator, step_noise, len(pairs) - 1)
    img = cond.apply(_initial_noise(shape, device, generator, init_noise))
    alphas_cumprod = sched.host["alphas_cumprod"]

    def predict(img, time):
        return model_predictions(apply_fn, sched, cfg, img, time, guidance_grad=guidance_grad,
                                 j_scale=j_scheduler(time), clip_x_start=True,
                                 rederive_pred_noise=True, proj_guidance=proj_guidance)

    scan_ctx = torch.no_grad() if final_step_grad else contextlib.nullcontext()
    with scan_ctx:
        for time, time_next in pairs[:-1]:
            pred = predict(img, time)
            sqrt_an, c, sigma = _ddim_coefficients(alphas_cumprod, time, time_next, cfg.ddim_eta)
            img = pred.pred_x_start * sqrt_an + c * pred.pred_noise + sigma * next(draws)
            img = cond.apply(img)

    if final_step_grad:
        img = img.detach()
    # Final step: img = x_start, no condition re-imposition
    # (reference 1D/model/diffusion.py:495-498).
    final_ctx = torch.enable_grad() if final_step_grad else contextlib.nullcontext()
    with final_ctx:
        return predict(img, pairs[-1][0]).pred_x_start


def ancestral_sample(
    apply_fn: Callable,
    sched: DiffusionSchedule,
    cfg: DiffusionConfig,
    shape,
    cond=None,
    guidance_grad: Optional[Callable] = None,
    j_scheduler: Optional[Callable[[int], float]] = None,
    final_step_grad: bool = False,
    proj_guidance: Optional[Callable] = None,
    guidance_on_x0: bool = True,
    recurrence: bool = False,
    fix_final_step: bool = True,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Guided ancestral (DDPM) sampling over every timestep T-1 ... 0
    (reference p_sample_loop, 1D/model/diffusion.py:368-449): conditions are
    imposed at the top of each step, x_start is clamped when
    `cfg.clip_denoised`, and the step to t = 0 adds no noise.

    guidance_on_x0=False is the reference's `guidance_u0=False` branch
    (:419-424): the guidance gradient is taken at the denoised x_{t-1}
    instead of the predicted x0, joins pred_noise through `proj_guidance`,
    and the posterior step is taken again from the new pred_noise with a
    fresh draw (the model is not run again). recurrence=True is
    Universal-Guidance self-recurrence (:428-430, recurrent_sample
    :308-318): after each step x_{t-1} is noised back to level t once.

    fix_final_step=False reproduces a reference quirk: with
    guidance_on_x0=False and guidance, the reference's t = 0 iteration
    imposes the conditions and then discards its update. The default
    (True) takes the t = 0 update in every mode, as the JAX package does.

    `step_noise` holds, for each t from T-1 down to 1, the posterior step's
    draw, then the second posterior draw (guided, guidance_on_x0=False),
    then the recurrence's draw (recurrence=True): the order in which the
    JAX sampler splits its key. The step to t = 0 takes no draw (JAX draws
    one and multiplies it by 0). `final_step_grad` as in `ddim_sample`.
    """
    cond = cond if cond is not None else IdentityConditioner()
    j_scheduler = j_scheduler or (lambda t: 1.0)
    T = cfg.timesteps
    device = sched.alphas_cumprod.device
    second = guidance_grad is not None and not guidance_on_x0
    per_step = 1 + int(second) + int(recurrence)
    draws = _step_draws(shape, device, generator, step_noise, per_step * (T - 1))
    img = _initial_noise(shape, device, generator, init_noise)
    alphas, alphas_prev = sched.host["alphas"], sched.host["alphas_prev"]

    def posterior_step(img, t, time, x_start):
        if cfg.clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        mean, _, log_var = q_posterior(sched, x_start, img, t)
        if time == 0:
            return mean
        return mean + torch.exp(0.5 * log_var) * next(draws)

    def p_sample(img, time):
        img = cond.apply(img)
        t = torch.full((img.shape[0],), time, dtype=torch.long, device=img.device)
        pred = model_predictions(apply_fn, sched, cfg, img, time,
                                 guidance_grad=guidance_grad if guidance_on_x0 else None,
                                 j_scale=j_scheduler(time), proj_guidance=proj_guidance)
        img_next = posterior_step(img, t, time, pred.pred_x_start)
        if second:
            pred_noise = (proj_guidance or additive)(
                pred.pred_noise, guidance_grad(img_next.detach()) * j_scheduler(time))
            x_start = predict_start_from_noise(sched, img, t, pred_noise)
            img_next = posterior_step(img, t, time, x_start)
        return img_next

    scan_ctx = torch.no_grad() if final_step_grad else contextlib.nullcontext()
    with scan_ctx:
        for time in range(T - 1, 0, -1):
            img = p_sample(img, time)
            if recurrence:
                # noise x_{t-1} back to level t (recurrent_sample), float32
                # scalars as in JAX
                ratio = np.float32(alphas[time]) / np.float32(alphas_prev[time])
                img = (float(np.sqrt(ratio)) * img
                       + float(np.sqrt(np.float32(1) - ratio)) * next(draws))
    if final_step_grad:
        img = img.detach()
    final_ctx = torch.enable_grad() if final_step_grad else contextlib.nullcontext()
    with final_ctx:
        if fix_final_step or not second:
            return p_sample(img, 0)
        # the reference quirk: the conditions imposed, the update discarded
        return cond.apply(img)


def sample(apply_fn: Callable, sched: DiffusionSchedule, cfg: DiffusionConfig, shape,
           **kw) -> torch.Tensor:
    """DDIM when `cfg.is_ddim` (fewer sampling steps than timesteps), else
    the ancestral sampler (reference: 1D/model/diffusion.py:557-607). `kw`
    are the sampler's."""
    fn = ddim_sample if cfg.is_ddim else ancestral_sample
    return fn(apply_fn, sched, cfg, shape, **kw)


def _dpm_lambda(a: float) -> float:
    """Half the log-SNR of the float32 alpha_cumprod `a`, in float64."""
    a = float(a)
    return 0.5 * (np.log(a) - np.log1p(-a))


def _dpm_coefficients(alphas_cumprod: np.ndarray, time: int, time_next: int, h_prev):
    """One DPM-Solver++(2M) step from `time` to `time_next` >= 0:
    (h, sigma_s / sigma_t, alpha_s * expm1(-h), 1 + 1 / (2 r), 1 / (2 r))
    with h = lambda_s - lambda_t and r = h_prev / h (the 2M weights are None
    when `h_prev` is None, the first step).

    Each is evaluated in float64 from the float32 table and rounded once to
    float32: h is a difference of nearly equal numbers at 200-1000 steps,
    where rounding each lambda to float32 first would leave h only a few
    correct bits at worst (the JAX sampler computes these in float32 on the
    device, with that device's log and log1p)."""
    f = np.float32
    a_t, a_s = np.float64(alphas_cumprod[time]), np.float64(alphas_cumprod[time_next])
    h = _dpm_lambda(a_s) - _dpm_lambda(a_t)
    ratio = np.sqrt(1.0 - a_s) / np.sqrt(1.0 - a_t)
    c_x0 = np.sqrt(a_s) * np.expm1(-h)
    w = None
    if h_prev is not None:
        inv_2r = 1.0 / (2.0 * (h_prev / h))
        w = (float(f(1.0 + inv_2r)), float(f(inv_2r)))
    return h, float(f(ratio)), float(f(c_x0)), w


def dpm_solver_sample(
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
    """Guided DPM-Solver++(2M) sampling (arXiv 2211.01095): a second-order
    multistep update in data-prediction space over the DDIM time pairs,
    meant for ~20-50 steps. The first step is first order (deterministic
    DDIM); `ddim_eta` is not used. Conditioning, guidance and
    `final_step_grad` are those of `ddim_sample`: conditions re-imposed
    after every update, the final step returns x0.

    With `cfg.noise_matched_cond` the conditioned cells are set at each
    intermediate step to alpha_t * clean + sigma_t * eps at the iterate's
    level t instead of to the clean values, and the final sample gets the
    clean values. The conditioned cells are those where
    `cond.apply(zeros)` equals `cond.apply(ones)`. `step_noise` then holds
    len(pairs) draws eps: the first imposition's (at pairs[0][0]; JAX's key
    fold_in(rng, 0x636F6E64)), then one per step at its t_next (JAX's
    fold_in of that key with t_next); otherwise it is empty.
    """
    cond = cond if cond is not None else IdentityConditioner()
    j_scheduler = j_scheduler or (lambda t: 1.0)
    pairs = _ddim_times(cfg)
    if pairs[-1][1] >= 0:
        raise ValueError("last pair must end at t=-1")
    device = sched.alphas_cumprod.device
    matched = cfg.noise_matched_cond
    draws = _step_draws(shape, device, generator, step_noise, len(pairs) if matched else 0)
    img = _initial_noise(shape, device, generator, init_noise)
    acp = sched.host["alphas_cumprod"]

    if matched:
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        clean = cond.apply(zeros)
        cond_mask = clean == cond.apply(torch.ones_like(zeros))

        def impose(x, time):
            a = np.float32(acp[time])
            a_t, s_t = float(np.sqrt(a)), float(np.sqrt(np.float32(1) - a))
            return torch.where(cond_mask, a_t * clean + s_t * next(draws), x)

        img = impose(img, pairs[0][0])
    else:
        img = cond.apply(img)

    def predict_x0(x, time):
        return model_predictions(apply_fn, sched, cfg, x, time, guidance_grad=guidance_grad,
                                 j_scale=j_scheduler(time), clip_x_start=True,
                                 rederive_pred_noise=True).pred_x_start

    scan_ctx = torch.no_grad() if final_step_grad else contextlib.nullcontext()
    with scan_ctx:
        x0_prev, h_prev = None, None
        for time, time_next in pairs[:-1]:
            x0 = predict_x0(img, time)
            h_prev, c_img, c_x0, w = _dpm_coefficients(acp, time, time_next, h_prev)
            d = x0 if w is None else w[0] * x0 - w[1] * x0_prev
            img = c_img * img - c_x0 * d
            img = impose(img, time_next) if matched else cond.apply(img)
            x0_prev = x0
    if final_step_grad:
        img = img.detach()
    final_ctx = torch.enable_grad() if final_step_grad else contextlib.nullcontext()
    with final_ctx:
        x0 = predict_x0(img, pairs[-1][0])
    # the intermediate impositions were noise-matched; the returned sample
    # still holds the conditions exactly
    return cond.apply(x0) if matched else x0


_SAMPLERS = {"ddim": ddim_sample, "dpm": dpm_solver_sample}


def sampler_draws(sampler: Callable, cfg: DiffusionConfig, shape, generator, device):
    """(init_noise, step_noise): the draws a call of `sampler` (`ddim_sample`,
    `dpm_solver_sample`, or `sample` and `ancestral_sample` with the
    guidance at x0 and no recurrence) takes from `generator`, drawn now in the order and shapes the
    sampler draws them, so that handing them in gives what the call would
    have drawn and leaves the generator where the call would."""
    if sampler is sample:
        sampler = ddim_sample if cfg.is_ddim else ancestral_sample
    if sampler is ddim_sample:
        n = len(_ddim_times(cfg)) - 1
    elif sampler is ancestral_sample:
        n = cfg.timesteps - 1
    elif sampler is dpm_solver_sample:
        n = len(_ddim_times(cfg)) if cfg.noise_matched_cond else 0
    else:
        raise ValueError(f"no draw count for sampler {sampler!r}")
    init = _initial_noise(shape, device, generator, None)
    return init, [pmesh.randn(shape, generator, dtype=torch.float32, device=device)
                  for _ in range(n)]


def get_sampler(name: str) -> Callable:
    """The test-time sampler a task config's `sampler` names: "ddim" or
    "dpm" (DPM-Solver++(2M))."""
    if name not in _SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; expected one of {sorted(_SAMPLERS)}")
    return _SAMPLERS[name]
