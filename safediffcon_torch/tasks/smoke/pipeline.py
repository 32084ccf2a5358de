"""2D smoke serving pipeline: calibration, guided sampling, solver evaluation.

Port of `build_model`, `init_params` and `SmokePipeline` (`calibrate`,
`evaluate`, `_sample_test`, `_evaluate`) of
`safediffcon_tpu/tasks/smoke/pipeline.py` (reference: 2d/inference_2d.py).
Pretraining, post-training and InfFT are the training slice.

The model's weights live in `SmokePipeline.model` (load flax weights with
`models.convert.load_flax_params`, or seed them with `init_params`). Random
draws come from an explicit `torch.Generator`; `noise=` hands in each sampler
call's (init_noise, step_noise) instead, which is how the parity tests replay
the JAX key chain.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from safediffcon_torch.core.conformal import normalize_weights, weighted_quantile
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.sampling import ddim_sample
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.models.unet3d import ConvTransposeCL, UNet3D
from safediffcon_torch.solvers import smoke as S
from safediffcon_torch.tasks.smoke.config import SmokeConformalConfig
from safediffcon_torch.tasks.smoke.data import SmokeDataset
from safediffcon_torch.tasks.smoke.metrics import evaluate_samples, solver_rollout
from safediffcon_torch.tasks.smoke.task import (
    CX,
    CY,
    SmokeConditioner,
    SmokeTaskConfig,
    conformal_score,
    guidance_grad_fn,
    rescaler,
    shift_weights,
    tile_rate_channels,
)

# One sampler call's noise: (init_noise, [noise of each stochastic step]).
Noise = Tuple[torch.Tensor, list]


def build_model(dim=64, dim_mults=(1, 2, 4), conv_impl="xla", attn_impl="packed",
                device="cuda") -> UNet3D:
    return UNet3D(dim=dim, dim_mults=dim_mults, channels=7, conv_impl=conv_impl,
                  attn_impl=attn_impl).to(device)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to +-2 std, rescaled to
    variance 1/fan_in; drawn by inverse CDF on the CPU generator."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    w.copy_((z * math.sqrt(1.0 / fan_in) / 0.87962566103423978).to(w.dtype))


@torch.no_grad()
def init_params(model: UNet3D, seed: int = 0) -> UNet3D:
    """Seeded init with flax's defaults: lecun-normal kernels, zero biases,
    unit norm scales, N(0, 1/heads) relative-position table. The draws come
    from a CPU generator, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv3d, ConvTransposeCL)):
            w = module.weight
            _lecun_normal_(w, w[0].numel(), gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            z = torch.randn(module.weight.shape, generator=gen)
            module.weight.copy_(z / math.sqrt(module.weight.shape[1]))
    return model


class SmokePipeline:
    """Calibration, sampling and solver evaluation for the smoke task."""

    def __init__(
        self,
        conf_cfg: SmokeConformalConfig,
        dim: int = 64,
        dim_mults=(1, 2, 4),
        attn_impl: str = "packed",
        solver_accuracy: float = 1e-8,  # reference eval CG tolerance
        solver_max_iter: int = 500,
        solver_time_scale: int = 8,
        solver_space_scale: int = 2,
        solver_backend: str = "auto",  # "auto" -> "pallas_v1" (kernel K1)
        finetune_set: str = "train",
        cal_chunk: Optional[int] = 50,
        # Evaluation sub-batch. The JAX default of 10 fitted the 64^2
        # temporal-attention scores, (B*4096, 4, 32, 32) f32 = 67 MB per
        # sample, into a 15.75 GB chip. On an 80 GB H100, guided evaluate
        # of the reference model at B=50 peaks at 36.5 GB and calibrate at
        # 36.3 GB (chip_smoke.py), so the whole reference test set runs as
        # one chunk, which gives the pressure-CG kernel 7 blocks (one per 8
        # samples) instead of 2.
        eval_chunk: Optional[int] = 50,
        device="cuda",
    ):
        if conf_cfg.sampler != "ddim":
            raise NotImplementedError(f"sampler {conf_cfg.sampler!r} is not ported yet")
        self.ccfg = conf_cfg
        self.device = torch.device(device)
        self.cal_chunk = cal_chunk
        self.eval_chunk = eval_chunk
        self.task_cfg = SmokeTaskConfig(
            safe_bound=conf_cfg.safe_bound,
            w_safe=conf_cfg.w_safe,
            standard_fixed_ratio=conf_cfg.standard_fixed_ratio,
            finetune_standard_fixed_ratio=conf_cfg.finetune_standard_fixed_ratio,
            alpha=conf_cfg.alpha,
        )
        self.finetune_set = finetune_set
        self.model = build_model(dim, dim_mults, attn_impl=attn_impl, device=device).eval()
        self.sched = make_schedule(conf_cfg.timesteps, conf_cfg.beta_schedule,
                                   device=device)
        self.diff_cfg = DiffusionConfig(
            timesteps=conf_cfg.timesteps,
            sampling_timesteps=conf_cfg.ddim_sampling_steps,
            ddim_eta=conf_cfg.ddim_eta,
            beta_schedule=conf_cfg.beta_schedule,
        )
        self.masks = S.build_masks(device)
        self.solver_kw = dict(
            accuracy=solver_accuracy, max_iter=solver_max_iter,
            time_scale=solver_time_scale, space_scale=solver_space_scale,
            backend=S.resolve_backend(solver_backend),
        )
        # seconds per phase of `_evaluate` ("sampling", "rollout"), summed
        # over calls, when set to a dict; each phase then ends in a sync
        self.phase_seconds: Optional[Dict[str, float]] = None

    def apply_fn(self, x, t):
        return self.model(x, t)

    @contextlib.contextmanager
    def _phase(self, name: str):
        if self.phase_seconds is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + time.perf_counter() - t0

    def _sampler_kw(self, noise: Optional[Iterator[Noise]], generator) -> dict:
        if noise is None:
            return dict(generator=generator)
        init_noise, step_noise = next(noise)
        return dict(init_noise=init_noise, step_noise=step_noise)

    @torch.no_grad()
    def _cal_batch(self, state, Q, **sampler_kw):
        """Calibration: sample conditioned on (init density, control); score
        + weights (reference: 2d/inference_2d.py:113-148)."""
        cond = SmokeConditioner(init=state[:, 0, :, :, 0], control=state[..., CX : CY + 1])
        out = ddim_sample(self.apply_fn, self.sched, self.diff_cfg, state.shape,
                          cond=cond, **sampler_kw)
        scores = conformal_score(out, state)
        w = shift_weights(state, Q, self.task_cfg, "train")
        if self.finetune_set == "test":
            w = w * shift_weights(state, Q, self.task_cfg, "test")
        return scores, w

    @torch.no_grad()
    def _sample_test(self, state, Q, guided=True, control=None, **sampler_kw):
        """Test sampling conditioned on the initial density; returns the
        PHYSICAL-unit prediction with tiled rate channels
        (reference: run_model, 2d/inference_2d.py:197-237)."""
        cond = SmokeConditioner(init=state[:, 0, :, :, 0], control=control)
        g = guidance_grad_fn(Q, self.task_cfg) if guided else None
        out = ddim_sample(self.apply_fn, self.sched, self.diff_cfg, state.shape,
                          cond=cond, guidance_grad=g, **sampler_kw)
        if control is not None:  # post-loop control re-imposition (diffusion_2d.py:400-402)
            out[..., CX : CY + 1] = control
        return tile_rate_channels(out * rescaler(out))

    @torch.no_grad()
    def _evaluate(self, state_raw, Q, guided=True, **sampler_kw) -> Dict[str, torch.Tensor]:
        """Sample -> solver rollout -> metrics
        (reference: 2d/inference_2d.py:336-368,407-507)."""
        state = state_raw / rescaler(state_raw)
        with self._phase("sampling"):
            pred = self._sample_test(state, Q, guided=guided, **sampler_kw)
        pred[:, 0, :, :, 0] = state_raw[:, 0, :, :, 0]
        with self._phase("rollout"):
            sol = solver_rollout(self.masks, pred, state_raw, **self.solver_kw)
        return evaluate_samples(pred, sol, Q, self.task_cfg.safe_bound)

    def calibrate(self, cal: SmokeDataset, Q, generator: Optional[torch.Generator] = None,
                  noise: Optional[Iterator[Noise]] = None) -> torch.Tensor:
        """Q-hat from the calibration split, with the inverted-alpha rank
        convention (reference: 2d/inference_2d.py:150-165)."""
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        bs = self.ccfg.cal_batch_size
        chunk = min(self.cal_chunk or bs, bs)
        scores, weights = [], []
        for i in range(self.ccfg.num_cal_batch):
            for lo in range(0, bs, chunk):
                sl = slice(i * bs + lo, i * bs + lo + chunk)
                state = torch.as_tensor(cal.data[sl], device=self.device)
                s, w = self._cal_batch(state, Q, **self._sampler_kw(noise, generator))
                scores.append(s)
                weights.append(w)
        scores = torch.cat(scores)
        weights = normalize_weights(torch.cat(weights))
        return weighted_quantile(weights * scores, self.ccfg.alpha, "one_minus_alpha")

    def evaluate(self, test: SmokeDataset, Q, generator: Optional[torch.Generator] = None,
                 guided: Optional[bool] = None,
                 noise: Optional[Iterator[Noise]] = None) -> Dict[str, float]:
        """Metrics over the test split, chunked by `eval_chunk`; every metric
        is a per-sample mean, so the length-weighted mean over chunks equals
        the whole-batch value."""
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        guided = self.ccfg.use_guidance if guided is None else guided
        n = len(test.raw)
        chunk = min(self.eval_chunk or n, n)
        totals: Dict[str, float] = {}
        for lo in range(0, n, chunk):
            raw = torch.as_tensor(np.asarray(test.raw[lo : lo + chunk]), device=self.device)
            m = self._evaluate(raw, Q, guided=guided, **self._sampler_kw(noise, generator))
            k = raw.shape[0]
            for name, v in m.items():
                totals[name] = totals.get(name, 0.0) + float(v) * k
        return {name: v / n for name, v in totals.items()}
