"""2D smoke pipelines: pretraining, then calibration, guided sampling and
solver evaluation, with post-training or InfFT epochs between them.

Port of `safediffcon_tpu/tasks/smoke/pipeline.py` (reference:
2d/ddpm/diffusion_2d.py:462-643 Trainer, 2d/inference_2d.py): `build_model`,
`init_params`, `SmokePipeline` (`calibrate`, `evaluate`, `reweights`),
`multistep_lr`, `pretrain`, `make_finetune_steps`, `run_inference` and
`run_inference_resilient` (CUDA fault handling, `utils/faults.py`).

Under an active mesh (`parallel/mesh.py`) every batch of calibrate,
evaluate and the training steps is split over the data ranks (each takes
its rows of the global batch and of the global random draws) and the
UNet3D splits its frames over the frame ranks; scores and weights are
gathered, so Q-hat is computed whole on every rank, and gradients are
reduced before each optimizer step.

The model's weights live in a torch module (load flax weights with
`models.convert.load_flax_params`, or seed them with `init_params`); training
updates them in place. The sampler of calibration, test sampling and InfFT
is the config's `sampler`: "ddim" or "dpm" (DPM-Solver++(2M)). Random draws
come from explicit `torch.Generator`s; `noise=` hands in the draws instead,
which is how the parity tests replay the JAX key chain: each training
micro-batch's (t, noise) and each sampler call's (init_noise, step_noise),
where step_noise is the noise of DDIM's stochastic steps and is empty for
DPM, which draws only its initial noise.
"""
from __future__ import annotations

import contextlib
import logging
import math
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from safediffcon_torch.core.conformal import normalize_weights, weighted_quantile
from safediffcon_torch.core.diffusion import DiffusionConfig, draw_t_noise, p_losses
from safediffcon_torch.core.sampling import draws_kw, get_sampler
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.core.train import (
    TrainState,
    accumulated_grads,
    make_optimizer,
    run_train_loop,
)
from safediffcon_torch.models.layers import lecun_normal_
from safediffcon_torch.models.unet3d import ConvTransposeCL, FusedConv3x3x3, UNet3D
from safediffcon_torch.parallel import mesh as pmesh
from safediffcon_torch.solvers import smoke as S
from safediffcon_torch.tasks.smoke.config import (
    SmokeConformalConfig,
    SmokeInferenceConfig,
    SmokePretrainConfig,
)
from safediffcon_torch.tasks.smoke.data import SmokeDataset
from safediffcon_torch.tasks.smoke.metrics import evaluate_samples, solver_rollout
from safediffcon_torch.tasks.smoke.task import (
    CX,
    CY,
    RESCALER,
    SAFE,
    SMOKE,
    SmokeConditioner,
    SmokeTaskConfig,
    backward_loss,
    conformal_score,
    guidance_grad_fn,
    rescaler,
    shift_weights,
    tile_rate_channels,
    train_conditioner,
)

log = logging.getLogger(__name__)

# One sampler call's draws: (init_noise, step_noise), in the sampler's order.
Noise = Tuple[torch.Tensor, list]
# One training micro-batch's draws: (timesteps (B,), noise like the batch).
TrainNoise = Tuple[torch.Tensor, torch.Tensor]


def build_model(dim=64, dim_mults=(1, 2, 4), compute_dtype=None, remat_policy="full",
                conv_impl="xla", attn_impl="packed", device="cuda") -> UNet3D:
    return UNet3D(dim=dim, dim_mults=dim_mults, channels=7, compute_dtype=compute_dtype,
                  remat_policy=remat_policy, conv_impl=conv_impl,
                  attn_impl=attn_impl).to(device)


@torch.no_grad()
def init_params(model: UNet3D, seed: int = 0) -> UNet3D:
    """Seeded init with flax's defaults: lecun-normal kernels, zero biases,
    unit norm scales, N(0, 1/heads) relative-position table. The draws come
    from a CPU generator, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv3d, ConvTransposeCL, FusedConv3x3x3)):
            w = module.weight
            lecun_normal_(w, w[0].numel(), gen)
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
        compute_dtype: Optional[str] = None,
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
        self.model = build_model(dim, dim_mults, compute_dtype, attn_impl=attn_impl,
                                 device=device).eval()
        self.sched = make_schedule(conf_cfg.timesteps, conf_cfg.beta_schedule,
                                   device=device)
        self.diff_cfg = DiffusionConfig(
            timesteps=conf_cfg.timesteps,
            sampling_timesteps=conf_cfg.ddim_sampling_steps,
            ddim_eta=conf_cfg.ddim_eta,
            beta_schedule=conf_cfg.beta_schedule,
        )
        # calibration takes the test sampler, or Q-hat loses its coverage
        # meaning for the deployed sampler
        self.sampler_fn = get_sampler(conf_cfg.sampler)
        self.masks = S.build_masks(device)
        self.solver_kw = dict(
            accuracy=solver_accuracy, max_iter=solver_max_iter,
            time_scale=solver_time_scale, space_scale=solver_space_scale,
            backend=S.resolve_backend(solver_backend),
        )
        # seconds per phase of `_evaluate` ("sampling", "rollout"), summed
        # over calls, when set to a dict; each phase then ends in a sync
        self.phase_seconds: Optional[Dict[str, float]] = None
        # when set to a dict, `calibrate` stores its per-sample scores and
        # raw weights there ("cal_scores", "cal_weights", on the CPU), and
        # `evaluate` each test sample's final smoke and safe rates, negated
        # smoke first, and the mean |c| of its sampled controls in the band
        # below the maze ("J_target", "safe_target", "band_control_abs":
        # lists of per-chunk tensors)
        self.record: Optional[Dict[str, object]] = None

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

    @torch.no_grad()
    def _cal_batch(self, state, Q, **sampler_kw):
        """Calibration: sample conditioned on (init density, control); score
        + weights (reference: 2d/inference_2d.py:113-148)."""
        cond = SmokeConditioner(init=state[:, 0, :, :, 0], control=state[..., CX : CY + 1])
        out = self.sampler_fn(self.apply_fn, self.sched, self.diff_cfg, state.shape,
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
        out = self.sampler_fn(self.apply_fn, self.sched, self.diff_cfg, state.shape,
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
        if self.record is not None:
            band = pred[:, :, : 16 // self.solver_kw["space_scale"], :, CX : CY + 1]
            for name, v in (("J_target", -sol[:, -1, 0, 0, SMOKE]),
                            ("safe_target", sol[:, -1, 0, 0, SAFE]),
                            ("band_control_abs", band.abs().mean(dim=(1, 2, 3, 4)))):
                self.record.setdefault(name, []).append(v.cpu())
        return evaluate_samples(pred, sol, Q, self.task_cfg.safe_bound)

    def calibrate(self, cal: SmokeDataset, Q, generator: Optional[torch.Generator] = None,
                  noise: Optional[Iterator[Noise]] = None) -> torch.Tensor:
        """Q-hat from the calibration split, with the inverted-alpha rank
        convention (reference: 2d/inference_2d.py:150-165). A split smaller
        than num_cal_batch * cal_batch_size is taken whole, as the Burgers and
        tokamak pipelines take theirs."""
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        bs = self.ccfg.cal_batch_size
        chunk = min(self.cal_chunk or bs, bs)
        n = len(cal)
        scores, weights = [], []
        for i in range(self.ccfg.num_cal_batch):
            for lo in range(0, bs, chunk):
                base = i * bs + lo
                if base >= n:  # cal set smaller than the configured batches
                    break
                sl = slice(base, min(base + chunk, n))
                sh = pmesh.batch_shard(sl.stop - sl.start)
                state = torch.as_tensor(sh.take(cal.data[sl]), device=self.device)
                s, w = self._cal_batch(state, Q, **draws_kw(noise, generator, sh))
                scores.append(sh.gather(s))
                weights.append(sh.gather(w))
        scores = torch.cat(scores)
        weights = torch.cat(weights)
        if self.record is not None:
            self.record.update(cal_scores=scores.cpu(), cal_weights=weights.cpu())
        weights = normalize_weights(weights)
        return weighted_quantile(weights * scores, self.ccfg.alpha, "one_minus_alpha")

    def reweights(self, data: SmokeDataset, Q) -> np.ndarray:
        """Per-sample train-shift weights exp(-ratio * guidance(x, Q)),
        normalized. The guidance reduces each record to two statistics (mean
        smoke rate over all frames, spatial-mean final-frame safe rate),
        computed once per dataset and cached on it."""
        stats = getattr(data, "_weight_stats", None)
        if stats is None:
            x = data.data
            smoke_mean = (x[..., SMOKE].mean(axis=(1, 2, 3), dtype=np.float32)
                          * RESCALER[SMOKE])
            safe_final = (x[:, -1, :, :, SAFE].mean(axis=(1, 2), dtype=np.float32)
                          * RESCALER[SAFE])
            stats = (smoke_mean, safe_final)
            data._weight_stats = stats
        smoke_mean, safe_final = stats
        tc = self.task_cfg
        g = -(1.0 - tc.w_safe) * smoke_mean + tc.w_safe * np.maximum(
            safe_final + float(Q) - tc.safe_bound, 0.0)
        w = torch.exp(-tc.standard_fixed_ratio * torch.as_tensor(g, dtype=torch.float32))
        return normalize_weights(w).numpy()

    def evaluate(self, test: SmokeDataset, Q, generator: Optional[torch.Generator] = None,
                 guided: Optional[bool] = None,
                 noise: Optional[Iterator[Noise]] = None) -> Dict[str, float]:
        """Metrics over the test split, chunked by `eval_chunk`; every metric
        is a per-sample mean, so the length-weighted mean over chunks equals
        the whole-batch value. Under a data mesh each rank samples and rolls
        out its rows of a chunk and the sums are all-reduced; K1 solves each
        group of 8 samples as one system, so a rank's rollout agrees with one
        process's within the solver's stopping test, not to the bit."""
        generator = generator or torch.Generator(device=self.device).manual_seed(0)
        guided = self.ccfg.use_guidance if guided is None else guided
        n = len(test.raw)
        chunk = min(self.eval_chunk or n, n)
        totals: Dict[str, float] = {}
        for lo in range(0, n, chunk):
            raw = np.asarray(test.raw[lo : lo + chunk])
            sh = pmesh.batch_shard(raw.shape[0])
            raw = torch.as_tensor(sh.take(raw), device=self.device)
            m = self._evaluate(raw, Q, guided=guided, **draws_kw(noise, generator, sh))
            # per-sample means over this rank's rows, summed over the ranks
            sums = sh.sum(torch.stack([v.double() for v in m.values()]) * raw.shape[0])
            for name, v in zip(m, sums.tolist()):
                totals[name] = totals.get(name, 0.0) + v
        return {name: v / n for name, v in totals.items()}


# ---------------------------------------------------------------------------
# Pretraining (reference: 2d/ddpm/diffusion_2d.py:462-643 Trainer)
# ---------------------------------------------------------------------------

def multistep_lr(base_lr: float, milestones, gamma: float):
    """torch MultiStepLR closed form (reference: diffusion_2d.py:520): the
    learning rate of the update count `count` (taken before its increment,
    as optax does) is base_lr * gamma^(number of milestones <= count)."""
    ms = np.asarray(sorted(milestones))

    def schedule(count: int) -> float:
        k = np.float32(np.searchsorted(ms, count, side="right"))
        return float(np.float32(base_lr) * np.float32(gamma) ** k)  # float32, as in JAX

    return schedule


def pretrain(
    cfg: SmokePretrainConfig,
    train_data: SmokeDataset,
    num_steps: Optional[int] = None,
    log_every: int = 500,
    checkpoint_dir: Optional[str] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    resume_dir: Optional[str] = None,
    steps_per_call: int = 1,
    device_pool: int = 0,
    pool_refresh_every: int = 0,
    deadline: Optional[float] = None,
    device="cuda",
    noise: Optional[Iterator[TrainNoise]] = None,
    losses: Optional[list] = None,
) -> TrainState:
    """Train the smoke UNet3D with the denoising loss; returns the
    TrainState (its `model` holds the trained weights, `ema_params` the EMA).

    `params` (a state_dict) starts from given weights, else `init_params`
    seeds them from cfg.seed. `resume_dir` restores step, weights, Adam
    moments and EMA from its latest checkpoint. Timesteps and noise come from
    a generator seeded with cfg.seed, or from `noise`, which yields each
    micro-batch's (t, noise) in order. `steps_per_call`, `device_pool`,
    `pool_refresh_every` and `losses`: see `run_train_loop`."""
    num_steps = num_steps or cfg.train_num_steps
    model = build_model(cfg.dim, cfg.dim_mults, cfg.compute_dtype, cfg.remat_policy,
                        cfg.conv_impl, cfg.attn_impl, device=device)
    if params is None:
        init_params(model, seed=cfg.seed)
    else:
        model.load_state_dict(params)
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.objective, device=device)
    dcfg = DiffusionConfig(timesteps=cfg.timesteps, objective=cfg.objective,
                           beta_schedule=cfg.beta_schedule)
    cond = train_conditioner()

    lr = multistep_lr(cfg.lr, cfg.lr_milestones, cfg.lr_gamma)
    tx = make_optimizer("adam", lr, betas=cfg.adam_betas, max_grad_norm=cfg.max_grad_norm)
    state = TrainState.create(model, tx, cfg.ema_decay, cfg.ema_update_every)
    start_step = 0
    if resume_dir is not None:
        from safediffcon_torch.utils.checkpoint import latest_step, load_checkpoint

        last = latest_step(resume_dir)
        if last is not None:
            state.load_state_dict(load_checkpoint(resume_dir, last))
            start_step = state.step
            log.info("resumed from %s step %d", resume_dir, start_step)

    accum = max(cfg.gradient_accumulate_every, 1)
    # each micro-batch split over the data ranks, and over the frame ranks
    # inside the UNet3D
    sh = pmesh.batch_shard(cfg.batch_size, frames=train_data.data.shape[1])
    generator = sh.generator(torch.Generator(device=device).manual_seed(cfg.seed))
    params_list = list(model.parameters())

    def loss_fn(i, batch):
        t, n = sh.draws(next(noise)) if noise is not None else draw_t_noise(dcfg, batch,
                                                                             generator)
        return p_losses(model, sched, dcfg, batch, t, n, cond).mean()

    def step_fn(state, batch):
        # batch: (accum * batch_size, ...) -> (accum, batch_size, ...)
        batches = batch.reshape(accum, -1, *batch.shape[1:])
        loss, grads = sh.reduce(*accumulated_grads(loss_fn, params_list, batches))
        state.apply_gradients(grads)
        return loss

    return run_train_loop(
        step_fn, state, train_data.data,
        batch_take=cfg.batch_size * accum, num_steps=num_steps, start_step=start_step,
        seed=cfg.seed, steps_per_call=steps_per_call, log_every=log_every,
        checkpoint_every=cfg.checkpoint_every, checkpoint_dir=checkpoint_dir, logger=log,
        log_prefix="smoke pretrain", device_pool=device_pool,
        pool_refresh_every=pool_refresh_every, deadline=deadline, losses=losses, shard=sh,
    )


# ---------------------------------------------------------------------------
# Unified inference pipeline (posttrain or backward finetune)
# ---------------------------------------------------------------------------

def make_finetune_steps(cfg: SmokeInferenceConfig, pipeline: SmokePipeline):
    """The fine-tuning steps `run_inference` takes, on `pipeline.model`'s
    weights in place. Returns `(tx, weighted_step, backward_step)`:

      weighted_step(opt_state, batch, w, generator=None, noise=None) -> loss
          post-training: the denoising loss weighted per sample by w;
          noise = (t, noise) of the batch, else drawn from `generator`.
      backward_step(opt_state, test_batch, Q, generator=None, noise=None) -> loss
          InfFT: a guided sample without gradients, then a resample
          conditioned on its control with gradients through the final step
          only, then the backward loss (reference: 2d/inference_2d.py:197-237,
          267-284); noise = the two sampler calls' (init_noise, step_noise).

    Adam(finetune_lr, betas (0.9, 0.99)), no clipping, no EMA (reference:
    2d/inference_2d.py:79). JAX's `weighted_step_pool` is `weighted_step` on
    a batch gathered from `run_inference`'s device pool."""
    ccfg = cfg.conformal
    tc = pipeline.task_cfg
    sched = pipeline.sched
    dcfg_train = DiffusionConfig(timesteps=ccfg.timesteps, beta_schedule=ccfg.beta_schedule)
    cond_train = train_conditioner()
    tx = make_optimizer("adam", cfg.finetune_lr, betas=(0.9, 0.99), max_grad_norm=0.0)
    params = list(pipeline.model.parameters())

    def weighted_step(opt_state, batch, w, generator=None, noise=None):
        sh = pmesh.batch_shard(batch.shape[0], frames=batch.shape[1])
        batch, w = sh.take(batch), sh.take(w)
        t, n = (sh.draws(noise) if noise is not None
                else draw_t_noise(dcfg_train, batch, sh.generator(generator)))
        per = p_losses(pipeline.apply_fn, sched, dcfg_train, batch, t, n, cond_train)
        loss = (w * per).mean()
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
        tx.step(params, grads, opt_state)
        return loss

    def backward_step(opt_state, test_batch, Q, generator=None, noise=None):
        sh = pmesh.batch_shard(test_batch.shape[0], frames=test_batch.shape[1])
        test_batch = sh.take(test_batch)
        draws = iter(noise) if noise is not None else None
        init = test_batch[:, 0, :, :, 0]
        g = guidance_grad_fn(Q, tc) if ccfg.use_guidance else None
        sampler = pipeline.sampler_fn
        with torch.no_grad():
            first = sampler(pipeline.apply_fn, sched, pipeline.diff_cfg, test_batch.shape,
                            cond=SmokeConditioner(init=init), guidance_grad=g,
                            **draws_kw(draws, generator, sh))
        control = first[..., CX : CY + 1]
        out = sampler(pipeline.apply_fn, sched, pipeline.diff_cfg, test_batch.shape,
                      cond=SmokeConditioner(init=init, control=control),
                      final_step_grad=True, **draws_kw(draws, generator, sh))
        out = torch.cat([out[..., :CX], control, out[..., CY + 1 :]], dim=-1)
        loss = backward_loss(out * rescaler(out), Q, tc)
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
        tx.step(params, grads, opt_state)
        return loss

    return tx, weighted_step, backward_step


def run_inference(
    cfg: SmokeInferenceConfig,
    pipeline: SmokePipeline,
    params: Optional[Mapping[str, torch.Tensor]],
    train_data: Optional[SmokeDataset],
    cal_data: SmokeDataset,
    test_data: SmokeDataset,
    on_epoch=None,
    deadline: Optional[float] = None,
    state_dir: Optional[str] = None,
    noise: Optional[Iterator] = None,
):
    """Reference run() loop (2d/inference_2d.py:286-368): per epoch
    fine-tune (posttrain, or InfFT with `backward_finetune`) -> recalibrate
    Q-hat -> evaluate. Returns (state_dict, Q, epoch records).

    `params` (a state_dict, or None for the model's current weights) is
    loaded into `pipeline.model`, which the epochs train in place.
    `on_epoch(record)` fires after each epoch; `deadline` (time.time()
    seconds) stops starting new epochs. `state_dir` persists (weights, Adam
    moments, Q-hat) and the records after every epoch and resumes from the
    latest saved epoch, bit-identically to an uninterrupted run. `noise`
    yields, in the order they are consumed, each post-training step's
    (t, noise) or each InfFT step's two sampler calls' draws (a pair), then
    each calibrate and evaluate sampler call's (init_noise, step_noise).

    With `cfg.device_pool` > 0, post-training draws a pool of min(pool, n)
    train sims per epoch (`default_rng(seed + 31 + epoch)`, as JAX), holds
    them on the device in bfloat16 with their reweights, and gathers each
    batch there by index, cast to float32; the pool is freed before the
    epoch's calibrate and evaluate."""
    from safediffcon_torch.utils.checkpoint import (
        load_phase_history, load_phase_state, save_phase_history, save_phase_state,
    )

    ccfg = cfg.conformal
    model = pipeline.model
    if params is not None:
        model.load_state_dict(params)
    tx, weighted_step, backward_step = make_finetune_steps(cfg, pipeline)
    opt_state = tx.init(list(model.parameters()))
    device = pipeline.device
    Q = torch.zeros((), device=device)
    start_epoch = 0
    history = []
    if state_dir is not None:
        restored = load_phase_state(state_dir)
        if restored is not None:
            sd, opt_sd, q, last_epoch = restored
            model.load_state_dict(sd)
            opt_state.load_state_dict(opt_sd)
            Q = torch.tensor(q, dtype=torch.float32, device=device)
            start_epoch = last_epoch + 1
            history = load_phase_history(state_dir, max_epoch=last_epoch,
                                         config_repr=repr(cfg))
            log.info("smoke finetune: resumed phase state after epoch %d from %s",
                     last_epoch, state_dir)
    if on_epoch is not None:
        for rec in history:  # restored records, so external result files converge
            on_epoch(rec)

    stage: Dict[str, object] = {}  # pool staging buffers, allocated once

    def draw_pool(epoch: int, w_all: np.ndarray):
        n = len(train_data)
        pool = min(cfg.device_pool, n)
        ids = np.random.default_rng(cfg.seed + 31 + epoch).choice(n, pool, replace=False)
        if not stage:
            shape = (pool,) + train_data.data.shape[1:]
            stage["f32"] = np.empty(shape, np.float32)
            stage["bf16"] = torch.empty(shape, dtype=torch.bfloat16,
                                        pin_memory=device.type == "cuda")
        np.take(np.asarray(train_data.data), ids, axis=0, out=stage["f32"])
        stage["bf16"].copy_(torch.from_numpy(stage["f32"]))  # round to nearest even
        log.info("smoke finetune: pinned %d/%d samples (%.2f GB bf16) on device",
                 pool, n, stage["bf16"].nbytes / 1e9)
        return (stage["bf16"].to(device, non_blocking=True),
                torch.as_tensor(w_all[ids], device=device))

    for epoch in range(start_epoch, cfg.finetune_epoch):
        if deadline is not None and time.time() > deadline:
            log.info("smoke finetune: deadline reached before epoch %d, returning %d "
                     "completed epochs", epoch, len(history))
            break
        # the epoch's draws depend on (seed, epoch) only, so a resumed run
        # draws what an uninterrupted one does (JAX: fold_in(key, epoch))
        gen = torch.Generator(device=device).manual_seed(cfg.seed * 1_000_003 + epoch)
        losses = []
        if cfg.backward_finetune:
            for lo in range(0, len(test_data), ccfg.test_batch_size):
                batch = torch.as_tensor(test_data.data[lo : lo + ccfg.test_batch_size],
                                        device=device)
                for _ in range(cfg.finetune_steps):
                    draws = next(noise) if noise is not None else None
                    losses.append(backward_step(opt_state, batch, Q, gen, draws))
        else:
            w_train = pipeline.reweights(train_data, Q)
            if cfg.device_pool:
                # re-drawn per epoch (the weights change with Q anyway), so
                # every sim is eventually trained on
                data_dev, w_dev = draw_pool(epoch, w_train)
                m = data_dev.shape[0]
            else:
                m = len(train_data)
            pos = 0
            for _ in range(cfg.finetune_steps):
                sel = np.arange(pos, pos + cfg.finetune_batch_size) % m
                pos = (pos + cfg.finetune_batch_size) % m
                if cfg.device_pool:  # only the (B,) indices cross to the device
                    idx = torch.as_tensor(sel, device=device)
                    batch, w = data_dev[idx].float(), w_dev[idx]
                else:
                    batch = torch.as_tensor(train_data.data[sel], device=device)
                    w = torch.as_tensor(w_train[sel], device=device)
                draws = next(noise) if noise is not None else None
                losses.append(weighted_step(opt_state, batch, w, gen, draws))
            if cfg.device_pool:
                # free the pool before the sampling-heavy calibrate / evaluate
                data_dev = w_dev = batch = w = None

        losses = [float(v) for v in losses]  # one sync per epoch
        Q = pipeline.calibrate(cal_data, Q, generator=gen, noise=noise)
        log.info("smoke epoch %d calibrated Q %.5f", epoch, float(Q))
        metrics = pipeline.evaluate(test_data, Q, generator=gen, noise=noise)
        loss = float(np.mean(losses)) if losses else None
        log.info("smoke epoch %d Q %.5f loss %s metrics %s", epoch, float(Q), loss, metrics)
        history.append({"epoch": epoch, "quantile": float(Q), "loss": loss, "eval": metrics})
        # persist state and history before the callback: a crash between them
        # then re-fires the callback on resume instead of losing the record
        if state_dir is not None:
            save_phase_state(state_dir, model.state_dict(), opt_state, Q, epoch)
            save_phase_history(state_dir, history, config_repr=repr(cfg))
        if on_epoch is not None:
            on_epoch(history[-1])
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return params, Q, history


def run_inference_resilient(
    cfg: SmokeInferenceConfig,
    make_pipeline,
    params: Optional[Mapping[str, torch.Tensor]],
    train_data: Optional[SmokeDataset],
    cal_data: SmokeDataset,
    test_data: SmokeDataset,
    on_epoch=None,
    deadline: Optional[float] = None,
    state_dir: Optional[str] = None,
    fault_retries: int = 2,
    backoff_s: float = 30.0,
):
    """`run_inference` with device-fault handling (`utils/faults.py`): the
    weights are copied to the host once, each attempt builds a fresh pipeline
    from `make_pipeline()` and resumes from the last epoch in `state_dir`; a
    recoverable CUDA fault is retried up to `fault_retries` times, a sticky
    one re-raised at once (a new process resumes from `state_dir`)."""
    from safediffcon_torch.utils.faults import resilient_phase

    return resilient_phase(
        make_pipeline,
        lambda pipe, p: run_inference(cfg, pipe, p, train_data, cal_data, test_data,
                                      on_epoch=on_epoch, deadline=deadline,
                                      state_dir=state_dir),
        params, retries=fault_retries, backoff_s=backoff_s, describe="smoke finetune",
        state_dir=state_dir)
