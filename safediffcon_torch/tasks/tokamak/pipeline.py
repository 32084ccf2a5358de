"""Tokamak pipelines: pretrain, calibration, evaluation, and the unified
post-train / backward-finetune loop.

Port of `safediffcon_tpu/tasks/tokamak/pipeline.py` (reference:
tokamak/inference/pipeline.py:21-465, tokamak/model/trainer.py):
`build_model`, `init_params`, `TokamakPipeline` (`calibrate`, `reweights`,
`evaluate`), `pretrain`, `run_inference` with the steps it takes
(`make_finetune_steps`), and `run_inference_resilient` (CUDA fault handling,
`utils/faults.py`).

Per reference semantics (run_epoch, pipeline.py:270-323), every epoch of
`run_inference` FIRST recalibrates Q-hat, then either
  - posttrain mode: weighted diffusion-loss steps on train batches, with
    weights exp(-guidance_loss * scaler) over the whole train split, or
  - backward-finetune mode (InfFT): guided sampling of the test set with
    gradients through the final denoise step, minimizing the
    objective+safety loss of the samples w.r.t. the weights,
then evaluates by rolling the diffused actions through the KSTAR surrogate.
The optimizer is the config's `optimizer`: plain Adam(0.99, 0.999) by
default, or SGD with momentum 0.9, with no EMA and no grad clip (reference:
tokamak/inference/pipeline.py:150-163).

Weights are passed as `params`, a state_dict of the UNet1D (the pipeline
runs its model on them through `torch.func.functional_call`), or None for
the pipeline model's own weights. Random draws come from explicit
`torch.Generator`s; `noise=` hands in the draws instead, in the order the
code consumes them, which is how the parity tests replay the JAX key chain:
each training step's (t, noise) and each sampler call's (init_noise,
step_noise), where step_noise is the noise of DDIM's stochastic steps and
is empty for DPM. Calibration, test sampling and InfFT take the config's
`sampler`: "ddim" or "dpm" (DPM-Solver++(2M)).

Under an active mesh (`parallel/mesh.py`) every batch of calibrate,
evaluate and the training steps is split over the data ranks: each takes
its rows of the global batch and of the global random draws, scores,
weights, samples and rollouts are gathered (Q-hat and the metrics are
computed whole on every rank), and gradients are averaged before each
optimizer step. `reweights` stays whole on every rank.

On a CUDA pipeline (`capture`, on by default), each
calibration batch, each evaluation (sampling, the KSTAR rollout and the
metrics) and each post-training and backward fine-tuning step of
`run_inference` is one captured CUDA graph, as in the Burgers pipeline
(`tasks/burgers/pipeline.py`): static inputs refilled before each replay,
the draws taken ahead of the call as it would take them, the first call
of each graph eager; the same results bit for bit. A batch split over the
ranks of an NCCL group is captured with its gathers and gradient
all-reduce; CPU pipelines and a batch split over gloo ranks run eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from safediffcon_torch.core.conformal import normalize_weights, weighted_quantile
from safediffcon_torch.core.diffusion import DiffusionConfig, draw_t_noise, p_losses
from safediffcon_torch.core.sampling import draws_kw, get_sampler, sampler_draws
from safediffcon_torch.core.schedules import get_J_scheduler, make_schedule
from safediffcon_torch.core.train import (
    Graphs,
    TrainState,
    _fill,
    accumulated_grads,
    make_optimizer,
    periodic_cosine_schedule,
    run_train_loop,
)
from safediffcon_torch.models.layers import Conv1dCL, Linear, lecun_normal_
from safediffcon_torch.models.unet1d import UNet1D
from safediffcon_torch.parallel import mesh as pmesh
from safediffcon_torch.solvers.kstar import load_kstar_params
from safediffcon_torch.tasks.tokamak.config import (
    TokamakConformalConfig,
    TokamakInferenceConfig,
    TokamakPretrainConfig,
)
from safediffcon_torch.tasks.tokamak.data import TokamakDataset
from safediffcon_torch.tasks.tokamak.metrics import control_trajectories, evaluate_samples
from safediffcon_torch.tasks.tokamak.task import (
    TokamakTaskConfig,
    backward_loss,
    conformal_score,
    guidance_grad_fn,
    sampling_conditioner,
    scaler,
    shift_weights,
    train_conditioner,
)

log = logging.getLogger(__name__)

Params = Optional[Mapping[str, torch.Tensor]]
# One sampler call's draws: (init_noise, step_noise), in the sampler's order.
Noise = Tuple[torch.Tensor, list]
# One training step's draws: (timesteps (B,), noise like the batch).
TrainNoise = Tuple[torch.Tensor, torch.Tensor]


def build_model(dim=128, dim_mults=(1, 2, 4, 8), groups=1, compute_dtype=None,
                device="cuda") -> UNet1D:
    return UNet1D(dim=dim, dim_mults=dim_mults, channels=12, resnet_block_groups=groups,
                  compute_dtype=compute_dtype).to(device)


@torch.no_grad()
def init_params(model: UNet1D, seed: int = 0) -> UNet1D:
    """Seeded init with flax's defaults: lecun-normal kernels, zero biases,
    unit norm scales. The draws come from a CPU generator, so a seed gives
    the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (Linear, Conv1dCL)):
            w = module.weight
            lecun_normal_(w, w[0].numel(), gen)
            if module.bias is not None:
                module.bias.zero_()
    return model


class TokamakPipeline:
    """Calibration, sampling and surrogate evaluation for the tokamak task;
    the state the fine-tuning phases share."""

    def __init__(
        self,
        conf_cfg: TokamakConformalConfig,
        dim: int = 128,
        dim_mults=(1, 2, 4, 8),
        groups: int = 1,
        compute_dtype: Optional[str] = None,
        # calibration sub-batch; scores and weights are per sample, so any
        # chunking gives the same Q-hat. The JAX default of 50 is kept; on
        # the card the reference's whole batch of 1,000 runs as one chunk
        # (chip_smoke.py).
        cal_chunk: Optional[int] = 50,
        device="cuda",
        # calibration batches, evaluations and run_inference's steps as
        # captured CUDA graphs on a CUDA device (module docstring); False
        # runs them eagerly, with the same results
        capture: bool = True,
    ):
        self.ccfg = conf_cfg
        self.device = torch.device(device)
        self.cal_chunk = cal_chunk
        self.graphs = Graphs(self.device, capture, "tokamak pipeline")
        self.task_cfg = TokamakTaskConfig(
            safety_threshold=conf_cfg.safety_threshold,
            w_obj=conf_cfg.w_obj,
            w_safe=conf_cfg.w_safe,
            guidance_scaler=conf_cfg.guidance_scaler,
            alpha=conf_cfg.alpha,
        )
        self.model = build_model(dim, dim_mults, groups, compute_dtype, device=device).eval()
        self.sched = make_schedule(conf_cfg.timesteps, "cosine", device=device)
        self.diff_cfg = DiffusionConfig(
            timesteps=conf_cfg.timesteps,
            sampling_timesteps=conf_cfg.ddim_sampling_steps,
            ddim_eta=conf_cfg.ddim_eta,
            beta_schedule="cosine",
        )
        self.j_scheduler = get_J_scheduler(conf_cfg.J_scheduler)
        # calibration takes the test sampler, or Q-hat loses its coverage
        # meaning for the deployed sampler
        self.sampler_fn = get_sampler(conf_cfg.sampler)
        self.solver_params = load_kstar_params(device=device)
        # seconds per phase of `_evaluate` ("sampling", "rollout"), summed
        # over calls, when set to a dict; each phase then ends in a sync
        self.phase_seconds: Optional[Dict[str, float]] = None
        # when set to a dict, `calibrate` stores its per-sample scores and
        # raw weights there ("cal_scores", "cal_weights", on the CPU)
        self.record: Optional[Dict[str, torch.Tensor]] = None

    def apply_fn(self, params: Params = None):
        """The denoiser (x, t) -> output on `params` (None: the model's own)."""
        if params is None:
            return self.model
        return lambda x, t: functional_call(self.model, params, (x, t))

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

    def _generator(self, generator):
        return generator or torch.Generator(device=self.device).manual_seed(0)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ---- captured calls --------------------------------------------------

    def _weights(self, params: Params) -> dict:
        """The weights a call binds, as a static input (None: the model's own)."""
        return dict(self.model.named_parameters()) if params is None else dict(params)

    def _draws(self, shape, noise, generator):
        """A captured call's (init_noise, step_noise): the next of `noise`,
        else drawn from `generator` as the sampler would draw them."""
        if noise is not None:
            return next(noise)
        return sampler_draws(self.sampler_fn, self.diff_cfg, shape, generator, self.device)

    # ---- conformal calibration -------------------------------------------

    @torch.no_grad()
    def _cal_batch(self, params: Params, state, state_target, Q, **sampler_kw):
        """Calibration batch: sample conditioned on the ground-truth actions,
        u0 and the full (βp, li) trajectories; score and weight (reference:
        tokamak/inference/conformal.py:34-117)."""
        ccfg, tc = self.ccfg, self.task_cfg
        out = self.sampler_fn(self.apply_fn(params), self.sched, self.diff_cfg, state.shape,
                              cond=sampling_conditioner(state, actions=True), **sampler_kw)
        scores = conformal_score(out, state)
        weights = shift_weights(state, state_target, Q, tc)
        # composite weight factors (reference: tokamak/inference/conformal.py:84-100):
        # train mode with guidance squares the factor; test mode after
        # post-training multiplies a factor at the posttrain checkpoint's
        # quantile and guidance hyperparameters
        if ccfg.finetune_set == "train" and ccfg.use_guidance:
            weights = weights * shift_weights(state, state_target, Q, tc)
        if (ccfg.finetune_set == "test" and not ccfg.wo_post_train
                and ccfg.finetune_quantile is not None):
            tc_ft = dataclasses.replace(tc, w_obj=ccfg.finetune_w_obj,
                                        w_safe=ccfg.finetune_w_safe,
                                        guidance_scaler=ccfg.finetune_guidance_scaler)
            weights = weights * shift_weights(state, state_target, ccfg.finetune_quantile, tc_ft)
        return scores, weights

    def calibrate(self, params: Params, cal: TokamakDataset, Q,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Iterator[Noise]] = None) -> torch.Tensor:
        """Q-hat over `num_cal_batch` batches of `cal_batch_size` of the
        calibration split, sampled in chunks of `cal_chunk`, weights
        multiplying the scores, "alpha" rank convention (reference:
        tokamak/inference/conformal.py)."""
        generator = self._generator(generator)
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
                if self.graphs.on(sh):
                    # the whole chunk and its draws: the graph takes this
                    # rank's rows and gathers every rank's scores and weights
                    init, steps = self._draws(cal.data[sl].shape, noise, generator)
                    s, w = self.graphs(
                        "cal", lambda state, target, Q, init, steps, w: tuple(map(
                            sh.gather, sh.local(functools.partial(self._cal_batch, w), state,
                                                target, draws=(init, steps), Q=Q))),
                        state=cal.data[sl], target=cal.state_phys[sl], Q=Q, init=init,
                        steps=steps, w=self._weights(params))
                else:
                    s, w = map(sh.gather, self._cal_batch(
                        params, self._tensor(sh.take(cal.data[sl])),
                        self._tensor(sh.take(cal.state_phys[sl])), Q,
                        **draws_kw(noise, generator, sh)))
                scores.append(s)
                weights.append(w)
        scores, weights = torch.cat(scores), torch.cat(weights)
        if self.record is not None:
            self.record.update(cal_scores=scores.cpu(), cal_weights=weights.cpu())
        return weighted_quantile(normalize_weights(weights) * scores, self.ccfg.alpha)

    # ---- reweights over a split ------------------------------------------

    @torch.no_grad()
    def reweights(self, data: TokamakDataset, Q, batch_size: int = 4096) -> np.ndarray:
        """Normalized per-sample shift weights of a split."""
        ws = [shift_weights(self._tensor(data.data[lo : lo + batch_size]),
                            self._tensor(data.state_phys[lo : lo + batch_size]), Q,
                            self.task_cfg)
              for lo in range(0, len(data), batch_size)]
        return normalize_weights(torch.cat(ws)).cpu().numpy()

    # ---- sampling and evaluation -----------------------------------------

    def _sample_test(self, params: Params, state, state_target, Q, guided: bool = False,
                     final_step_grad: bool = False, **sampler_kw) -> torch.Tensor:
        """Test sampling conditioned on (u0, target trajectories); returns
        PHYSICAL-unit predictions (reference: tokamak/inference/pipeline.py:381-407)."""
        g = guidance_grad_fn(state_target, Q, self.task_cfg) if guided else None
        out = self.sampler_fn(self.apply_fn(params), self.sched, self.diff_cfg, state.shape,
                              cond=sampling_conditioner(state), guidance_grad=g,
                              j_scheduler=self.j_scheduler, final_step_grad=final_step_grad,
                              **sampler_kw)
        return out * scaler(out)

    @torch.no_grad()
    def _evaluate(self, params: Params, state, state_target, Q, guided=False,
                  sh: Optional[pmesh.BatchShard] = None, timed: bool = True,
                  **sampler_kw) -> Dict[str, torch.Tensor]:
        """Sample -> surrogate rollout -> metrics (reference:
        tokamak/inference/pipeline.py:325-359). Under a data-parallel shard
        `sh`, `state` and `state_target` are this rank's rows: the samples
        and their rollouts are gathered, and the metrics of the whole batch
        computed on every rank. `timed`: time the two phases (not inside a
        captured graph)."""
        phase = self._phase if timed else (lambda name: contextlib.nullcontext())
        with phase("sampling"):
            pred = self._sample_test(params, state, state_target, Q, guided=guided,
                                     **sampler_kw)
        with phase("rollout"):
            controlled = control_trajectories(self.solver_params, pred)
        if sh is not None:
            pred, controlled = sh.gather(pred), sh.gather(controlled)
            state_target = sh.gather(state_target)
        return evaluate_samples(pred, controlled, state_target, self.task_cfg.safety_threshold)

    def evaluate(self, params: Params, test: TokamakDataset, Q,
                 generator: Optional[torch.Generator] = None, guided: Optional[bool] = None,
                 noise: Optional[Iterator[Noise]] = None) -> Dict[str, float]:
        """Metrics of (by default unguided: `use_guidance`) sampling over the
        whole test split, one batch. Captured (`graphs.on`), the whole call
        is timed as the phase "evaluate"."""
        guided = self.ccfg.use_guidance if guided is None else guided
        sh = pmesh.batch_shard(len(test.data))
        if self.graphs.on(sh):
            # the whole split and its draws: the graph takes this rank's rows
            # and gathers every rank's samples, rollouts and targets
            init, steps = self._draws(test.data.shape, noise, self._generator(generator))
            with self._phase("evaluate"):
                metrics = self.graphs(
                    ("eval", guided), lambda state, target, Q, init, steps, w: sh.local(
                        functools.partial(self._evaluate, w), state, target,
                        draws=(init, steps), Q=Q, guided=guided, sh=sh, timed=False),
                    state=test.data, target=test.state_phys, Q=Q, init=init, steps=steps,
                    w=self._weights(params))
        else:
            metrics = self._evaluate(params, self._tensor(sh.take(test.data)),
                                     self._tensor(sh.take(test.state_phys)), Q, guided=guided,
                                     sh=sh, **draws_kw(noise, self._generator(generator), sh))
        return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Pretraining (the Trainer recipe of the 1D task, reference: tokamak/model/trainer.py)
# ---------------------------------------------------------------------------

def pretrain(
    cfg: TokamakPretrainConfig,
    train_data: TokamakDataset,
    num_steps: Optional[int] = None,
    log_every: int = 500,
    checkpoint_dir: Optional[str] = None,
    params: Params = None,
    resume_dir: Optional[str] = None,
    steps_per_call: int = 1,
    deadline: Optional[float] = None,
    device="cuda",
    noise: Optional[Iterator[TrainNoise]] = None,
    losses: Optional[list] = None,
    capture: bool = True,
) -> TrainState:
    """Train the tokamak UNet1D with the denoising loss: Adam (0.9, 0.99),
    the periodic cosine learning rate, global-norm clip, EMA. Returns the
    TrainState (its `model` holds the trained weights, `ema_params` the EMA).

    `params` (a state_dict) starts from given weights, else `init_params`
    seeds them from cfg.seed. `resume_dir` restores step, weights, Adam
    moments and EMA from its latest checkpoint. Timesteps and noise come from
    a generator seeded with cfg.seed, or from `noise`, which yields each
    micro-batch's (t, noise) in order. `steps_per_call` and `losses`: see
    `run_train_loop`. On a CUDA model each full chunk of `steps_per_call`
    steps is one captured CUDA graph (`run_train_loop(capture=True)`),
    unless `noise` is given, the batch is split over gloo ranks or
    `capture` is False (every step eager, the same values)."""
    num_steps = num_steps or cfg.train_num_steps
    model = build_model(cfg.dim, cfg.dim_mults, cfg.resnet_block_groups, cfg.compute_dtype,
                        device=device)
    if params is None:
        init_params(model, seed=cfg.seed)
    else:
        model.load_state_dict(params)
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.objective, device=device)
    dcfg = DiffusionConfig(timesteps=cfg.timesteps, objective=cfg.objective,
                           beta_schedule=cfg.beta_schedule)
    cond = train_conditioner()

    lr = periodic_cosine_schedule(cfg.lr, cfg.cosine_t_max)
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
    sh = pmesh.batch_shard(cfg.batch_size)  # each micro-batch split over the data ranks
    generator = sh.generator(torch.Generator(device=device).manual_seed(cfg.seed))
    params_list = list(model.parameters())

    def loss_fn(i, batch):
        t, n = sh.draws(next(noise)) if noise is not None else draw_t_noise(dcfg, batch,
                                                                             generator)
        return p_losses(model, sched, dcfg, batch, t, n, cond).mean()

    def step_fn(state, batch, scalars=None):
        # batch: (accum * batch_size, ...) -> (accum, batch_size, ...)
        batches = batch.reshape(accum, -1, *batch.shape[1:])
        loss, grads = sh.reduce(*accumulated_grads(loss_fn, params_list, batches))
        state.apply_gradients(grads, scalars)
        return loss

    return run_train_loop(
        step_fn, state, train_data.data,
        batch_take=cfg.batch_size * accum, num_steps=num_steps, start_step=start_step,
        seed=cfg.seed, steps_per_call=steps_per_call, log_every=log_every,
        checkpoint_every=cfg.checkpoint_every, checkpoint_dir=checkpoint_dir, logger=log,
        log_prefix="tokamak pretrain", deadline=deadline, losses=losses, shard=sh,
        capture=capture and noise is None, generators=[generator],
    )


# ---------------------------------------------------------------------------
# Unified inference pipeline: post-train or backward finetune
# ---------------------------------------------------------------------------

def make_finetune_steps(cfg: TokamakInferenceConfig, pipeline: TokamakPipeline):
    """The fine-tuning steps `run_inference` takes, on `pipeline.model`'s
    weights in place. Returns `(tx, weighted_step, backward_step)`:

      weighted_step(opt_state, batch, w, generator=None, noise=None) -> loss
          post-training: the denoising loss weighted per sample by w, times
          loss_weight_train; noise = the batch's (t, noise), else drawn
          from `generator`.
      backward_step(opt_state, test_batch, state_target, Q, generator=None,
                    noise=None) -> loss
          InfFT: sampling (guided when use_guidance) with gradients through
          the final denoise step, then the objective + safety loss of the
          samples (reference: pipeline.py:238-268); noise = the sampler
          call's (init_noise, step_noise).

    Where `pipeline.graphs.on`, each step is one captured CUDA graph on
    static inputs (the batch, the weights w or the targets and Q-hat, the
    step's draws, taken ahead of it as the eager step takes them, and the
    update's values `tx.scalars(opt_state.count)`), one graph per batch
    shape and optimizer state (the tensors it updates in place, by
    address).

    `cfg.optimizer` ("adam": plain Adam(finetune_lr, betas (0.99, 0.999));
    "sgd": momentum 0.9), no clip, no EMA (reference: pipeline.py:150-163)."""
    ccfg = cfg.conformal
    tc = pipeline.task_cfg
    sched = pipeline.sched
    dcfg_train = DiffusionConfig(timesteps=ccfg.timesteps, beta_schedule="cosine")
    cond_train = train_conditioner()
    tx = make_optimizer(cfg.optimizer, cfg.finetune_lr, betas=(0.99, 0.999), max_grad_norm=0.0)
    model = pipeline.model
    params = list(model.parameters())

    def weighted(opt_state, batch, w, generator=None, noise=None, scalars=None):
        sh = pmesh.batch_shard(batch.shape[0])
        batch, w = sh.take(batch), sh.take(w)
        t, n = (sh.draws(noise) if noise is not None
                else draw_t_noise(dcfg_train, batch, sh.generator(generator)))
        per = p_losses(model, sched, dcfg_train, batch, t, n, cond_train)
        loss = cfg.loss_weight_train * (w * per).mean()
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
        tx.step(params, grads, opt_state, scalars)
        return loss

    def backward(opt_state, test_batch, state_target, Q, generator=None, noise=None,
                 scalars=None):
        sh = pmesh.batch_shard(test_batch.shape[0])
        test_batch, state_target = sh.take(test_batch), sh.take(state_target)
        kw = draws_kw(None if noise is None else iter([noise]), generator, sh)
        g = guidance_grad_fn(state_target, Q, tc) if ccfg.use_guidance else None
        out = pipeline.sampler_fn(model, sched, pipeline.diff_cfg, test_batch.shape,
                                  cond=sampling_conditioner(test_batch), guidance_grad=g,
                                  j_scheduler=pipeline.j_scheduler, final_step_grad=True, **kw)
        loss = backward_loss(out * scaler(out), state_target, Q, tc)
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
        tx.step(params, grads, opt_state, scalars)
        return loss

    def scalars(opt_state):
        # the update's values, then counted (a captured step's)
        out = _fill(tx.scalars(opt_state.count), pipeline.device)
        opt_state.count += 1
        return out

    def weighted_step(opt_state, batch, w, generator=None, noise=None):
        if not pipeline.graphs.on(pmesh.batch_shard(batch.shape[0])):
            return weighted(opt_state, batch, w, generator, noise)
        t, n = noise if noise is not None else draw_t_noise(dcfg_train, batch, generator)
        return pipeline.graphs(
            "weighted", lambda batch, w, t, noise, scalars: weighted(
                opt_state, batch, w, noise=(t, noise), scalars=scalars),
            writes=params + opt_state.tensors(), batch=batch, w=w, t=t, noise=n,
            scalars=scalars(opt_state))

    def backward_step(opt_state, test_batch, state_target, Q, generator=None, noise=None):
        if not pipeline.graphs.on(pmesh.batch_shard(test_batch.shape[0])):
            return backward(opt_state, test_batch, state_target, Q, generator, noise)
        init, steps = noise if noise is not None else pipeline._draws(test_batch.shape, None,
                                                                      generator)
        return pipeline.graphs(
            "backward", lambda batch, target, Q, init, steps, scalars: backward(
                opt_state, batch, target, Q, noise=(init, steps), scalars=scalars),
            writes=params + opt_state.tensors(), batch=test_batch, target=state_target, Q=Q, init=init, steps=steps,
            scalars=scalars(opt_state))

    return tx, weighted_step, backward_step


def run_inference(
    cfg: TokamakInferenceConfig,
    pipeline: TokamakPipeline,
    params: Params,
    train_data: Optional[TokamakDataset],
    cal_data: TokamakDataset,
    test_data: TokamakDataset,
    on_epoch=None,
    state_dir: Optional[str] = None,
    noise: Optional[Iterator] = None,
):
    """Reference run() loop (tokamak/inference/pipeline.py:409-465): per
    epoch calibrate -> finetune -> evaluate. Returns (state_dict, Q, epoch
    records).

    `params` (a state_dict, or None for the model's current weights) is
    loaded into `pipeline.model`, which the epochs train in place.
    `on_epoch(record)` fires after each epoch. `state_dir` persists
    (weights, Adam moments, Q-hat) and the records after every epoch and
    resumes after the latest saved one; each epoch's draws depend on (seed,
    epoch) only, so the resumed run equals an uninterrupted one. `noise`
    yields, in the order they are consumed, each sampler call's
    (init_noise, step_noise) and each post-training step's (t, noise).
    Where `pipeline.graphs.on`, each step is one captured graph
    (`make_finetune_steps`); the phase's graphs are freed as it ends."""
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
            log.info("tokamak finetune: resumed phase state after epoch %d from %s",
                     last_epoch, state_dir)
    if on_epoch is not None:
        for rec in history:  # restored records, so external result files converge
            on_epoch(rec)

    for epoch in range(start_epoch, cfg.finetune_epoch):
        # the epoch's draws depend on (seed, epoch) only (JAX: fold_in(key, epoch))
        gen = torch.Generator(device=device).manual_seed(cfg.seed * 1_000_003 + epoch)
        Q = pipeline.calibrate(None, cal_data, Q, generator=gen, noise=noise)

        losses = []
        if cfg.backward_finetune:
            for lo in range(0, len(test_data), ccfg.test_batch_size):
                sl = slice(lo, lo + ccfg.test_batch_size)
                batch = torch.as_tensor(test_data.data[sl], device=device)
                target = torch.as_tensor(test_data.state_phys[sl], device=device)
                for _ in range(cfg.finetune_steps):
                    draws = next(noise) if noise is not None else None
                    losses.append(backward_step(opt_state, batch, target, Q, gen, draws))
        else:
            w_train = pipeline.reweights(train_data, Q)
            n = len(train_data)
            pos = 0
            for _ in range(cfg.finetune_steps):
                sel = np.arange(pos, pos + cfg.train_batch_size) % n
                pos = (pos + cfg.train_batch_size) % n
                batch = torch.as_tensor(train_data.data[sel], device=device)
                w = torch.as_tensor(w_train[sel], device=device)
                draws = next(noise) if noise is not None else None
                losses.append(weighted_step(opt_state, batch, w, gen, draws))

        losses = [float(v) for v in losses]  # one sync per epoch
        metrics = pipeline.evaluate(None, test_data, Q, generator=gen, noise=noise)
        loss = float(np.mean(losses)) if losses else None
        log.info("tokamak epoch %d Q %.4f loss %s metrics %s", epoch, float(Q), loss, metrics)
        history.append({"epoch": epoch, "quantile": float(Q), "loss": loss, "eval": metrics})
        # persist state and history before the callback: a crash between them
        # then re-fires the callback on resume instead of losing the record
        if state_dir is not None:
            save_phase_state(state_dir, model.state_dict(), opt_state, Q, epoch)
            save_phase_history(state_dir, history, config_repr=repr(cfg))
        if on_epoch is not None:
            on_epoch(history[-1])
    pipeline.graphs.clear()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return params, Q, history


def run_inference_resilient(
    cfg: TokamakInferenceConfig,
    make_pipeline,
    params: Params,
    train_data: Optional[TokamakDataset],
    cal_data: TokamakDataset,
    test_data: TokamakDataset,
    on_epoch=None,
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
                                      on_epoch=on_epoch, state_dir=state_dir),
        params, retries=fault_retries, backoff_s=backoff_s, describe="tokamak finetune",
        state_dir=state_dir)
