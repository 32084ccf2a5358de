"""End-to-end pipelines for the 1D Burgers task: pretraining, conformal
calibration, post-training, inference-time fine-tuning (InfFT), evaluation.

Port of `safediffcon_tpu/tasks/burgers/pipeline.py` (reference:
1D/model/trainer.py:150-210, 1D/posttrain/post_train.py:25-470,
1D/inference/inference_ft.py:26-433): `build_model`, `init_params`,
`BurgersPipeline` (`calibrate`, `reweights`, `evaluate`), `pretrain`,
`posttrain` and `inference_finetune`, with the steps they take
(`weighted_step`, `infft_step`) exposed, and `posttrain_resilient` and
`inference_finetune_resilient` (CUDA fault handling, `utils/faults.py`).

Weights are passed as `params`, a state_dict of the UNet2D (the pipeline
runs its model on them through `torch.func.functional_call`), or None for
the pipeline model's own weights; load flax weights with
`models.convert.load_flax_params` or `flax_to_state_dict`. A
`BurgersPipeline(two_model=True)` composes the main denoiser with the w-only
prior that `pretrain(model_w=True)` trains; its `params` is then the pair
(main, prior), each a state_dict of the same UNet2D or None.

The test sampler is the config's `sampler` ("ddim" or "dpm"); calibration
takes the same DPM sampler, or `core.sampling.sample` for "ddim", which is
the ancestral sampler when ddim_sampling_steps >= timesteps. Random draws
come from explicit `torch.Generator`s; `noise=` hands in the draws instead,
in the order the code consumes them, which is how the parity tests replay
the JAX key chain: each training step's (t, noise) and each sampler call's
(init_noise, step_noise), where step_noise is that sampler's
(`core.sampling`): DDIM's stochastic steps, the ancestral steps' draws, or
nothing for DPM (its noise-matched impositions with
`dpm_noise_matched_cond`).

Under an active mesh (`parallel/mesh.py`) every batch of calibrate,
evaluate and the training steps is split over the data ranks: each takes
its rows of the global batch and of the global random draws, scores,
weights, samples and rollouts are gathered (Q-hat and the metrics are
computed whole on every rank), and gradients are averaged before each
optimizer step. `reweights` stays whole on every rank.

On a CUDA pipeline (`capture`, on by default), each
calibration batch (`_cal_batch`), each evaluation (`_evaluate`: sampling,
the solver rollout and the metrics), each InfFT step and each full chunk
of post-training steps is one captured CUDA graph, the counterpart of the
JAX package's jitted programs (`core/train.py::Graphs`, `ChunkGraph`).
Its inputs are copied into static buffers before each replay: the weights,
the batch, Q-hat, the targets, the step values and the call's random
draws, which are drawn ahead of it as the eager call would draw them. So a
captured call gives what the eager one gives, bit for bit, and leaves the
generators where it would. A call of a new shape (a shorter last batch)
gets a graph of its own; the first call of each graph runs eagerly as its
warm-up. A batch split over the ranks of an NCCL group is captured with
its gathers and gradient all-reduce; CPU pipelines and a batch split over
gloo ranks run eagerly.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import logging
import math
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from safediffcon_torch.core.conformal import normalize_weights, weighted_quantile
from safediffcon_torch.core.diffusion import DiffusionConfig, draw_t_noise, p_losses
from safediffcon_torch.core.sampling import (
    compose_two_model_apply,
    dpm_solver_sample,
    draws_kw,
    get_sampler,
    sample,
    sampler_draws,
)
from safediffcon_torch.core.schedules import get_J_scheduler, make_schedule
from safediffcon_torch.core.train import (
    ChunkGraph,
    Graphs,
    TrainState,
    _fill,
    accumulated_grads,
    make_optimizer,
    periodic_cosine_schedule,
    run_train_loop,
    warmup_cosine_schedule,
)
from safediffcon_torch.models.layers import Conv2dCL, Linear, lecun_normal_
from safediffcon_torch.models.unet2d import UNet2D
from safediffcon_torch.parallel import mesh as pmesh
from safediffcon_torch.tasks.burgers.config import (
    BurgersConformalConfig,
    BurgersInfFTConfig,
    BurgersPostTrainConfig,
    BurgersPretrainConfig,
)
from safediffcon_torch.tasks.burgers.data import BurgersDataset
from safediffcon_torch.tasks.burgers.metrics import control_trajectories, evaluate_samples
from safediffcon_torch.tasks.burgers.task import (
    COND_IDX,
    NT,
    SCALER,
    BurgersConditioner,
    BurgersTaskConfig,
    ModelWConditioner,
    conformal_score,
    guidance_grad_fn,
    infft_loss,
    mask_model_w_input,
    mask_model_w_output,
    shift_weights,
    train_conditioner,
)

log = logging.getLogger(__name__)

Params = Optional[Mapping[str, torch.Tensor]]
# The JAX CLI's refusal of two-model fine-tuning (cli/main.py:365-368)
TWO_MODEL_FINETUNE = ("two_model is a sampling/eval surface (the reference composes models at "
                      "inference only); finetune the main model, then evaluate with two_model")
# One sampler call's draws: (init_noise, step_noise), in the sampler's order.
Noise = Tuple[torch.Tensor, list]
# One training step's draws: (timesteps (B,), noise like the batch).
TrainNoise = Tuple[torch.Tensor, torch.Tensor]


def build_model(dim=128, dim_mults=(1, 2, 4, 8), groups=1, compute_dtype=None,
                device="cuda") -> UNet2D:
    return UNet2D(dim=dim, dim_mults=dim_mults, channels=3, resnet_block_groups=groups,
                  compute_dtype=compute_dtype).to(device)


@torch.no_grad()
def init_params(model: UNet2D, seed: int = 0) -> UNet2D:
    """Seeded init with flax's defaults: lecun-normal kernels, zero biases,
    unit norm scales. The draws come from a CPU generator, so a seed gives
    the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (Linear, Conv2dCL)):
            w = module.weight
            lecun_normal_(w, w[0].numel(), gen)
            if module.bias is not None:
                module.bias.zero_()
    return model


class BurgersPipeline:
    """Calibration, guided sampling and solver evaluation for the Burgers
    task; the state the fine-tuning phases share."""

    def __init__(
        self,
        conf_cfg: BurgersConformalConfig,
        dim: int = 128,
        dim_mults=(1, 2, 4, 8),
        groups: int = 1,
        compute_dtype: Optional[str] = None,
        # calibration sub-batch; scores and weights are per sample, so any
        # chunking gives the same Q-hat
        cal_chunk: Optional[int] = 50,
        # two-model composed sampling: the denoiser corrected by the w-only
        # prior (core.sampling.compose_two_model_apply); `params` is then
        # (main, prior) everywhere in the pipeline
        two_model: bool = False,
        prior_beta: float = 1.0,
        normalize_beta: bool = False,
        device="cuda",
        # calibration batches, evaluations and the fine-tuning steps as
        # captured CUDA graphs on a CUDA device (module docstring); False
        # runs them eagerly, with the same results
        capture: bool = True,
    ):
        self.ccfg = conf_cfg
        self.device = torch.device(device)
        self.cal_chunk = cal_chunk
        self.graphs = Graphs(self.device, capture, "burgers pipeline")
        self.task_cfg = BurgersTaskConfig(
            u_bound=conf_cfg.u_bound,
            use_max_safety=conf_cfg.use_max_safety,
            w_score=conf_cfg.w_score,
            alpha=conf_cfg.alpha,
        )
        self.model = build_model(dim, dim_mults, groups, compute_dtype, device=device).eval()
        self.sched = make_schedule(conf_cfg.timesteps, "cosine", device=device)
        self.diff_cfg = DiffusionConfig(
            timesteps=conf_cfg.timesteps,
            sampling_timesteps=conf_cfg.ddim_sampling_steps,
            ddim_eta=conf_cfg.ddim_eta,
            beta_schedule="cosine",
            noise_matched_cond=conf_cfg.dpm_noise_matched_cond,
        )
        self.j_scheduler = get_J_scheduler(conf_cfg.J_scheduler)
        self._sampler = get_sampler(conf_cfg.sampler)
        # calibration takes the test sampler, or Q-hat loses its coverage
        # meaning for the deployed sampler; DDIM's calibration goes through
        # `sample`, so it is ancestral at ddim_sampling_steps >= timesteps
        self._cal_sampler = (dpm_solver_sample if self._sampler is dpm_solver_sample
                             else sample)
        self.two_model = two_model
        self._composed = compose_two_model_apply(
            self._bind, self._bind, prior_beta=prior_beta, normalize_beta=normalize_beta,
            mask_w_input=mask_model_w_input, mask_w_output=mask_model_w_output,
        ) if two_model else None
        # seconds per phase of `_evaluate` ("sampling", "rollout"), summed
        # over calls, when set to a dict; each phase then ends in a sync
        self.phase_seconds: Optional[Dict[str, float]] = None
        # when set to a dict, `calibrate` stores its per-sample scores and
        # raw weights there ("cal_scores", "cal_weights", on the CPU)
        self.record: Optional[Dict[str, torch.Tensor]] = None
        # what `evaluate` ends in: (pred, controlled, u_target, u_bound) ->
        # {metric: scalar}; a caller may wrap it before the first evaluation
        # (a captured evaluation keeps the one it was captured with)
        self.metrics = evaluate_samples

    def _bind(self, params: Params, x, t):
        if params is None:
            return self.model(x, t)
        return functional_call(self.model, params, (x, t))

    def apply_fn(self, params=None):
        """The denoiser (x, t) -> output on `params` (None: the model's own);
        with two_model, the composed denoiser on the pair (main, prior)."""
        if self.two_model:
            if not (isinstance(params, (tuple, list)) and len(params) == 2):
                raise ValueError("a two-model pipeline takes params = (main, prior), each a "
                                 "state_dict or None")
            return functools.partial(self._composed, tuple(params))
        if params is None:
            return self.model
        return functools.partial(self._bind, params)

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

    # ---- captured calls --------------------------------------------------

    def _weights(self, params: Params) -> dict:
        """The weights a call binds, as static inputs: {"w0": main} or, two-
        model, {"w0": main, "w1": prior}; None is the model's own."""
        own = dict(self.model.named_parameters())
        if self.two_model:
            return {f"w{i}": own if p is None else dict(p) for i, p in enumerate(params)}
        return {"w0": own if params is None else dict(params)}

    def _bound(self, w: dict):
        """The `params` of the static weights `w` (see `_weights`)."""
        return (w["w0"], w["w1"]) if self.two_model else w["w0"]

    def _draws(self, sampler, shape, noise, generator):
        """A captured call's (init_noise, step_noise): the next of `noise`,
        else drawn from `generator` as the sampler would draw them."""
        if noise is not None:
            return next(noise)
        return sampler_draws(sampler, self.diff_cfg, shape, generator, self.device)

    # ---- conformal calibration -------------------------------------------

    @torch.no_grad()
    def _cal_batch(self, params: Params, state, Q, **sampler_kw):
        """One calibration batch: sample conditioned on the ground-truth
        control, return (scores, weights) (reference:
        1D/posttrain/conformal.py:43-88)."""
        tc = self.task_cfg
        cond = BurgersConditioner(u0=state[:, 0, :, 0], uT=state[:, COND_IDX, :, 0],
                                  w=state[:, :, :, 1])
        out = self._cal_sampler(self.apply_fn(params), self.sched, self.diff_cfg, state.shape,
                                cond=cond, **sampler_kw)
        scores = conformal_score(out, state, tc.use_max_safety)
        weights = shift_weights(state, Q, tc)
        if self.ccfg.InfFT_Q is not None:
            # composite InfFT weight: a second factor at the fixed InfFT_Q
            # (reference: 1D/inference/conformal.py:67-73)
            weights = weights * shift_weights(state, self.ccfg.InfFT_Q, tc)
        return scores, weights

    def calibrate(self, params: Params, cal_data: np.ndarray, Q,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Iterator[Noise]] = None) -> torch.Tensor:
        """Q-hat over `num_cal_batch` batches of `cal_batch_size` of the
        calibration split, sampled in chunks of `cal_chunk` (reference:
        1D/posttrain/post_train.py:353-365)."""
        generator = self._generator(generator)
        bs = self.ccfg.cal_batch_size
        chunk = min(self.cal_chunk or bs, bs)
        n = len(cal_data)
        scores, weights = [], []
        for i in range(self.ccfg.num_cal_batch):
            for lo in range(0, bs, chunk):
                base = i * bs + lo
                if base >= n:  # cal set smaller than the configured batches
                    break
                block = cal_data[base : min(base + chunk, n)]
                sh = pmesh.batch_shard(len(block))
                if self.graphs.on(sh):
                    # the whole chunk and its draws: the graph takes this
                    # rank's rows and gathers every rank's scores and weights
                    init, steps = self._draws(self._cal_sampler, block.shape, noise, generator)
                    s, w = self.graphs(
                        "cal", lambda state, Q, init, steps, **w: tuple(map(sh.gather, sh.local(
                            functools.partial(self._cal_batch, self._bound(w)), state,
                            draws=(init, steps), Q=Q))),
                        state=block, Q=Q, init=init, steps=steps, **self._weights(params))
                else:
                    state = torch.as_tensor(sh.take(block), device=self.device)
                    s, w = map(sh.gather, self._cal_batch(params, state, Q,
                                                          **draws_kw(noise, generator, sh)))
                scores.append(s)
                weights.append(w)
        scores, weights = torch.cat(scores), torch.cat(weights)
        if self.record is not None:
            self.record.update(cal_scores=scores.cpu(), cal_weights=weights.cpu())
        return weighted_quantile(normalize_weights(weights) * scores, self.ccfg.alpha)

    # ---- reweights over a split ------------------------------------------

    @torch.no_grad()
    def reweights(self, data: np.ndarray, Q, batch_size: int = 2048) -> np.ndarray:
        """Normalized per-sample shift weights exp(-guidance(x, Q)) of a split."""
        ws = [shift_weights(torch.as_tensor(data[lo : lo + batch_size], device=self.device),
                            Q, self.task_cfg)
              for lo in range(0, len(data), batch_size)]
        return normalize_weights(torch.cat(ws)).cpu().numpy()

    # ---- sampling and evaluation -----------------------------------------

    def _sample_test(self, params: Params, state, Q, guided: bool = True,
                     final_step_grad: bool = False, **sampler_kw) -> torch.Tensor:
        """Guided sampling conditioned on (u0, uT); returns the UNSCALED
        prediction (reference: 1D/inference/inference_ft.py:316-347)."""
        cond = BurgersConditioner(u0=state[:, 0, :, 0], uT=state[:, COND_IDX, :, 0])
        g = guidance_grad_fn(Q, self.task_cfg) if guided else None
        out = self._sampler(self.apply_fn(params), self.sched, self.diff_cfg, state.shape,
                            cond=cond, guidance_grad=g, j_scheduler=self.j_scheduler,
                            final_step_grad=final_step_grad, **sampler_kw)
        return out * SCALER

    @torch.no_grad()
    def _evaluate(self, params: Params, state, u_target, Q, guided=True,
                  sh: Optional[pmesh.BatchShard] = None, timed: bool = True,
                  **sampler_kw) -> Dict[str, torch.Tensor]:
        """Sample -> solver rollout -> metrics (reference:
        1D/posttrain/post_train.py:313-351). Under a data-parallel shard
        `sh`, `state` is this rank's rows: the samples and their rollouts
        are gathered, and the metrics of the whole batch computed on every
        rank. `timed`: time the two phases (not inside a captured graph)."""
        phase = self._phase if timed else (lambda name: contextlib.nullcontext())
        with phase("sampling"):
            pred = self._sample_test(params, state, Q, guided=guided, **sampler_kw)
        with phase("rollout"):
            controlled = control_trajectories(pred, NT)
        if sh is not None:
            pred, controlled = sh.gather(pred), sh.gather(controlled)
        return self.metrics(pred, controlled, u_target, self.task_cfg.u_bound)

    def evaluate(self, params: Params, test: BurgersDataset, Q,
                 generator: Optional[torch.Generator] = None, guided: bool = True,
                 noise: Optional[Iterator[Noise]] = None) -> Dict[str, float]:
        """Metrics of guided sampling over the whole test split, one batch.
        Captured (`graphs.on`), the whole call is timed as the phase
        "evaluate"."""
        sh = pmesh.batch_shard(len(test.data))
        if self.graphs.on(sh):
            # the whole split and its draws: the graph takes this rank's rows
            # and gathers every rank's samples and rollouts
            init, steps = self._draws(self._sampler, test.data.shape, noise,
                                      self._generator(generator))
            with self._phase("evaluate"):
                metrics = self.graphs(
                    ("eval", guided), lambda state, u_target, Q, init, steps, **w: sh.local(
                        functools.partial(self._evaluate, self._bound(w)), state,
                        draws=(init, steps), u_target=u_target, Q=Q, guided=guided, sh=sh,
                        timed=False),
                    state=test.data, u_target=test.u_phys, Q=Q, init=init, steps=steps,
                    **self._weights(params))
        else:
            state = torch.as_tensor(sh.take(test.data), device=self.device)
            u_target = torch.as_tensor(test.u_phys, device=self.device)
            metrics = self._evaluate(params, state, u_target, Q, guided=guided, sh=sh,
                                     **draws_kw(noise, self._generator(generator), sh))
        return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Pretraining
# ---------------------------------------------------------------------------

def pretrain(
    cfg: BurgersPretrainConfig,
    train_data: BurgersDataset,
    num_steps: Optional[int] = None,
    log_every: int = 500,
    checkpoint_dir: Optional[str] = None,
    params: Params = None,
    resume_dir: Optional[str] = None,
    steps_per_call: int = 1,
    model_w: bool = False,
    deadline: Optional[float] = None,
    device="cuda",
    noise: Optional[Iterator[TrainNoise]] = None,
    losses: Optional[list] = None,
    capture: bool = True,
) -> TrainState:
    """Train the Burgers UNet2D with the denoising loss (reference:
    1D/model/trainer.py:150-210): Adam, the periodic cosine learning rate,
    global-norm clip, EMA. Returns the TrainState (its `model` holds the
    trained weights, `ema_params` the EMA).

    model_w=True trains the w-only prior p(w | u0, uT) instead (reference
    is_model_w, 1D/model/diffusion.py:678-679,718-720): the model never sees
    u_1..u_{T-1} (`mask_model_w_input`) and the u channel carries no loss
    (`ModelWConditioner`). Its weights are the prior of
    `BurgersPipeline(two_model=True)`.

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
    if model_w:
        cond = ModelWConditioner()

        def apply_fn(x, t):
            return model(mask_model_w_input(x), t)
    else:
        cond, apply_fn = train_conditioner(), model

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
        return p_losses(apply_fn, sched, dcfg, batch, t, n, cond).mean()

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
        log_prefix="burgers pretrain", deadline=deadline, losses=losses, shard=sh,
        capture=capture and noise is None, generators=[generator],
    )


# ---------------------------------------------------------------------------
# Fine-tuning steps shared by posttrain and InfFT
# ---------------------------------------------------------------------------

def make_train_state(pipeline: BurgersPipeline, params: Params, tx, ema_decay: float,
                     ema_update_every: int) -> TrainState:
    """A TrainState on a copy of the pipeline's model holding `params` (None:
    the model's own weights); the pipeline's model is left as it is. A
    two-model pipeline is refused: it is an evaluation surface."""
    if pipeline.two_model:
        raise ValueError(TWO_MODEL_FINETUNE)
    net = copy.deepcopy(pipeline.model).train()
    if params is not None:
        net.load_state_dict(params)
    return TrainState.create(net, tx, ema_decay, ema_update_every)


def _train_dcfg(pipeline: BurgersPipeline) -> DiffusionConfig:
    return DiffusionConfig(timesteps=pipeline.ccfg.timesteps, beta_schedule="cosine")


def weighted_step(pipeline: BurgersPipeline, state: TrainState, batch: torch.Tensor,
                  w: torch.Tensor, generator=None, noise: Optional[TrainNoise] = None,
                  scalars: Optional[torch.Tensor] = None):
    """One post-training step: the denoising loss at full T, weighted per
    sample by `w` (reference: 1D/posttrain/post_train.py:206-210); noise =
    the batch's (t, noise), else drawn from `generator`. Returns the loss.
    Under a data mesh each rank takes its rows of the batch and the draws,
    and the gradients are averaged over the ranks. `scalars`: the step's
    device row of `TrainState.scalar_table` (a captured step; the caller
    then advances the state)."""
    dcfg = _train_dcfg(pipeline)
    sh = pmesh.batch_shard(batch.shape[0])
    batch, w = sh.take(batch), sh.take(w)
    t, n = (sh.draws(noise) if noise is not None
            else draw_t_noise(dcfg, batch, sh.generator(generator)))
    per = p_losses(state.model, pipeline.sched, dcfg, batch, t, n, train_conditioner())
    loss = (w * per).mean()
    loss, grads = sh.reduce(loss, torch.autograd.grad(loss, list(state.model.parameters())))
    state.apply_gradients(grads, scalars)
    return loss


def infft_step(pipeline: BurgersPipeline, state: TrainState, test_batch: torch.Tensor, Q,
               generator=None, noise: Optional[Noise] = None,
               scalars: Optional[torch.Tensor] = None):
    """One InfFT step: guided sampling with gradients through the final
    denoise step only, then the safety objective backpropagated into the
    weights (reference: 1D/inference/inference_ft.py:193-201,316-347); noise
    = the sampler call's (init_noise, step_noise), else drawn from
    `generator`. Returns the loss. Under a data mesh each rank samples its
    rows of the batch and the gradients are averaged over the ranks.
    `scalars` as in `weighted_step`."""
    sh = pmesh.batch_shard(test_batch.shape[0])
    test_batch = sh.take(test_batch)
    kw = draws_kw(None if noise is None else iter([noise]), generator, sh)
    cond = BurgersConditioner(u0=test_batch[:, 0, :, 0], uT=test_batch[:, COND_IDX, :, 0])
    out = pipeline._sampler(state.model, pipeline.sched, pipeline.diff_cfg, test_batch.shape,
                            cond=cond, guidance_grad=guidance_grad_fn(Q, pipeline.task_cfg),
                            j_scheduler=pipeline.j_scheduler, final_step_grad=True, **kw)
    loss = infft_loss(out * SCALER, Q, pipeline.task_cfg)
    loss, grads = sh.reduce(loss, torch.autograd.grad(loss, list(state.model.parameters())))
    state.apply_gradients(grads, scalars)
    return loss


def _posttrain_chunks(pipeline: BurgersPipeline, state: TrainState, k: int, bsz: int,
                      sample_shape: tuple) -> Optional[ChunkGraph]:
    """Post-training's full chunks of k steps as one captured graph
    (`ChunkGraph` with the per-sample weights and the steps' draws as
    static inputs beside the batches), or None where the steps run
    eagerly."""
    if not pipeline.graphs.on(pmesh.batch_shard(bsz)):
        return None

    def step(state, batch, scalars, w, t, noise):
        return weighted_step(pipeline, state, batch, w, noise=(t, noise), scalars=scalars)

    return ChunkGraph(step, state, k, (bsz,) + tuple(sample_shape), extra=dict(
        w=((), torch.float32), t=((), torch.long), noise=(tuple(sample_shape), torch.float32)),
        pool=pipeline.graphs.pool)


def make_infft_step(pipeline: BurgersPipeline, state: TrainState):
    """`infft_step` on `state`, as `inference_finetune` takes it: step(batch,
    Q, generator=None, noise=None) -> loss. Where `pipeline.graphs.on`,
    each step is one captured CUDA graph on static inputs (the batch, Q-hat,
    the sampler's draws, taken ahead of the step as it would take them, and
    the step values of `state.scalar_table`), one graph per batch shape and
    train state."""
    writes = state.tensors()

    def step(batch, Q, generator=None, noise=None):
        if not pipeline.graphs.on(pmesh.batch_shard(batch.shape[0])):
            return infft_step(pipeline, state, batch, Q, generator, noise)
        init, steps = noise if noise is not None else pipeline._draws(
            pipeline._sampler, batch.shape, None, generator)
        loss = pipeline.graphs("infft", lambda batch, Q, init, steps, scalars: infft_step(
            pipeline, state, batch, Q, noise=(init, steps), scalars=scalars),
            writes=writes, batch=batch, Q=Q, init=init, steps=steps,
            scalars=_fill(state.scalar_table(1)[0], pipeline.device))
        state.advance(1)
        return loss

    return step


def _restore_phase(state_dir: Optional[str], state: TrainState, cfg, device):
    """(Q, first epoch to run, history) after the latest saved epoch."""
    from safediffcon_torch.utils.checkpoint import load_phase_history, load_phase_trainstate

    Q = torch.zeros((), device=device)
    if state_dir is None:
        return Q, 0, []
    restored = load_phase_trainstate(state_dir, state)
    if restored is None:
        return Q, 0, []
    _, q, last_epoch = restored
    log.info("resumed phase state after epoch %d from %s", last_epoch, state_dir)
    history = load_phase_history(state_dir, max_epoch=last_epoch, config_repr=repr(cfg))
    return torch.tensor(q, dtype=torch.float32, device=device), last_epoch + 1, history


def _save_phase(state_dir: Optional[str], state: TrainState, Q, epoch: int, history, cfg):
    if state_dir is None:
        return
    from safediffcon_torch.utils.checkpoint import save_checkpoint, save_phase_history

    save_checkpoint(state_dir, state, step=epoch, Q=Q)
    save_phase_history(state_dir, history, config_repr=repr(cfg))


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    # the epoch's draws depend on (seed, epoch) only, so a resumed run draws
    # what an uninterrupted one does (JAX: fold_in(key, epoch))
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)


# ---------------------------------------------------------------------------
# Post-training (conformal reweighted fine-tuning)
# ---------------------------------------------------------------------------

def posttrain(
    cfg: BurgersPostTrainConfig,
    pipeline: BurgersPipeline,
    params: Params,
    finetune_data: BurgersDataset,
    cal_data: BurgersDataset,
    test_data: BurgersDataset,
    finetune_steps: Optional[int] = None,
    eval_every_subset_epoch: bool = True,
    state_dir: Optional[str] = None,
    noise: Optional[Iterator] = None,
    on_epoch=None,
):
    """Conformal post-training (reference: 1D/posttrain/post_train.py:262-311).
    Returns (TrainState, Q, epoch records).

    Per epoch: per-sample reweights exp(-guidance(x, Q)), `finetune_steps`
    reweighted denoising-loss steps (AdamW, warmup + cosine, EMA) over
    sequential windows of the split, an evaluation of the EMA weights
    whenever the samples seen reach a multiple of `finetune_subset_size`,
    and a Q-hat recalibration on every epoch but the last. `state_dir`
    persists the TrainState and Q after every epoch and resumes after the
    latest saved one, bit-identically to an uninterrupted run. `noise`
    yields, in the order they are consumed, each step's (t, noise) and each
    sampler call's (init_noise, step_noise). `on_epoch(record)` fires after
    each epoch's record is saved.

    `cfg.steps_per_call` = k runs the steps in chunks of up to k inside each
    evaluation segment, as JAX does: a chunk's batches and weights cross to
    the device in one copy and its steps run back to back. Each step draws
    its own (t, noise), so the chunking changes no result of the port. Where
    `pipeline.graphs.on`, each full chunk of k steps is one captured graph
    (`ChunkGraph`), its draws taken ahead of it in the eager steps' order; a
    shorter chunk runs eagerly. The phase's graphs are freed as it ends."""
    ccfg = cfg.conformal
    steps_per_epoch = finetune_steps or cfg.finetune_steps
    device = pipeline.device

    warmup = int(0.05 * steps_per_epoch)
    lr = warmup_cosine_schedule(cfg.finetune_lr, warmup,
                                cfg.finetune_subset_size * cfg.cosine_epoch)
    tx = make_optimizer(cfg.optimizer, lr, weight_decay=cfg.weight_decay, betas=(0.9, 0.999),
                        max_grad_norm=cfg.max_grad_norm)
    state = make_train_state(pipeline, params, tx, cfg.ema_decay, cfg.ema_update_every)
    Q, start_epoch, all_metrics = _restore_phase(state_dir, state, cfg, device)

    n = len(finetune_data)
    bsz = cfg.finetune_batch_size

    def epoch_sels():
        # sequential windows with the reference's reset-on-overflow walk
        # (1D/posttrain/post_train.py batch cycling)
        sels, pos = [], 0
        for _ in range(steps_per_epoch):
            if pos + bsz > n:
                pos = 0
            sels.append(np.arange(pos, pos + bsz) % n)
            pos += bsz
        return sels

    # Eval fires when the cumulative sample count hits a multiple of the
    # subset size: the reference's ((it+1)*batch) % subset == 0
    # (1D/posttrain/post_train.py:288), as it % (subset / gcd(batch, subset)).
    eval_period = (cfg.finetune_subset_size // math.gcd(bsz, cfg.finetune_subset_size)
                   if eval_every_subset_epoch else steps_per_epoch)
    k = max(int(cfg.steps_per_call), 1)
    graph = _posttrain_chunks(pipeline, state, k, bsz, finetune_data.data.shape[1:])
    dcfg = _train_dcfg(pipeline)
    for epoch in range(start_epoch, cfg.finetune_epoch):
        gen = _epoch_generator(cfg.seed, epoch, device)
        w_train = pipeline.reweights(finetune_data.data, Q)
        losses, eval_history = [], []
        sels = epoch_sels()
        it = 0
        while it < steps_per_epoch:
            # a chunk never crosses an evaluation point
            kk = min(k, eval_period - it % eval_period, steps_per_epoch - it)
            sel = np.concatenate(sels[it : it + kk])
            if graph is not None and kk == k:
                graph.set_table()
                graph.batches.copy_(torch.from_numpy(finetune_data.data[sel]))
                graph.inputs["w"].copy_(torch.from_numpy(w_train[sel]))
                for i in range(kk):
                    # the draws the eager steps take, in their order
                    rows = slice(i * bsz, (i + 1) * bsz)
                    t, n_ = (next(noise) if noise is not None
                             else draw_t_noise(dcfg, graph.batches[rows], gen))
                    graph.inputs["t"][rows].copy_(t)
                    graph.inputs["noise"][rows].copy_(n_)
                losses.extend(graph.run())
            else:
                batches = torch.as_tensor(finetune_data.data[sel], device=device)
                ws = torch.as_tensor(w_train[sel], device=device)
                for i in range(kk):
                    rows = slice(i * bsz, (i + 1) * bsz)
                    draws = next(noise) if noise is not None else None
                    losses.append(weighted_step(pipeline, state, batches[rows], ws[rows], gen,
                                                draws))
            it += kk
            if eval_every_subset_epoch and it % eval_period == 0:
                m = pipeline.evaluate(state.ema_params, test_data, Q, generator=gen, noise=noise)
                eval_history.append(m)
                log.info("epoch %d it %d eval %s", epoch, it, m)
        if epoch != cfg.finetune_epoch - 1:
            Q = pipeline.calibrate(state.ema_params, cal_data.data, Q, generator=gen,
                                   noise=noise)
            log.info("epoch %d Q-hat %.5f", epoch, float(Q))
        losses = [float(v) for v in losses]  # one sync per epoch
        all_metrics.append({
            "epoch": epoch,
            "loss": float(np.mean(losses)) if losses else None,
            "eval_history": eval_history,
            "quantile": float(Q),
        })
        _save_phase(state_dir, state, Q, epoch, all_metrics, cfg)
        if on_epoch is not None:
            on_epoch(all_metrics[-1])
    pipeline.graphs.clear()
    return state, Q, all_metrics


# ---------------------------------------------------------------------------
# Inference-time fine-tuning (InfFT)
# ---------------------------------------------------------------------------

def inference_finetune(
    cfg: BurgersInfFTConfig,
    pipeline: BurgersPipeline,
    params: Params,
    cal_data: BurgersDataset,
    test_data: BurgersDataset,
    state_dir: Optional[str] = None,
    noise: Optional[Iterator] = None,
    on_epoch=None,
):
    """InfFT (reference: 1D/inference/inference_ft.py:228-433). Returns
    (TrainState, Q, epoch records).

    Per epoch: one `infft_step` per test batch (guided sampling with the
    final denoise step differentiable, then MSE(relu(s + Q - bound^2), 0)
    into the weights), a Q-hat recalibration and an evaluation, both on the
    EMA weights. It runs InfFT_iters - 1 epochs: the reference's loop skips
    all work on its final index (run():415-418). `state_dir`, `noise` and
    `on_epoch` as in `posttrain` (noise: each sampler call's draws in
    order). Where `pipeline.graphs.on`, each step is one captured graph
    (`make_infft_step`); the phase's graphs are freed as it ends."""
    ccfg = cfg.conformal
    device = pipeline.device
    lr = periodic_cosine_schedule(
        cfg.finetune_lr, max(int(cfg.InfFT_iters * cfg.cosine_ratio), 1), eta_min=1e-6)
    tx = make_optimizer(cfg.optimizer, lr, weight_decay=cfg.weight_decay, betas=(0.9, 0.999),
                        max_grad_norm=cfg.max_grad_norm)
    state = make_train_state(pipeline, params, tx, cfg.ema_decay, cfg.ema_update_every)
    Q, start_epoch, all_metrics = _restore_phase(state_dir, state, cfg, device)
    step = make_infft_step(pipeline, state)

    for epoch in range(start_epoch, cfg.InfFT_iters - 1):
        gen = _epoch_generator(cfg.seed, epoch, device)
        losses = []
        for lo in range(0, len(test_data), ccfg.test_batch_size):
            batch = torch.as_tensor(test_data.data[lo : lo + ccfg.test_batch_size],
                                    device=device)
            draws = next(noise) if noise is not None else None
            losses.append(step(batch, Q, gen, draws))
        losses = [float(v) for v in losses]
        Q = pipeline.calibrate(state.ema_params, cal_data.data, Q, generator=gen, noise=noise)
        metrics = pipeline.evaluate(state.ema_params, test_data, Q, generator=gen, noise=noise)
        log.info("InfFT epoch %d loss %.5f Q %.5f metrics %s",
                 epoch, float(np.mean(losses)), float(Q), metrics)
        all_metrics.append({"epoch": epoch, "loss": float(np.mean(losses)), "eval": metrics,
                            "quantile": float(Q)})
        _save_phase(state_dir, state, Q, epoch, all_metrics, cfg)
        if on_epoch is not None:
            on_epoch(all_metrics[-1])
    pipeline.graphs.clear()
    return state, Q, all_metrics


# ---------------------------------------------------------------------------
# Fault-tolerant phase wrappers (utils/faults.py)
# ---------------------------------------------------------------------------

def posttrain_resilient(
    cfg: BurgersPostTrainConfig,
    make_pipeline,
    params: Params,
    finetune_data: BurgersDataset,
    cal_data: BurgersDataset,
    test_data: BurgersDataset,
    state_dir: Optional[str] = None,
    fault_retries: int = 2,
    backoff_s: float = 30.0,
    **kw,
):
    """`posttrain` with device-fault handling: the weights are copied to the
    host once, each attempt builds a fresh pipeline from `make_pipeline()`
    and resumes from the last epoch in `state_dir`; a recoverable CUDA fault
    is retried up to `fault_retries` times, a sticky one re-raised at once (a
    new process resumes from `state_dir`)."""
    from safediffcon_torch.utils.faults import resilient_phase

    return resilient_phase(
        make_pipeline,
        lambda pipe, p: posttrain(cfg, pipe, p, finetune_data, cal_data, test_data,
                                  state_dir=state_dir, **kw),
        params, retries=fault_retries, backoff_s=backoff_s, describe="burgers posttrain",
        state_dir=state_dir)


def inference_finetune_resilient(
    cfg: BurgersInfFTConfig,
    make_pipeline,
    params: Params,
    cal_data: BurgersDataset,
    test_data: BurgersDataset,
    state_dir: Optional[str] = None,
    fault_retries: int = 2,
    backoff_s: float = 30.0,
):
    """`inference_finetune` with device-fault handling (see
    `posttrain_resilient`)."""
    from safediffcon_torch.utils.faults import resilient_phase

    return resilient_phase(
        make_pipeline,
        lambda pipe, p: inference_finetune(cfg, pipe, p, cal_data, test_data,
                                           state_dir=state_dir),
        params, retries=fault_retries, backoff_s=backoff_s, describe="burgers InfFT",
        state_dir=state_dir)
