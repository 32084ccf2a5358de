"""Optimizers, learning-rate schedules, train state with EMA, gradient
accumulation, and the shared pretrain loop.

Port of `safediffcon_tpu/core/train.py` (reference: 1D/model/trainer.py:21-210,
1D/posttrain/post_train.py:52-104):

  - `make_optimizer("adam" | "adamw", ...)`: optax's `adam` (b1, b2, eps
    1e-8), or `adamw` (the same plus weight_decay * param, before the
    learning rate), after an optional `clip_by_global_norm`, written to
    optax's formulas (the learning rate schedule sees the update count
    before its increment; bias corrections are float32 powers; the clip
    scale is max_norm / |g| with no epsilon, where `clip_grad_norm_` adds
    1e-6). It updates the parameters in place. "sgd" is not ported.
  - `periodic_cosine_schedule`, `warmup_cosine_schedule`: the closed forms
    of torch's CosineAnnealingLR and of the posttrain SequentialLR, in
    float32 as JAX computes them.
  - `TrainState`: the step, the model (whose parameters are the trained
    weights), the optimizer state and an EMA of the weights (0.995, applied
    when the new step count is a multiple of 10).
  - `accumulated_grads`, `run_train_loop` (the numpy batch order of the JAX
    loop, checkpoint cadence, wall-clock deadline).

`steps_per_call`, `device_pool` and `pool_refresh_every` of the JAX loop
amortise TPU dispatch and are not ported: other values than their defaults
raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Schedule = Union[float, Callable[[int], float]]


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def periodic_cosine_schedule(base_lr: float, t_max: int, eta_min: float = 0.0):
    """torch.optim.CosineAnnealingLR closed form, periodic past t_max
    (reference: 1D/model/trainer.py:81), in float32 as JAX computes it."""
    f = np.float32

    def schedule(step: int) -> float:
        cos = np.cos(f(np.pi) * f(step) / f(t_max))
        return float(f(eta_min) + f(base_lr - eta_min) * (f(1) + cos) / f(2))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, cosine_t_max: int,
                           eta_min: float = 1e-6):
    """Linear warmup, then a cosine anneal whose step count restarts at the
    warmup milestone: SequentialLR(LambdaLR(warmup), CosineAnnealingLR(T_max))
    (reference: 1D/posttrain/post_train.py:72-81), in float32."""
    f = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return float(f(base_lr) * f(step) / f(max(warmup_steps, 1)))
        cos = np.cos(f(np.pi) * f(step - warmup_steps) / f(cosine_t_max))
        return float(f(eta_min) + f(base_lr - eta_min) * (f(1) + cos) / f(2))

    return schedule


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """optax ScaleByAdamState: the update count and the two moments, one
    tensor per parameter in the order the optimizer was given them."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        for dst, src in zip(self.mu + self.nu, list(d["mu"]) + list(d["nu"])):
            dst.copy_(src)


class Adam:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, b1, b2)), or
    adam alone when max_grad_norm is 0; with weight_decay > 0 optax's adamw,
    whose update adds weight_decay * param to Adam's before the learning
    rate. `lr` is a float or a schedule of the update count."""

    def __init__(self, lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 max_grad_norm: float = 0.0, weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdamState) -> None:
        """Apply one update to `params` and `state` in place."""
        grads = list(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, g / g_norm * self.max_grad_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        # the schedule sees the count before its increment; float32 scalars,
        # as JAX computes them
        lr = float(np.float32(self.lr(state.count) if callable(self.lr) else self.lr))
        state.count += 1
        c = np.float32(state.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(list(params), self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(list(params), upd)


def make_optimizer(kind: str = "adam", lr: Schedule = 1e-5, weight_decay: float = 1e-4,
                   betas=(0.9, 0.99), max_grad_norm: float = 1.0) -> Adam:
    """The JAX factory's "adam" and "adamw" (weight_decay is used by "adamw"
    only); "sgd" is on no ported path and is not ported yet."""
    if kind in ("adam", "adamw"):
        return Adam(lr, b1=betas[0], b2=betas[1], max_grad_norm=max_grad_norm,
                    weight_decay=weight_decay if kind == "adamw" else 0.0)
    if kind == "sgd":
        raise NotImplementedError(f"optimizer {kind!r} is not ported yet")
    raise ValueError(f"unknown optimizer {kind!r}")


# ---------------------------------------------------------------------------
# Train state with EMA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Adam
    opt_state: AdamState
    ema_params: Dict[str, torch.Tensor]
    ema_decay: float = 0.995
    ema_update_every: int = 10

    @classmethod
    def create(cls, model: nn.Module, tx: Adam, ema_decay: float = 0.995,
               ema_update_every: int = 10) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, model=model, tx=tx, opt_state=tx.init(list(params.values())),
                   ema_params={k: p.detach().clone() for k, p in params.items()},
                   ema_decay=ema_decay, ema_update_every=ema_update_every)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One optimizer update in place; the EMA moves every
        `ema_update_every` steps (reference EMA(beta=0.995, update_every=10),
        1D/model/trainer.py:87)."""
        params = list(self.model.parameters())
        self.tx.step(params, grads, self.opt_state)
        self.step += 1
        if self.step % self.ema_update_every == 0:
            d = self.ema_decay
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - d))
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.model.state_dict(),
                "opt_state": self.opt_state.state_dict(), "ema_params": self.ema_params}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        self.model.load_state_dict(d["params"])
        self.opt_state.load_state_dict(d["opt_state"])
        for k, v in d["ema_params"].items():
            self.ema_params[k].copy_(v)


def accumulated_grads(loss_fn: Callable[[int, torch.Tensor], torch.Tensor],
                      params: Sequence[torch.Tensor],
                      batches: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Gradient accumulation over the k micro-batches of `batches` (k, B, ...)
    (reference: Trainer gradient_accumulate_every, 1D/model/trainer.py:28,163).
    `loss_fn(i, batch)` is micro-batch i's scalar loss; losses and gradients
    are averaged over the k micro-batches, each divided by k and summed in
    order, as the JAX scan does."""
    k = batches.shape[0]
    params = list(params)
    loss = torch.zeros((), device=batches.device)
    grads = [torch.zeros_like(p) for p in params]
    for i in range(k):
        li = loss_fn(i, batches[i])
        gi = torch.autograd.grad(li, params)
        loss = loss + li.detach() / k
        torch._foreach_add_(grads, torch._foreach_div(list(gi), k))
    return loss, grads


# ---------------------------------------------------------------------------
# Shared pretrain loop
# ---------------------------------------------------------------------------

def run_train_loop(
    step_fn: Callable[[TrainState, torch.Tensor], torch.Tensor],
    state: TrainState,
    data: np.ndarray,
    *,
    batch_take: int,
    num_steps: int,
    start_step: int = 0,
    seed: int = 0,
    steps_per_call: int = 1,
    log_every: int = 500,
    checkpoint_every: int = 10**9,
    checkpoint_dir: Optional[str] = None,
    logger=None,
    log_prefix: str = "pretrain",
    device_pool: int = 0,
    pool_refresh_every: int = 0,
    deadline: Optional[float] = None,
    losses: Optional[list] = None,
) -> TrainState:
    """The JAX package's epoch-less training loop (reference: Trainer loop,
    1D/model/trainer.py:150-210), one optimizer step per call of
    `step_fn(state, batch) -> loss`.

    Batches are slices of a numpy permutation of `data`: the first from
    `default_rng(seed + start_step)`, each reshuffle from
    `default_rng(seed + step + need)`, exactly as in JAX, and are copied to
    the model's device step by step. A checkpoint is written whenever the step
    crosses a multiple of `checkpoint_every`, and at the last step reached.
    `deadline` (absolute `time.time()` seconds) stops the loop before the
    first step at or after it. When `losses` is a list, each step's loss (a
    device tensor, no sync) is appended to it."""
    if steps_per_call != 1 or device_pool != 0 or pool_refresh_every != 0:
        raise NotImplementedError(
            "steps_per_call, device_pool and pool_refresh_every amortise TPU dispatch and "
            "are not ported; leave them at 1, 0 and 0")
    if checkpoint_dir:
        from safediffcon_torch.utils.checkpoint import save_checkpoint
    device = next(state.model.parameters()).device

    n = data.shape[0]
    order = np.random.default_rng(seed + start_step).permutation(n)
    pos = 0
    step = start_step

    def draw(count):
        nonlocal order, pos
        out = []
        need = count
        while need > 0:
            if pos >= n:
                order = np.random.default_rng(seed + step + need).permutation(n)
                pos = 0
            got = order[pos : pos + need]
            pos += len(got)
            need -= len(got)
            out.append(got)
        return np.concatenate(out) if len(out) > 1 else out[0]

    t0 = time.time()
    pending: List[torch.Tensor] = []
    last_log = start_step
    last_ckpt = start_step
    while step < num_steps:
        if deadline is not None and time.time() >= deadline:
            if logger:
                logger.info("%s: wall-clock deadline reached at step %d/%d — stopping and "
                            "checkpointing", log_prefix, step, num_steps)
            break
        sel = draw(batch_take)
        batch = torch.as_tensor(np.asarray(data[sel]), device=device)
        loss = step_fn(state, batch)
        step += 1
        if losses is not None:
            losses.append(loss)
        if logger:
            pending.append(loss)
            if step - last_log >= log_every:
                mean = float(torch.stack(pending).mean())
                pending.clear()
                logger.info("%s step %d loss %.5f (%.1f steps/s)", log_prefix, step, mean,
                            (step - start_step) / (time.time() - t0))
                last_log = step
        if checkpoint_dir and step // checkpoint_every > last_ckpt // checkpoint_every:
            save_checkpoint(checkpoint_dir, state, step)
            last_ckpt = step
    if checkpoint_dir and step > start_step and last_ckpt != step:
        save_checkpoint(checkpoint_dir, state, step)
    return state
