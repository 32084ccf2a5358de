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
    1e-6). It updates the parameters in place. "sgd" is optax's
    `sgd(lr, momentum=0.9)`: trace m <- g + 0.9 m (the first m is g, no
    Nesterov), update -lr * m, after the same optional clip.
  - `periodic_cosine_schedule`, `warmup_cosine_schedule`: the closed forms
    of torch's CosineAnnealingLR and of the posttrain SequentialLR, in
    float32 as JAX computes them.
  - `TrainState`: the step, the model (whose parameters are the trained
    weights), the optimizer state and an EMA of the weights (0.995, applied
    when the new step count is a multiple of 10).
  - `make_diffusion_train_step` (one optimizer update on the reweighted
    denoising loss) and `chunked_train_steps` (k of them in one call).
  - `accumulated_grads`, `run_train_loop` (the numpy batch order of the JAX
    loop, checkpoint cadence, wall-clock deadline, `steps_per_call` chunks
    and the bfloat16 `device_pool`).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from safediffcon_torch.core.diffusion import DiffusionConfig, draw_t_noise, p_losses
from safediffcon_torch.core.schedules import DiffusionSchedule
from safediffcon_torch.parallel import mesh as pmesh

log = logging.getLogger(__name__)

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

    def tensors(self) -> List[torch.Tensor]:
        return self.mu + self.nu

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

    n_scalars = 3

    def scalars(self, count: int) -> np.ndarray:
        """The values of the update that follows `count` updates which
        depend on the count, float32 as JAX computes them: -lr (the schedule
        sees the count before its increment) and the bias corrections
        1 - b1^(count + 1), 1 - b2^(count + 1)."""
        lr = np.float32(self.lr(count) if callable(self.lr) else self.lr)
        c = np.float32(count + 1)
        return np.array([-lr, np.float32(1) - np.float32(self.b1) ** c,
                         np.float32(1) - np.float32(self.b2) ** c], np.float32)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdamState, scalars: Optional[torch.Tensor] = None) -> None:
        """Apply one update to `params` and `state` in place. `scalars` is a
        device tensor holding `self.scalars(state.count)` (a row of a
        captured CUDA graph's table, read at replay); the caller then
        advances `state.count`. Without it the step writes that row itself
        and advances the count."""
        grads = _clip_by_global_norm(list(grads), self.max_grad_norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        if scalars is None:
            # the same values as device scalars: CUDA divides by a Python
            # float as a product with its reciprocal, a 0-d tensor (as JAX
            # does) by a true division
            scalars = _fill(self.scalars(state.count), state.mu[0].device)
            state.count += 1
        neg_lr, bc1, bc2 = scalars.unbind()
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(list(params), self.weight_decay))
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(list(params), upd)


def _fill(values: np.ndarray, device) -> torch.Tensor:
    """float32 `values` as a tensor on `device`, written by fill kernels (a
    copy from host memory would wait for the card)."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g * max_norm / |g| where |g| >= max_norm,
    no epsilon; a no-op when max_norm is 0."""
    if not (max_norm and max_norm > 0):
        return grads
    g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


@dataclasses.dataclass
class SGDState:
    """optax's sgd state: the update count (for a schedule) and the momentum
    trace, one tensor per parameter."""

    count: int
    trace: List[torch.Tensor]

    def state_dict(self) -> dict:
        return {"count": self.count, "trace": self.trace}

    def tensors(self) -> List[torch.Tensor]:
        return list(self.trace)

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        for dst, src in zip(self.trace, list(d["trace"])):
            dst.copy_(src)


class SGD:
    """optax.chain(clip_by_global_norm(max_grad_norm), sgd(lr, momentum)), or
    sgd alone when max_grad_norm is 0: m <- g + momentum * m (m starts at 0,
    so the first m is g; no Nesterov), then params += -lr * m."""

    def __init__(self, lr: Schedule, momentum: float = 0.9, max_grad_norm: float = 0.0):
        self.lr, self.momentum, self.max_grad_norm = lr, momentum, max_grad_norm

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        return SGDState(0, [torch.zeros_like(p) for p in params])

    n_scalars = 1

    def scalars(self, count: int) -> np.ndarray:
        """-lr of the update that follows `count` updates, float32."""
        return np.array([-np.float32(self.lr(count) if callable(self.lr) else self.lr)],
                        np.float32)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: SGDState, scalars: Optional[torch.Tensor] = None) -> None:
        """Apply one update to `params` and `state` in place; `scalars` as
        in `Adam.step`."""
        grads = _clip_by_global_norm(list(grads), self.max_grad_norm)
        torch._foreach_mul_(state.trace, self.momentum)
        torch._foreach_add_(state.trace, grads)
        if scalars is None:
            neg_lr = float(self.scalars(state.count)[0])
            state.count += 1
        else:
            neg_lr = scalars[0]
        upd = torch._foreach_mul(state.trace, neg_lr)
        torch._foreach_add_(list(params), upd)


Optimizer = Union[Adam, SGD]


def make_optimizer(kind: str = "adam", lr: Schedule = 1e-5, weight_decay: float = 1e-4,
                   betas=(0.9, 0.99), max_grad_norm: float = 1.0) -> Optimizer:
    """The JAX factory: "adam", "adamw" (weight_decay is used by "adamw"
    only) and "sgd" (momentum 0.9; betas and weight_decay unused)."""
    if kind in ("adam", "adamw"):
        return Adam(lr, b1=betas[0], b2=betas[1], max_grad_norm=max_grad_norm,
                    weight_decay=weight_decay if kind == "adamw" else 0.0)
    if kind == "sgd":
        return SGD(lr, momentum=0.9, max_grad_norm=max_grad_norm)
    raise ValueError(f"unknown optimizer {kind!r}")


# ---------------------------------------------------------------------------
# Train state with EMA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: Optimizer
    opt_state: Union[AdamState, SGDState]
    ema_params: Dict[str, torch.Tensor]
    ema_decay: float = 0.995
    ema_update_every: int = 10

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer, ema_decay: float = 0.995,
               ema_update_every: int = 10) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, model=model, tx=tx, opt_state=tx.init(list(params.values())),
                   ema_params={k: p.detach().clone() for k, p in params.items()},
                   ema_decay=ema_decay, ema_update_every=ema_update_every)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        scalars: Optional[torch.Tensor] = None) -> "TrainState":
        """One optimizer update in place; the EMA moves every
        `ema_update_every` steps (reference EMA(beta=0.995, update_every=10),
        1D/model/trainer.py:87).

        `scalars`, a device row of `scalar_table`, holds the step's
        count-dependent values: the optimizer's, then the EMA's factors
        (decay, 1 - decay) on an EMA step and (1, 0) otherwise, which every
        step applies (JAX's `jnp.where(do_ema, ...)`), so that a captured
        CUDA graph serves every step. The caller then advances `step` and
        the optimizer's count (`advance`)."""
        params = list(self.model.parameters())
        ema = list(self.ema_params.values())
        if scalars is not None:
            n = self.tx.n_scalars
            self.tx.step(params, grads, self.opt_state, scalars[:n])
            torch._foreach_mul_(ema, scalars[n])
            torch._foreach_add_(ema, torch._foreach_mul(params, scalars[n + 1]))
            return self
        self.tx.step(params, grads, self.opt_state)
        self.step += 1
        if self.step % self.ema_update_every == 0:
            d = self.ema_decay
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - d))
        return self

    def scalar_table(self, k: int) -> np.ndarray:
        """(k, tx.n_scalars + 2) float32: the `scalars` rows of the next k
        steps from this state."""
        d = np.float32(self.ema_decay)
        rows = []
        for i in range(k):
            ema = ((d, np.float32(1.0 - self.ema_decay))
                   if (self.step + i + 1) % self.ema_update_every == 0
                   else (np.float32(1), np.float32(0)))
            rows.append(np.concatenate([self.tx.scalars(self.opt_state.count + i), ema]))
        return np.stack(rows).astype(np.float32)

    def tensors(self) -> List[torch.Tensor]:
        """The model's tensors, the optimizer's and the EMA: what a step
        reads and updates in place."""
        return (list(self.model.parameters()) + list(self.model.buffers())
                + self.opt_state.tensors() + list(self.ema_params.values()))

    def advance(self, k: int) -> None:
        """Count k steps that ran on device scalars."""
        self.step += k
        self.opt_state.count += k

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


def make_diffusion_train_step(apply_fn: Callable, sched: DiffusionSchedule,
                              cfg: DiffusionConfig, cond=None) -> Callable:
    """The step (state, batch, weights=None, generator=None, t=None,
    noise=None) -> loss: one optimizer update of `state` in place on the
    denoising loss of `batch`, each sample's loss times `weights` (the
    conformal post-training loss, reference:
    1D/posttrain/post_train.py:206-210; None for pretraining). `apply_fn(x,
    t)` runs `state.model`. Timesteps and noise come from `generator`, or
    are handed in."""

    def step(state: TrainState, batch: torch.Tensor, weights: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, t=None, noise=None) -> torch.Tensor:
        if t is None or noise is None:
            t, noise = draw_t_noise(cfg, batch, generator)
        per_sample = p_losses(apply_fn, sched, cfg, batch, t, noise, cond)
        if weights is not None:
            per_sample = per_sample * weights
        loss = per_sample.mean()
        state.apply_gradients(torch.autograd.grad(loss, list(state.model.parameters())))
        return loss.detach()

    return step


def chunked_train_steps(step_fn: Callable, k: int) -> Callable:
    """k optimizer steps in one call: multi(state, batches, generator=None,
    noise=None) runs `step_fn` (a `make_diffusion_train_step` step) on each
    of the k batches of `batches` (k, B, ...) in order, the i-th with the
    i-th (t, noise) of `noise` when given, and returns the mean of the k
    losses. JAX fuses the k steps into one dispatch (`lax.scan`); here they
    are k steps back to back. The counterpart of that one dispatch is
    `run_train_loop(steps_per_call=k, capture=True)`, which replays the k
    steps as one CUDA graph."""

    def multi(state: TrainState, batches: torch.Tensor,
              generator: Optional[torch.Generator] = None, noise=None) -> torch.Tensor:
        if batches.shape[0] != k:
            raise ValueError(f"batches hold {batches.shape[0]} steps, not {k}")
        draws = iter(noise) if noise is not None else None
        losses = []
        for i in range(k):
            t, n = next(draws) if draws is not None else (None, None)
            losses.append(step_fn(state, batches[i], generator=generator, t=t, noise=n))
        return torch.stack(losses).mean()

    return multi


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

def graphs_on(device: torch.device) -> bool:
    """Whether work on `device` runs as captured CUDA graphs: on CUDA
    devices only (a CPU tensor takes the eager, plain path)."""
    return torch.device(device).type == "cuda"


def _cloned(out):
    """`out` (tensors in nested tuples, lists and dicts) with each tensor
    copied."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _cloned(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_cloned(v) for v in out)
    return out


class CapturedCall:
    """A call `fn()` as one CUDA graph, the counterpart of one jitted JAX
    program. `fn` reads and writes only tensors that outlive it: static
    inputs that the caller refills before each call, the weights and state
    it updates in place; it returns its outputs. Each call is handed the
    same `fn` (it is not kept: a graph that held its owner through `fn`
    would keep its memory until the garbage collector ran).

    The first `warm_calls` calls run `fn` eagerly on the graph's side
    stream, as warm-up: they are the caller's own work, and they set up
    what a capture must not (library handles and workspaces, host-side
    caches). The next call captures `fn` (with `generators` registered, so
    that a replay draws what an eager call would and moves each generator's
    offset as far) and replays it; each later call replays the graph. A
    failed capture raises; nothing falls back to eager work. Every call
    returns its outputs as new tensors: a replay overwrites the graph's
    own, and so may a replay of another graph in the same memory `pool`
    (a `torch.cuda.graph_pool_handle()`; None: a pool of its own)."""

    def __init__(self, device, warm_calls: int = 1,
                 generators: Sequence[torch.Generator] = (), pool=None):
        self.warm_calls = warm_calls
        # a data-parallel rank's sliced generator draws from the one it wraps
        self.generators = [g.generator if isinstance(g, pmesh.SlicedGenerator) else g
                           for g in generators]
        self.pool = pool
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.out = None

    def __call__(self, fn: Callable):
        current = torch.cuda.current_stream()
        if self.graph is not None:
            self.graph.replay()
        elif self.calls < self.warm_calls:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.out = fn()
            current.wait_stream(self.stream)
        else:
            # the warm-up's cached blocks back to the card, for the pool
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            kw = {} if self.pool is None else {"pool": self.pool}
            if dist.is_available() and dist.is_initialized():
                # NCCL's watchdog thread queries its events while a rank
                # captures, which a global capture would refuse
                kw["capture_error_mode"] = "thread_local"
            with torch.cuda.graph(graph, stream=self.stream, **kw):
                self.out = fn()
            self.graph = graph
            graph.replay()
        self.calls += 1
        return _cloned(self.out)


def _host(value):
    """A numpy array as a CPU tensor; anything else as it is."""
    return torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value


def _static_like(value, device):
    """A static buffer for `value`: a tensor like it on `device` (a numpy
    array as its tensor), a 0-d float32 tensor for a number, an (n, ...)
    tensor for a non-empty list of equal tensors, a dict of such buffers
    for a dict."""
    value = _host(value)
    if isinstance(value, dict):
        return {k: _static_like(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        if not value:
            return []
        return torch.empty((len(value),) + tuple(value[0].shape), dtype=value[0].dtype,
                           device=device)
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value, device=device)
    return torch.empty((), dtype=torch.float32, device=device)


@torch.no_grad()
def _refill(buf, value) -> None:
    """Copy `value` into its static buffer, without waiting for the card
    (a host source is staged by the copy)."""
    value = _host(value)
    if isinstance(buf, dict):
        torch._foreach_copy_(list(buf.values()), [value[k] for k in buf])
    elif isinstance(buf, list):
        pass  # no draws
    elif isinstance(value, (list, tuple)):
        torch.stack(list(value), out=buf)
    elif isinstance(value, torch.Tensor):
        buf.copy_(value, non_blocking=True)
    else:
        buf.fill_(float(value))


def _signature(value):
    value = _host(value)
    if isinstance(value, dict):
        return tuple(sorted((k, _signature(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return (len(value),) + (_signature(value[0]) if value else ())
    if isinstance(value, torch.Tensor):
        # the layout too: kernels (a conv's) depend on their operands' strides
        return (tuple(value.shape), value.dtype, value.stride())
    return ((), torch.float32, ())  # a number's buffer


class StaticCall:
    """Calls `fn(**inputs)` as `CapturedCall`s on static copies of their
    inputs, one graph per signature of the inputs (their kinds, shapes,
    dtypes and strides: a last, shorter batch gets a graph of its own).
    Each call copies the values it is given into buffers made like the
    first ones of that signature (a tensor or numpy array as a tensor on
    the device, a number as a 0-d float32 tensor, a list of equal tensors,
    such as a sampler's step draws, stacked, a dict of tensors, such as
    weights, tensor by tensor) and runs or replays `fn` on the buffers (a
    list as the list of its rows). `fn`, the same function on every call,
    must read nothing else that changes between calls. The graphs take
    their memory from `pool` (`CapturedCall`)."""

    def __init__(self, device, pool=None):
        self.device, self.pool = torch.device(device), pool
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, fn: Callable, **inputs):
        key = _signature(inputs)
        if key not in self.graphs:
            self.graphs[key] = ({k: _static_like(v, self.device) for k, v in inputs.items()},
                                CapturedCall(self.device, pool=self.pool))
        bufs, call = self.graphs[key]
        for k, v in inputs.items():
            _refill(bufs[k], v)
        lists = {k for k, v in inputs.items() if isinstance(v, (list, tuple))}
        return call(lambda: fn(**{k: list(b) if k in lists else b for k, b in bufs.items()}))


class Graphs:
    """The captured calls of one pipeline: whether a call runs as a CUDA
    graph (`on`), and a `StaticCall` per kind of call (`__call__`). The
    graphs share one memory pool: they never run at once, and each call
    copies its outputs out of the pool before the next one runs. `clear`
    frees them all, as a phase ends."""

    def __init__(self, device, capture: bool, name: str):
        self.device, self.capture, self.name = torch.device(device), capture, name
        self.calls: Dict[tuple, StaticCall] = {}
        self._pool = None
        self._split_logged = False

    def on(self, sh: pmesh.BatchShard) -> bool:
        """Whether a call on a batch split as `sh` runs as a graph: with
        `capture`, on a CUDA device, in one process or split over an NCCL
        group, whose collectives the graph holds (`pmesh.graph_collectives`).
        A batch split over another backend (gloo) runs eagerly, which the
        log says once. The answer depends on the group and the flags alone,
        so every rank takes the same route."""
        if not (self.capture and graphs_on(self.device)):
            return False
        if sh.split and not pmesh.graph_collectives(sh.group):
            if not self._split_logged:
                log.info("%s: eager calls (a CUDA graph holds NCCL collectives only, not "
                         "those of these %d ranks)", self.name, sh.dp)
                self._split_logged = True
            return False
        return True

    @property
    def pool(self):
        """The graphs' memory pool (a new one after `clear`)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def __call__(self, kind, fn: Callable, writes: Sequence[torch.Tensor] = (), **inputs):
        """`fn(**inputs)` as the `StaticCall` of `kind` and of the tensors
        `fn` updates in place (`writes`, by address: that is what a replay
        writes)."""
        key = (kind,) + tuple(t.data_ptr() for t in writes)
        if key not in self.calls:
            self.calls[key] = StaticCall(self.device, self.pool)
        return self.calls[key](fn, **inputs)

    def counts(self) -> Dict[str, int]:
        """What the calls since `clear` ran as: `graphs` captured (a call
        whose signature came once ran eagerly, as its warm-up) and the
        `replays` after each capture."""
        past = [c.calls - c.warm_calls for sc in self.calls.values()
                for _, c in sc.graphs.values() if c.calls > c.warm_calls]
        return dict(graphs=len(past), replays=sum(n - 1 for n in past))

    def clear(self) -> None:
        self.calls.clear()
        self._pool = None


class ChunkGraph:
    """k training steps as one CUDA graph, the counterpart of JAX's jitted
    step (k = 1) and `lax.scan` chunk: `step_fn(state, batch, scalars=row,
    **rows)` k times on static buffers, `batches` (k * take, ...) float32,
    the (k, n) step-value table of `TrainState.scalar_table` and, for each
    entry name: (per-sample shape, dtype) of `extra`, a (k * take, ...)
    buffer `inputs[name]` whose step rows step_fn takes as that keyword
    (post-training's per-sample weights and draws); each step's loss is
    written into a static (k,) output.

    `run` takes the batches and inputs already copied into their buffers
    and the table set by `set_table`, and runs a `CapturedCall` of the k
    steps: its warm-up calls are at least 3 steps (the run's own steps),
    `generators` are the generators the steps draw from, `pool` its
    memory pool (`CapturedCall`)."""

    WARM_STEPS = 3

    def __init__(self, step_fn: Callable, state: TrainState, k: int, batch_shape: tuple,
                 generators: Sequence[torch.Generator] = (),
                 extra: Optional[Dict[str, Tuple[tuple, torch.dtype]]] = None, pool=None):
        device = next(state.model.parameters()).device
        self.step_fn, self.state, self.k, self.take = step_fn, state, k, batch_shape[0]
        self.batches = torch.empty((k * batch_shape[0],) + tuple(batch_shape[1:]),
                                   dtype=torch.float32, device=device)
        self.inputs = {name: torch.empty((k * self.take,) + tuple(shape), dtype=dtype,
                                         device=device)
                       for name, (shape, dtype) in (extra or {}).items()}
        n = state.tx.n_scalars + 2
        self.table = torch.empty((k, n), dtype=torch.float32, device=device)
        self._table_host = torch.empty((k, n), dtype=torch.float32,
                                       pin_memory=device.type == "cuda")
        self._table_copied: Optional[torch.cuda.Event] = None
        self.losses = torch.empty((k,), dtype=torch.float32, device=device)
        self.call = CapturedCall(device, -(-self.WARM_STEPS // k), generators, pool)

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return self.call.graph

    @property
    def warm_steps(self) -> int:
        return min(self.call.calls, self.call.warm_calls) * self.k

    def set_table(self) -> None:
        """Copy the next k steps' values into `table`."""
        if self._table_copied is not None:
            self._table_copied.synchronize()  # the last copy has left the buffer
        self._table_host.numpy()[:] = self.state.scalar_table(self.k)
        self.table.copy_(self._table_host, non_blocking=True)
        self._table_copied = torch.cuda.Event()
        self._table_copied.record()

    def _steps(self) -> None:
        for i in range(self.k):
            rows = slice(i * self.take, (i + 1) * self.take)
            loss = self.step_fn(self.state, self.batches[rows], scalars=self.table[i],
                                **{name: buf[rows] for name, buf in self.inputs.items()})
            self.losses[i].copy_(loss)

    def run(self) -> torch.Tensor:
        """The chunk's k steps; returns their losses (a new tensor)."""
        self.call(self._steps)
        self.state.advance(self.k)
        return self.losses.clone()


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
    shard: Optional[pmesh.BatchShard] = None,
    capture: bool = False,
    generators: Sequence[torch.Generator] = (),
) -> TrainState:
    """The JAX package's epoch-less training loop (reference: Trainer loop,
    1D/model/trainer.py:150-210), one optimizer step per call of
    `step_fn(state, batch) -> loss`, where batch is a float32 tensor of
    `batch_take` samples on the model's device.

    Steps run in chunks of kk = min(steps_per_call, steps left), clamped to
    the next multiple of `checkpoint_every` when checkpoints are written.
    A chunk's indices are one slice of a numpy permutation of the data: the
    first from `default_rng(seed + start_step)`, each reshuffle from
    `default_rng(seed + step + need)` with `step` the chunk's first step,
    exactly as in JAX (so the batches differ from steps_per_call = 1 where
    a reshuffle falls inside a chunk). A chunk's kk batches cross to the
    device in one copy from a reused (pinned, on CUDA) host buffer and its
    steps run back to back; losses stay on the device until a log boundary.
    A checkpoint is written whenever the step crosses a multiple of
    `checkpoint_every`, and at the last step reached. `deadline` (absolute
    `time.time()` seconds) is tested at chunk boundaries. When `losses` is a
    list, each step's loss (a device tensor, no sync) is appended to it.

    `device_pool` > 0 holds min(device_pool, n) samples, drawn by
    `default_rng(seed + 7 + salt).choice(n, pool, replace=False)`, on the
    device in bfloat16; a chunk sends only its (kk, B) indices, each batch is
    gathered on the device and cast to float32. When the pool is smaller
    than the data it is re-drawn every `pool_refresh_every` steps (default
    max(1, 3 * pool // batch_take)) with salt = the step, and the order is
    re-permuted from `default_rng(seed + step + 13)`.

    `shard` (`parallel.mesh.batch_shard` of the micro-batch size) splits
    each micro-batch over the data ranks: every rank draws the same global
    indices and takes its rows of each micro-batch, so `step_fn` gets
    batch_take / dp samples (micro-batch by micro-batch) and reduces its
    gradients with the same shard. The device pool is whole on every rank.
    The parameters and their EMA are broadcast from rank 0 first.

    `capture` (the counterpart of JAX's jitted step and `lax.scan` chunk):
    on a CUDA model, every full chunk of `steps_per_call` steps is one CUDA
    graph (`ChunkGraph`), captured once and replayed with the same batches,
    draws and step values as the eager loop; a data-parallel split over an
    NCCL group captures the gradient all-reduce with the steps. `step_fn`
    then takes `scalars=` (its step's device row of
    `TrainState.scalar_table`) for `apply_gradients`, and `generators` are
    the CUDA generators it draws from. A chunk shorter than
    `steps_per_call` (the last, or one clamped at a checkpoint) runs
    eagerly. CPU models run eagerly, and so does a split over gloo, whose
    collectives run on the host, which the log says once."""
    if checkpoint_dir:
        from safediffcon_torch.utils.checkpoint import save_checkpoint
    device = next(state.model.parameters()).device
    cuda = device.type == "cuda"
    k = max(int(steps_per_call), 1)
    n_data = data.shape[0]
    sample_shape = tuple(data.shape[1:])
    copied: Optional[torch.cuda.Event] = None
    split = shard is not None and shard.split
    if split:
        if batch_take % shard.n:
            raise ValueError(f"batch_take {batch_take} is not a whole number of "
                             f"{shard.n}-sample micro-batches")
        pmesh.maybe_replicate(list(state.model.parameters()) + list(state.ema_params.values()))
        if logger:
            logger.info("%s: data-parallel over %d ranks (batch %d, %d per rank)", log_prefix,
                        shard.dp, batch_take, batch_take // shard.dp)
    take = batch_take // shard.dp if split else batch_take

    def rows(sel: np.ndarray) -> np.ndarray:
        """This rank's rows of each micro-batch of the drawn indices."""
        if not split:
            return sel
        return sel.reshape(-1, shard.n)[:, shard.lo : shard.hi].reshape(-1)

    pool_dev = None
    if device_pool and device_pool > 0 and start_step < num_steps:
        pool = min(int(device_pool), n_data)
        # staging buffers allocated once: the float32 gather, its bfloat16
        # cast (pinned on CUDA) and the device pool, refilled in place
        stage_f32 = np.empty((pool,) + sample_shape, np.float32)
        stage_bf16 = torch.empty((pool,) + sample_shape, dtype=torch.bfloat16, pin_memory=cuda)
        pool_dev = torch.empty((pool,) + sample_shape, dtype=torch.bfloat16, device=device)

        def draw_pool(salt: int) -> None:
            ids = np.random.default_rng(seed + 7 + salt).choice(n_data, pool, replace=False)
            if cuda:
                torch.cuda.current_stream(device).synchronize()  # the last copy is done
            np.take(np.asarray(data), ids, axis=0, out=stage_f32)
            stage_bf16.copy_(torch.from_numpy(stage_f32))  # round to nearest even
            pool_dev.copy_(stage_bf16, non_blocking=cuda)

        draw_pool(start_step)
        if pool >= n_data:
            pool_refresh_every = 0
        elif pool_refresh_every <= 0:
            pool_refresh_every = max(1, 3 * pool // batch_take)
        if logger:
            logger.info("%s: pinned %d/%d samples (%.2f GB bf16) in device memory%s",
                        log_prefix, pool, n_data, pool_dev.nbytes / 1e9,
                        f", refreshed every {pool_refresh_every} steps"
                        if pool_refresh_every else "")
        n = pool
    else:
        n = n_data
        host = torch.empty((k * take,) + sample_shape, dtype=torch.float32,
                           pin_memory=cuda)
        host_np = host.numpy()

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

    def to_device(sel, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The chunk's batches, (len(sel), ...) float32 on the device, in one
        host-to-device copy (into `out` when given)."""
        nonlocal copied
        if pool_dev is not None:
            idx = torch.as_tensor(sel, dtype=torch.long).to(device, non_blocking=False)
            return pool_dev[idx].float() if out is None else out.copy_(pool_dev[idx])
        if copied is not None:
            copied.synchronize()  # the previous chunk's copy has left the buffer
        m = len(sel)
        np.take(np.asarray(data), sel, axis=0, out=host_np[:m])
        if out is None:
            out = host[:m].to(device, non_blocking=cuda)
        else:
            out.copy_(host[:m], non_blocking=cuda)
        if cuda:
            copied = torch.cuda.Event()
            copied.record()
        return out

    graph = None
    if capture and graphs_on(device):
        if split and not pmesh.graph_collectives(shard.group):
            if logger:
                logger.info("%s: eager steps (a CUDA graph holds NCCL collectives only, not "
                            "those of these %d ranks)", log_prefix, shard.dp)
        else:
            graph = ChunkGraph(step_fn, state, k, (take,) + sample_shape, generators)

    t0 = time.time()
    pending: List[torch.Tensor] = []
    last_log = start_step
    last_ckpt = start_step
    last_pool = start_step
    while step < num_steps:
        if deadline is not None and time.time() >= deadline:
            if logger:
                logger.info("%s: wall-clock deadline reached at step %d/%d — stopping and "
                            "checkpointing", log_prefix, step, num_steps)
            break
        kk = min(k, num_steps - step)
        if checkpoint_dir and checkpoint_every < 10**9:
            # milestones stay exact multiples of the cadence
            kk = min(kk, (step // checkpoint_every + 1) * checkpoint_every - step)
        if pool_dev is not None and pool_refresh_every and step - last_pool >= pool_refresh_every:
            draw_pool(step)
            order = np.random.default_rng(seed + step + 13).permutation(n)
            pos = 0
            last_pool = step
            if logger:
                logger.info("%s: refreshed device pool at step %d", log_prefix, step)
        sel = rows(draw(batch_take * kk))
        if graph is not None and kk == k:
            graph.set_table()
            to_device(sel, out=graph.batches)
            chunk = graph.run()
        else:
            batches = to_device(sel)
            chunk = (step_fn(state, batches[i * take : (i + 1) * take]) for i in range(kk))
        for loss in chunk:
            if losses is not None:
                losses.append(loss)
            if logger:
                pending.append(loss)
        chunk = batches = None  # the eager chunk's batches go before the next copy
        step += kk
        if logger and step - last_log >= log_every:
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
