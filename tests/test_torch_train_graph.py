"""The training step on device scalars and as a captured chunk
(`core/train.py`), on the CPU: the device-scalar Adam / AdamW / SGD and EMA
equal the host-scalar path bit for bit; the step-value table of a chunk
equals the values the eager steps use, through checkpoint-clamped chunks;
and `ChunkGraph` (warm-up, capture, replays) run through stand-ins for the
CUDA stream and graph calls equals the eager steps of the tokamak pretrain
bit for bit, draws included. The card runs the real capture in
`chip_smoke.py` phase 15."""
import contextlib

import numpy as np
import pytest
import torch

from safediffcon_torch.core.train import (
    ChunkGraph,
    TrainState,
    make_optimizer,
    periodic_cosine_schedule,
)
from safediffcon_torch.tasks.tokamak import TokamakPretrainConfig
from safediffcon_torch.tasks.tokamak import pipeline as TP
from safediffcon_torch.tasks.tokamak.data import TokamakDataset

torch.set_num_threads(1)

STEPS = 25
EMA_EVERY = 10  # the chunks below do not divide it


def _model(seed: int = 0) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))


def _grads(model, steps: int):
    """Seeded gradients per step, some of them past the clip's norm."""
    rng = np.random.default_rng(1)
    return [[torch.from_numpy((rng.normal(size=p.shape) * (0.2 + s % 3)).astype(np.float32))
             for p in model.parameters()] for s in range(steps)]


def _state(kind: str) -> TrainState:
    tx = make_optimizer(kind, periodic_cosine_schedule(1e-2, 7), weight_decay=1e-2,
                        betas=(0.9, 0.99), max_grad_norm=1.0)
    return TrainState.create(_model(), tx, ema_decay=0.9, ema_update_every=EMA_EVERY)


def _opt_tensors(state):
    o = state.opt_state
    return (o.mu + o.nu) if hasattr(o, "mu") else o.trace


def _assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(list(a.model.parameters()) + list(a.ema_params.values()) + _opt_tensors(a),
                    list(b.model.parameters()) + list(b.ema_params.values()) + _opt_tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_device_scalars_equal_host_path(kind):
    """25 steps on a cosine schedule with the clip active on some of them,
    host scalars against table rows in chunks of 4 (the EMA moves at steps
    10 and 20, inside chunks): bit for bit."""
    host, dev = _state(kind), _state(kind)
    start = {k: v.clone() for k, v in host.ema_params.items()}
    grads = _grads(host.model, STEPS)
    for g in grads:
        host.apply_gradients(g)
    step = 0
    while step < STEPS:
        n = min(4, STEPS - step)
        table = torch.from_numpy(dev.scalar_table(n))
        for i in range(n):
            dev.apply_gradients(grads[step + i], table[i])
        dev.advance(n)
        step += n
    assert host.step == STEPS
    _assert_states_equal(host, dev)
    assert any(not torch.equal(start[k], v) for k, v in dev.ema_params.items())


def test_scalar_table_follows_the_eager_steps_through_clamped_chunks():
    """The rows of each chunk of steps_per_call 7 clamped at checkpoints
    every 10 steps (chunks 7, 3, 7, 3, 5, as `run_train_loop` cuts them):
    -lr from the schedule at the update count, the float32 bias
    corrections of the next count, and the EMA factors exactly on the steps
    where the eager EMA moves."""
    state = _state("adam")
    schedule = periodic_cosine_schedule(1e-2, 7)
    grads = _grads(state.model, STEPS)
    f = np.float32
    step, sizes = 0, []
    while step < STEPS:
        kk = min(7, STEPS - step, (step // 10 + 1) * 10 - step)
        sizes.append(kk)
        table = state.scalar_table(kk)
        assert table.dtype == np.float32 and table.shape == (kk, 5)
        for i in range(kk):
            s = step + i
            expect = [-f(schedule(s)), f(1) - f(0.9) ** f(s + 1), f(1) - f(0.99) ** f(s + 1)]
            np.testing.assert_array_equal(table[i, :3], np.array(expect, np.float32))
            before = {k: v.clone() for k, v in state.ema_params.items()}
            state.apply_gradients(grads[s])
            moved = any(not torch.equal(before[k], v) for k, v in state.ema_params.items())
            ema_step = (s + 1) % EMA_EVERY == 0
            assert moved == ema_step
            np.testing.assert_array_equal(table[i, 3:], np.array(
                [0.9, 1.0 - 0.9] if ema_step else [1, 0], np.float32))
        step += kk
    assert sizes == [7, 3, 7, 3, 5]


class _Stream:
    def wait_stream(self, other):
        pass


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph: a replay runs the captured body
    (set by the test) again."""

    body = None

    def __init__(self):
        self.generators = []
        self.replays = 0

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.replays += 1
        type(self).body()


@contextlib.contextmanager
def _capture(snapshot, restore):
    """A stand-in for torch.cuda.graph: capturing runs nothing, so the
    state and the generators are put back as they were."""

    def cm(graph, stream=None):
        saved = snapshot()
        yield
        restore(saved)

    yield contextlib.contextmanager(cm)


@pytest.fixture
def tokamak_step(monkeypatch):
    """The tokamak pretrain's step, state and generator (a tiny UNet1D on
    the CPU), taken where `pretrain` hands them to the loop."""
    got = {}

    def loop(step_fn, state, data, **kw):
        got.update(step_fn=step_fn, state=state, generator=kw["generators"][0], kw=kw)
        return state

    monkeypatch.setattr(TP, "run_train_loop", loop)
    cfg = TokamakPretrainConfig(dim=8, dim_mults=(1, 2), timesteps=20, batch_size=2,
                                cosine_t_max=5, checkpoint_every=10**9)
    data = np.random.default_rng(0).normal(size=(6, 128, 12)).astype(np.float32)
    TP.pretrain(cfg, TokamakDataset(data=data, state_phys=data[:, :122, :3]), num_steps=12,
                device="cpu")
    return got


def test_chunk_graph_equals_eager_steps(tokamak_step, monkeypatch):
    """12 steps of the tokamak pretrain in chunks of 4: eagerly on host
    scalars, and through ChunkGraph (a warm-up chunk, the capture and
    replay of the second, a replay of the third) with the CUDA calls stood
    in for: the losses, the weights, the EMA (moved at step 10), the Adam
    moments, the counts and the generator's position bit for bit."""
    step_fn, state, gen = (tokamak_step[k] for k in ("step_fn", "state", "generator"))
    k, take = 4, 2
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.normal(size=(k * take, 128, 12)).astype(np.float32))
               for _ in range(3)]
    tensors = (list(state.model.parameters()) + list(state.ema_params.values())
               + _opt_tensors(state))
    start = [t.clone() for t in tensors]
    gen_start = gen.get_state()

    eager = []
    for b in batches:
        eager += [step_fn(state, b[i * take : (i + 1) * take]) for i in range(k)]
    after = [t.clone() for t in tensors]
    counts = (state.step, state.opt_state.count)
    gen_after = gen.get_state()
    assert counts == (12, 12)

    # the same 12 steps again from the same start, through ChunkGraph
    with torch.no_grad():
        for t, s in zip(tensors, start):
            t.copy_(s)
    state.step = state.opt_state.count = 0
    gen.set_state(gen_start)

    def snapshot():
        return [t.clone() for t in tensors], gen.get_state()

    def restore(saved):
        with torch.no_grad():
            for t, s in zip(tensors, saved[0]):
                t.copy_(s)
        gen.set_state(saved[1])

    with _capture(snapshot, restore) as graph_cm:
        monkeypatch.setattr(torch.cuda, "graph", graph_cm)
        monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
        monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "Event", _Event)
        cg = ChunkGraph(step_fn, state, k, (take, 128, 12), generators=[gen])
        monkeypatch.setattr(_Graph, "body", cg._steps)
        graphed = []
        for b in batches:
            cg.set_table()
            cg.batches.copy_(b)
            graphed += list(cg.run())
    assert cg.warm_steps == k and cg.graph.replays == 2
    assert cg.graph.generators == [gen]
    assert (state.step, state.opt_state.count) == counts
    assert torch.equal(torch.stack(graphed), torch.stack(eager))
    for t, a in zip(tensors, after):
        assert torch.equal(t, a)
    assert torch.equal(gen.get_state(), gen_after)
    assert any(not torch.equal(e, s) for e, s in zip(
        list(state.ema_params.values()), start[len(list(state.model.parameters())):]))
