"""The captured-call machinery of `core/train.py` (`CapturedCall`,
`StaticCall`, `Graphs`) and the samplers as whole captured calls
(`core/sampling.py`), on the CPU through the graph stand-in
(`tests/torch_graph_standin.py`): the warm-up, capture and replay sequence;
a failed capture raises and nothing falls back to eager work; a host read
inside a capture is refused; a value that is not a static input stays as
it was captured (what the pipelines' tests rely on to show a forgotten
refill); a pipeline's graph table (its gate, keys, shared pool and
`clear`); and DDIM (guided, with the final-step gradient), DPM-Solver++
(plain and noise-matched) and the ancestral sampler, captured whole on
draws taken by `sampler_draws` and the schedule's host tables, equal their
eager calls bit for bit and leave the generator where they do."""
import numpy as np
import pytest
import torch

import torch_graph_standin as standin
from safediffcon_torch.core import sampling as TS
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.core.train import CapturedCall, Graphs, StaticCall
from safediffcon_torch.parallel import mesh as pmesh
from safediffcon_torch.tasks.burgers import task as TK

torch.set_num_threads(1)

SHAPE = (2, 16, 8, 3)


def test_warm_up_capture_then_replays(monkeypatch):
    """Two warm-up calls run eagerly, the third captures and replays, the
    rest replay; each call returns new tensors."""
    standin.install(monkeypatch)
    x = torch.zeros(3)
    call = CapturedCall("cpu", warm_calls=2)
    outs = [call(lambda: x.add_(1.0) * 2) for _ in range(5)]
    assert [float(o[0]) for o in outs] == [2.0, 4.0, 6.0, 8.0, 10.0]
    assert call.graph.replays == 3 and float(x[0]) == 5.0
    assert len({id(o) for o in outs}) == 5


def test_failed_capture_raises(monkeypatch):
    """A call that fails inside its capture raises, leaves no graph and
    runs nothing eagerly in its place; a host read inside a capture is a
    failure (as a synchronisation inside a CUDA capture is)."""
    standin.install(monkeypatch)
    x = torch.ones(2)
    ran = []

    def fn():
        ran.append(1)
        return x * float(x.sum())

    call = CapturedCall("cpu", warm_calls=1)
    call(fn)
    with pytest.raises(RuntimeError, match="inside a captured call"):
        call(fn)
    assert call.graph is None and len(ran) == 2


def test_replay_reads_only_static_inputs(monkeypatch):
    """A StaticCall refills its buffers on each call; a Python value the
    function reads itself is frozen at the capture, so the stand-in shows
    a per-call value that is not a static input."""
    standin.install(monkeypatch)
    scale = {"v": 1.0}
    call = StaticCall("cpu")

    def fn(x, q):
        return x * q * scale["v"]

    got = []
    for i in range(4):
        scale["v"] = float(i + 1)
        got.append(float(call(fn, x=torch.tensor(2.0), q=float(i))))
    # the value read at the capture (the second call, 2.0) stays
    assert got == [0.0, 4.0, 8.0, 12.0]
    x = torch.arange(3.0)
    assert torch.equal(call(fn, x=x, q=torch.tensor(0.5)), x * 0.5 * 4.0)  # a new shape: eager


def _cond(seed=0):
    rng = np.random.default_rng(seed)
    u0, uT = (0.5 * rng.normal(size=(2, SHAPE[0], SHAPE[2]))).astype(np.float32)
    return TK.BurgersConditioner(u0=torch.from_numpy(u0), uT=torch.from_numpy(uT))


def _denoiser(a):
    return lambda x, t: 1.5 * torch.tanh(x * a + 0.01 * t[:, None, None, None])


@pytest.mark.parametrize("name, kw", [
    ("ddim_guided_final_grad", dict(sampler=TS.ddim_sample, steps=6, eta=1.0, guided=True,
                                    final_step_grad=True)),
    ("dpm", dict(sampler=TS.dpm_solver_sample, steps=5)),
    ("dpm_noise_matched", dict(sampler=TS.dpm_solver_sample, steps=5, matched=True)),
    ("ancestral", dict(sampler=TS.sample, steps=None, timesteps=12)),
])
def test_sampler_captured_whole_equals_eager(monkeypatch, name, kw):
    """Three calls of one sampler through a StaticCall (warm-up, capture,
    replay) on draws from `sampler_draws`, each with a new generator, new
    conditions, a new Q in the guidance and new weights, against the eager
    sampler drawing from its generator: the samples (and with the final-step
    gradient, the gradient of their sum with respect to the denoiser's
    weight) bit for bit, the generators at the same place."""
    standin.install(monkeypatch)
    T = kw.get("timesteps", 100)
    cfg = DiffusionConfig(timesteps=T, sampling_timesteps=kw["steps"], ddim_eta=kw.get("eta", 0.0),
                          beta_schedule="cosine", noise_matched_cond=kw.get("matched", False))
    sched = make_schedule(T, "cosine", device="cpu")
    task = TK.BurgersTaskConfig(w_score=5.0)
    sampler = kw["sampler"]
    fsg = kw.get("final_step_grad", False)

    def run(a, q, u0, uT, **draws):
        cond = TK.BurgersConditioner(u0=u0, uT=uT)
        g = TK.guidance_grad_fn(q, task) if kw.get("guided") else None
        out = sampler(_denoiser(a), sched, cfg, SHAPE, cond=cond, guidance_grad=g,
                      final_step_grad=fsg, **draws)
        if fsg:
            return out, torch.autograd.grad(out.sum(), a)[0]
        return out

    # the weight the captured calls bind, updated in place between calls
    # (as a fine-tuned model's)
    weight = torch.zeros((), requires_grad=fsg)
    graphed = StaticCall("cpu")
    for i in range(3):
        cond = _cond(i)
        a = torch.tensor(0.7 + 0.1 * i, requires_grad=fsg)
        with torch.no_grad():
            weight.copy_(a)
        q = torch.tensor(12.0 - i)
        ge, gg = torch.Generator().manual_seed(i), torch.Generator().manual_seed(i)
        eager = run(a, q, cond.u0, cond.uT, generator=ge)
        init, steps = TS.sampler_draws(sampler, cfg, SHAPE, gg, "cpu")
        got = graphed(lambda q, u0, uT, init, steps: run(
            weight, q, u0, uT, init_noise=init, step_noise=steps),
            q=q, u0=cond.u0, uT=cond.uT, init=init, steps=steps)
        for e, g in zip(eager if fsg else [eager], got if fsg else [got]):
            assert torch.equal(e, g)
        assert torch.equal(ge.get_state(), gg.get_state())
    (_, call), = graphed.graphs.values()
    assert call.graph.replays == 2


def test_schedule_host_tables():
    """The schedule's host tables, from which the samplers take their
    per-step coefficients, hold the device tables' float32 values."""
    sched = make_schedule(10, "cosine", device="cpu")
    assert sched.host.keys() == {"alphas", "alphas_prev", "alphas_cumprod"}
    for name, table in sched.host.items():
        assert table.dtype == np.float32
        np.testing.assert_array_equal(table, getattr(sched, name).numpy())


class _Shard:
    def __init__(self, dp):
        # no process group: a split batch cannot hold its collectives
        self.dp, self.split, self.group = dp, dp > 1, None


def test_graphs_gate_calls_and_clear(monkeypatch, caplog):
    """`Graphs`: off without `capture` and for a batch split over ranks
    whose collectives a graph cannot hold (logged once), on for one split
    over NCCL;
    one StaticCall per kind and per set of tensors written in place, all
    on one pool; `counts` of graphs captured and replayed; `clear` frees
    them and the next call takes a new pool."""
    standin.install(monkeypatch)
    assert not Graphs("cpu", False, "p").on(_Shard(1))
    graphs = Graphs("cpu", True, "p")
    with caplog.at_level("INFO", logger="safediffcon_torch.core.train"):
        assert graphs.on(_Shard(1))
        assert not graphs.on(_Shard(2)) and not graphs.on(_Shard(2))
    assert sum("eager calls" in r.getMessage() for r in caplog.records) == 1
    monkeypatch.setattr(pmesh, "graph_collectives", lambda group: True)  # an NCCL group
    assert graphs.on(_Shard(2)) and graphs.on(_Shard(1))
    a, b = torch.zeros(2), torch.zeros(2)

    def step(x, w):
        w.add_(x)
        return w * 2

    for w in (a, a, a, b):
        graphs("step", lambda x: step(x, w), writes=[w], x=torch.ones(2))
    graphs("other", lambda x: x + 1, x=torch.ones(2))
    assert set(graphs.calls) == {("step", a.data_ptr()), ("step", b.data_ptr()), ("other",)}
    assert float(a[0]) == 3.0 and float(b[0]) == 1.0
    pool = graphs.pool
    assert all(c.pool is pool for c in graphs.calls.values())
    # a's three calls: warm-up, capture, one replay; b's and other's one call, eager
    assert graphs.counts() == dict(graphs=1, replays=1)
    graphs.clear()
    assert not graphs.calls and graphs.pool is not pool
    assert graphs.counts() == dict(graphs=0, replays=0)
