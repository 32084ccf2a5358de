"""The Burgers pipeline's captured calls (calibration batches, evaluations,
post-training chunks, InfFT steps as CUDA graphs) against its eager calls,
on the CPU through the graph stand-in (`tests/torch_graph_standin.py`): a
replay re-runs what the capture recorded on the tensors it recorded, so a
per-call value left out of the static buffers shows as a mismatch. Each
case runs enough calls for warm-up, capture and replays, with a new Q-hat,
a new generator and a new weights dict on the calls after the capture, and
a shorter last calibration chunk; the results, the weights, the optimizer
state and the generators' positions must be equal bit for bit. The last
case holds a two-epoch post-training run through the captured route
against the JAX package's, as the eager test does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_graph_standin as standin
from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, calibrate_noise, check_metrics, compare_params, data, flax_params,
    sampler_noise, sd_from_flax, train_draws,
)
from safediffcon_torch.tasks.burgers import pipeline as BP
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig,
    BurgersInfFTConfig,
    BurgersPipeline,
    BurgersPostTrainConfig,
    inference_finetune,
    posttrain,
)

torch.set_num_threads(1)


def _weights(flax_params, scale: float):
    """A new weights dict: the seeded weights, every tensor scaled."""
    return {k: v * scale for k, v in sd_from_flax(flax_params).items()}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _pipelines(monkeypatch, ccfg: dict, **kw):
    """An eager pipeline and a captured one (the stand-in installed) with
    the same model weights."""
    standin.install(monkeypatch)
    conf = BurgersConformalConfig(**ccfg)
    eager = BurgersPipeline(conf, device="cpu", capture=False, **PIPE, **kw)
    graphed = BurgersPipeline(conf, device="cpu", **PIPE, **kw)
    graphed.model.load_state_dict(eager.model.state_dict())
    return eager, graphed


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def test_calibrate_captured_equals_eager(monkeypatch, data, flax_params):
    """Four calibrations of 2 x 4 cal sims in chunks of 3 (chunks of 3
    rows and a last one of 1: a graph each), on four weights dicts (the seeded weights,
    two new dicts of other values in the same layout, then the model's own,
    whose layout gets graphs of its own), with a new Q-hat and a new
    generator each: Q-hat, the per-sample scores and weights, and the
    generator's position bit for bit; each graph replayed."""
    eager, graphed = _pipelines(monkeypatch, CONF, cal_chunk=3)
    eager.record, graphed.record = {}, {}
    cal = data["cal"].data
    for i, (params, q) in enumerate([(sd_from_flax(flax_params), 0.0),
                                     (_weights(flax_params, 0.9), torch.tensor(0.7)),
                                     (_weights(flax_params, 1.1), 0.4),
                                     (None, torch.tensor(0.3))]):
        ge, gg = _gen(i), _gen(i)
        q_e = eager.calibrate(params, cal, q, generator=ge)
        q_g = graphed.calibrate(params, cal, q, generator=gg)
        assert torch.equal(q_e, q_g)
        _assert_same(eager.record, graphed.record)
        assert torch.equal(ge.get_state(), gg.get_state())
    # chunks of 3 rows at 0, 3, 4 and of 1 at 7 (`calibrate`'s walk); a
    # graph per chunk shape and weights layout, each call after its first
    # a replay
    calls = graphed.graphs.calls[("cal",)].graphs.values()
    assert sorted((c.calls, c.graph.replays if c.graph else 0) for _, c in calls) == [
        (1, 0), (3, 2), (3, 2), (9, 8)]


@pytest.mark.parametrize("guided", [True, False])
def test_evaluate_captured_equals_eager(monkeypatch, data, flax_params, guided):
    """Three evaluations of the test split on three weights dicts with a
    new Q-hat and generator each: the metrics and the generator's position
    bit for bit; the third call a replay."""
    eager, graphed = _pipelines(monkeypatch, CONF)
    for i, (params, q) in enumerate([(sd_from_flax(flax_params), 0.2),
                                     (_weights(flax_params, 1.1), torch.tensor(0.5)),
                                     (_weights(flax_params, 0.8), 0.05)]):
        ge, gg = _gen(10 + i), _gen(10 + i)
        m_e = eager.evaluate(params, data["test"], q, generator=ge, guided=guided)
        m_g = graphed.evaluate(params, data["test"], q, generator=gg, guided=guided)
        assert m_e == m_g
        assert torch.equal(ge.get_state(), gg.get_state())
    assert standin.replays(graphed) == 2


def _states_equal(a, b):
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    for x, y in zip(list(a.model.parameters()) + list(a.ema_params.values())
                    + a.opt_state.mu + a.opt_state.nu,
                    list(b.model.parameters()) + list(b.ema_params.values())
                    + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)


def test_posttrain_captured_equals_eager(monkeypatch, data, flax_params):
    """Three epochs of 5 steps at batch 4 in chunks of 2, an evaluation
    every 2 steps (chunks 2, 2, 1: the last eager), a recalibration between
    epochs: the losses, evaluations and Q-hats of every epoch, the weights,
    EMA and AdamW moments bit for bit; the chunk graph captured after its
    warm-up steps and replayed; the phase's graphs freed as it ends."""
    eager, graphed = _pipelines(monkeypatch, CONF)
    cfg = BurgersPostTrainConfig(conformal=BurgersConformalConfig(**CONF), finetune_epoch=3,
                                 finetune_steps=5, finetune_batch_size=4,
                                 finetune_subset_size=8, finetune_lr=1e-3, steps_per_call=2)
    graphs = []
    chunk_graph = BP.ChunkGraph

    def recorded(*a, **kw):
        graphs.append(chunk_graph(*a, **kw))
        return graphs[-1]

    params = sd_from_flax(flax_params)
    train, cal, test = data["train"], data["cal"], data["test"]
    st_e, q_e, hist_e = posttrain(cfg, eager, params, train, cal, test)
    monkeypatch.setattr(BP, "ChunkGraph", recorded)
    st_g, q_g, hist_g = posttrain(cfg, graphed, params, train, cal, test)
    assert torch.equal(q_e, q_g)
    _assert_same(hist_e, hist_g)
    _states_equal(st_e, st_g)
    (cg,) = graphs
    assert cg.warm_steps == 4 and cg.graph.replays == 4  # 6 full chunks
    assert standin.replays(graphed) > 0
    assert not graphed.graphs.calls  # freed as the phase ended


def _unclipped_safety(sd):
    """InfFT's amax loss has no gradient where random weights clip the s
    channel (tests/test_torch_burgers_infft.py): a small final conv with a
    bias on the s output."""
    sd = dict(sd)
    sd["final_conv.weight"] = sd["final_conv.weight"] * 0.01
    bias = sd["final_conv.bias"].clone()
    bias[2] = 2.0
    sd["final_conv.bias"] = bias
    return sd


def test_inference_finetune_captured_equals_eager(monkeypatch, data, flax_params):
    """Three InfFT epochs (a step, a calibration and an evaluation each)
    from weights whose loss has a gradient: the losses, Q-hats and metrics,
    the weights, EMA and moments bit for bit; the step graph replayed."""
    eager, graphed = _pipelines(monkeypatch, dict(CONF, w_score=2.0))
    cfg = BurgersInfFTConfig(conformal=BurgersConformalConfig(**dict(CONF, w_score=2.0)),
                             InfFT_iters=4, finetune_lr=1e-3)
    params = _unclipped_safety(sd_from_flax(flax_params))
    st_e, q_e, hist_e = inference_finetune(cfg, eager, params, data["cal"], data["test"])
    st_g, q_g, hist_g = inference_finetune(cfg, graphed, params, data["cal"], data["test"])
    assert torch.equal(q_e, q_g)
    _assert_same(hist_e, hist_g)
    _states_equal(st_e, st_g)
    assert any(r["loss"] > 0 for r in hist_g)
    assert max(float((p.detach() - params[k]).abs().max())
               for k, p in st_g.model.named_parameters()) > 0
    assert standin.replays(graphed, "infft") == 2  # 3 steps: warm-up, capture, replay


def test_posttrain_captured_matches_jax(monkeypatch, data, flax_params):
    """`tests/test_torch_burgers_posttrain.py::test_posttrain_matches_jax`
    through the captured route: 2 epochs of 1 step, an evaluation after
    each, a recalibration between them, JAX's draws replayed, at that
    test's tolerances."""
    from safediffcon_tpu.tasks.burgers import config as JC
    from safediffcon_tpu.tasks.burgers import data as JD
    from safediffcon_tpu.tasks.burgers import pipeline as JP

    ccfg = dict(CONF, w_score=2.0)
    pt = dict(finetune_epoch=2, finetune_steps=1, finetune_batch_size=4,
              finetune_subset_size=4, finetune_lr=1e-3)
    train, cal, test = data["train"], data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**ccfg), **PIPE)
    jcfg = JC.BurgersPostTrainConfig(conformal=JC.BurgersConformalConfig(**ccfg), **pt)
    jds = {k: JD.BurgersDataset(v.data, v.u_phys, v.f_phys) for k, v in data.items()}
    jstate, q_ref, hist_ref = JP.posttrain(jcfg, jp, jax.tree_util.tree_map(jnp.asarray,
                                                                            flax_params),
                                           jds["train"], jds["cal"], jds["test"])

    cfg = BurgersPostTrainConfig(conformal=BurgersConformalConfig(**ccfg), **pt)
    base, noise = jax.random.PRNGKey(cfg.seed), []
    shape = (4, 16, NX, 3)
    for epoch in range(2):
        rng = jax.random.fold_in(base, epoch)
        rng, key = jax.random.split(rng)
        noise.append(train_draws(jax.random.split(key, 1)[0], shape, CONF["timesteps"]))
        rng, key = jax.random.split(rng)
        noise.append(sampler_noise(key, test.data.shape))
        if epoch == 0:
            rng, key = jax.random.split(rng)
            noise.extend(calibrate_noise(key, 2, shape))
    noise = iter(noise)
    standin.install(monkeypatch)
    tp = BurgersPipeline(cfg.conformal, device="cpu", **PIPE)
    state, q, hist = posttrain(cfg, tp, sd_from_flax(flax_params), train, cal, test, noise=noise)
    assert next(noise, None) is None
    assert standin.replays(tp) > 0  # the second evaluation and calibration chunk

    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    assert float(q) > 0
    for rec, ref in zip(hist, hist_ref, strict=True):
        np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(rec["quantile"], ref["quantile"], rtol=1e-4)
        for m, m_ref in zip(rec["eval_history"], ref["eval_history"], strict=True):
            check_metrics(m, m_ref, flips=1)
    assert state.step == int(jstate.step) == 2
    compare_params(state.model.state_dict(), jstate.params, flax_params, pt["finetune_lr"])
