"""The tokamak pipeline's captured calls (calibration batches, evaluations
with the KSTAR rollout, `run_inference`'s post-training and backward
fine-tuning steps as CUDA graphs) against its eager calls, on the CPU
through the graph stand-in (`tests/torch_graph_standin.py`, whose replay
re-runs what the capture recorded on the tensors it recorded). Each case
runs enough calls for warm-up, capture and replays, with a new Q-hat, a new
generator, new weights and targets on the calls after the capture, and a
shorter last calibration chunk: the results, the weights, the Adam state
and the generators' positions must be equal bit for bit."""
import dataclasses

import pytest
import torch

import torch_graph_standin as standin
from tokamak_replay import CONF, PIPE, data, flax_params, sd_from_flax  # noqa: F401
from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakPipeline,
    finetune_config,
    posttrain_config,
    run_inference,
)

torch.set_num_threads(1)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _pipelines(monkeypatch, ccfg: dict, **kw):
    """An eager pipeline and a captured one (the stand-in installed) with
    the same model weights."""
    standin.install(monkeypatch)
    conf = TokamakConformalConfig(**ccfg)
    eager = TokamakPipeline(conf, device="cpu", capture=False, **PIPE, **kw)
    graphed = TokamakPipeline(conf, device="cpu", **PIPE, **kw)
    graphed.model.load_state_dict(eager.model.state_dict())
    return eager, graphed


def _weights(flax_params, scale: float):
    return {k: v * scale for k, v in sd_from_flax(flax_params).items()}


def test_calibrate_captured_equals_eager(monkeypatch, data, flax_params):
    """Four calibrations of 2 x 4 cal sims in chunks of 3 (rows 0-2, 3-5,
    4-6, then a last chunk of 1), the first three on dicts of one layout
    (the seeded weights and two scaled copies), the fourth on the model's
    own, each with a new Q-hat and generator, in train mode with guidance
    (the weight factor squared): Q-hat, the scores and weights, the
    generator's position bit for bit; each graph's calls after its first
    replays."""
    eager, graphed = _pipelines(monkeypatch, dict(CONF, guidance_scaler=5.0), cal_chunk=3)
    eager.record, graphed.record = {}, {}
    for i, (params, q) in enumerate([(sd_from_flax(flax_params), 0.0),
                                     (_weights(flax_params, 0.9), torch.tensor(0.5)),
                                     (_weights(flax_params, 1.1), 0.2),
                                     (None, torch.tensor(0.1))]):
        ge, gg = _gen(i), _gen(i)
        q_e = eager.calibrate(params, data["cal"], q, generator=ge)
        q_g = graphed.calibrate(params, data["cal"], q, generator=gg)
        assert torch.equal(q_e, q_g)
        for k in ("cal_scores", "cal_weights"):
            assert torch.equal(eager.record[k], graphed.record[k])
        assert torch.equal(ge.get_state(), gg.get_state())
    calls = graphed.graphs.calls[("cal",)].graphs.values()
    assert sorted((c.calls, c.graph.replays if c.graph else 0) for _, c in calls) == [
        (1, 0), (3, 2), (3, 2), (9, 8)]


@pytest.mark.parametrize("guided", [False, True])
def test_evaluate_captured_equals_eager(monkeypatch, data, flax_params, guided):
    """Three evaluations of the test split (sampling, the KSTAR rollout,
    the metrics) on three weights dicts with a new Q-hat and generator
    each, guided (the targets a static input) and not: every metric and
    the generator's position bit for bit; the third call a replay."""
    eager, graphed = _pipelines(monkeypatch, dict(CONF, guidance_scaler=5.0))
    for i, (params, q) in enumerate([(sd_from_flax(flax_params), 0.0),
                                     (_weights(flax_params, 1.05), torch.tensor(0.3)),
                                     (_weights(flax_params, 0.95), 0.6)]):
        ge, gg = _gen(20 + i), _gen(20 + i)
        m_e = eager.evaluate(params, data["test"], q, generator=ge, guided=guided)
        m_g = graphed.evaluate(params, data["test"], q, generator=gg, guided=guided)
        assert m_e == m_g
        assert torch.equal(ge.get_state(), gg.get_state())
    assert standin.replays(graphed) == 2


@pytest.mark.parametrize("backward", [False, True])
def test_run_inference_captured_equals_eager(monkeypatch, data, flax_params, backward):
    """Three `run_inference` epochs (calibrate, two post-training steps at
    batch 4 or two backward fine-tuning steps on the test batch, evaluate)
    from the same weights: the Q-hats, losses and metrics of every epoch
    and the final weights bit for bit; the step graph replayed (w_obj 1:
    the backward loss has a gradient, tests/tokamak_replay.py)."""
    base = finetune_config() if backward else posttrain_config()
    conf = dict(CONF, guidance_scaler=base.conformal.guidance_scaler,
                w_obj=1.0 if backward else 0.0)
    cfg = dataclasses.replace(base, finetune_epoch=3, finetune_steps=2, train_batch_size=4,
                              finetune_lr=1e-3, conformal=TokamakConformalConfig(**conf))
    eager, graphed = _pipelines(monkeypatch, conf)
    params = sd_from_flax(flax_params)
    train, cal, test = data["train"], data["cal"], data["test"]
    p_e, q_e, h_e = run_inference(cfg, eager, params, train, cal, test)
    p_g, q_g, h_g = run_inference(cfg, graphed, params, train, cal, test)
    assert torch.equal(q_e, q_g)
    assert h_e == h_g
    assert p_e.keys() == p_g.keys() and all(torch.equal(p_e[k], p_g[k]) for k in p_e)
    assert max(float((p_g[k] - params[k]).abs().max()) for k in params) > 0
    assert all(r["loss"] > 0 for r in h_g)
    # the step's graph: 6 calls, a warm-up, then a capture and replays (5);
    # calibration 2 chunks per epoch (5) and evaluation 1 per epoch (2)
    step = standin.replays(graphed, "backward" if backward else "weighted")
    assert step == 5 and standin.replays(graphed) - step == 7
    assert not graphed.graphs.calls  # freed as the phase ended
