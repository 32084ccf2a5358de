"""The tokamak calibration's test-mode composite weight against the JAX
package: a pipeline of the backward fine-tune after post-training
(`finetune_set="test"`, `wo_post_train=False`, a posttrain Q-hat as
`finetune_quantile`, `finetune_w_obj` / `finetune_w_safe` from
`posttrain_config()`) multiplies each calibration weight by the shift
weight at those settings (`tasks/tokamak/pipeline.py::_cal_batch`, JAX
`safediffcon_tpu/tasks/tokamak/pipeline.py:145-157`). At
`finetune_guidance_scaler` 1.0 (what the round-2 reference-scale run used)
and 5.0 (the posttrain config's, today's script), on the same weights with
JAX's draws replayed: each chunk's scores and weights from `_cal_batch` and
`calibrate`'s Q-hat; and the captured route (`tests/torch_graph_standin.py`)
equal to the eager one bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_graph_standin as standin
from tokamak_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, PIPE, calibrate_noise, data, flax_params, jax_data, sd_from_flax,
)
from safediffcon_tpu.tasks.tokamak import config as JC
from safediffcon_tpu.tasks.tokamak import pipeline as JP
from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakPipeline,
    posttrain_config,
)

torch.set_num_threads(1)

Q = 0.2  # the Q-hat of the epoch's calibration
Q_POSTTRAIN = 0.5  # the posttrain checkpoint's, the composite factor's quantile


def _composite(scaler: float, **kw) -> dict:
    pt = posttrain_config().conformal
    return dict(CONF, finetune_set="test", wo_post_train=False, finetune_quantile=Q_POSTTRAIN,
                finetune_w_obj=pt.w_obj, finetune_w_safe=pt.w_safe,
                finetune_guidance_scaler=scaler, **kw)


def _jax_chunks(jp, params, cal, rng):
    """JAX calibrate's chunks: `rng, key = split(rng)` per chunk, then
    `_cal_batch` on its rows."""
    bs, out = jp.ccfg.cal_batch_size, []
    for i in range(jp.ccfg.num_cal_batch):
        sl = slice(i * bs, (i + 1) * bs)
        rng, key = jax.random.split(rng)
        s, w = jp._cal_batch(params, key, cal.data[sl], cal.state_phys[sl], Q)
        out.append((np.asarray(s), np.asarray(w)))
    return out


@pytest.mark.parametrize("scaler", [1.0, 5.0])
def test_composite_weight_matches_jax(data, flax_params, scaler):
    cal = data["cal"]
    jp = JP.TokamakPipeline(JC.TokamakConformalConfig(**_composite(scaler)), **PIPE)
    q_ref = jp.calibrate(flax_params, jax_data(cal), Q, jax.random.PRNGKey(1))
    ref = _jax_chunks(jp, flax_params, jax_data(cal), jax.random.PRNGKey(1))

    tp = TokamakPipeline(TokamakConformalConfig(**_composite(scaler)), device="cpu", **PIPE)
    params = sd_from_flax(flax_params)
    draws = calibrate_noise(jax.random.PRNGKey(1))
    tp.record = {}
    q = tp.calibrate(params, cal, Q, noise=iter(draws))
    bs = CONF["cal_batch_size"]
    for i, ((s_ref, w_ref), (init, steps)) in enumerate(zip(ref, draws)):
        rows = slice(i * bs, (i + 1) * bs)
        s, w = tp._cal_batch(params, torch.as_tensor(cal.data[rows]),
                             torch.as_tensor(cal.state_phys[rows]), Q, init_noise=init,
                             step_noise=steps)
        # scores: float32 DDIM of the UNet1D (~1e-6 relative, as the
        # pipeline test holds Q-hat to 1e-4); weights: the shift weights of
        # the ground truth, no sampling in them
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(w.numpy(), w_ref, rtol=1e-5, atol=1e-30)
        assert torch.equal(tp.record["cal_scores"][rows], s)
        assert torch.equal(tp.record["cal_weights"][rows], w)
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)

    # the comparison bites: the factor moves the weights, and the scaler moves the factor
    plain = TokamakPipeline(TokamakConformalConfig(**CONF), device="cpu", **PIPE)
    plain.record = {}
    plain.calibrate(params, cal, Q, noise=iter(draws))
    assert torch.equal(plain.record["cal_scores"], tp.record["cal_scores"])
    factor = tp.record["cal_weights"] / plain.record["cal_weights"]
    assert float((factor - 1).abs().max()) > 1e-3
    if scaler != 1.0:
        one = TokamakPipeline(TokamakConformalConfig(**_composite(1.0)), device="cpu", **PIPE)
        one.record = {}
        one.calibrate(params, cal, Q, noise=iter(draws))
        assert not torch.equal(one.record["cal_weights"], tp.record["cal_weights"])


@pytest.mark.parametrize("scaler", [1.0, 5.0])
def test_composite_weight_captured_equals_eager(monkeypatch, data, flax_params, scaler):
    """Two calibrations of 2 x 4 cal sims (four chunk calls: a warm-up,
    the capture, replays) with a new Q-hat and generator each: Q-hat, the
    scores and weights and the generator's position bit for bit."""
    standin.install(monkeypatch)
    conf = TokamakConformalConfig(**_composite(scaler))
    eager = TokamakPipeline(conf, device="cpu", capture=False, **PIPE)
    graphed = TokamakPipeline(conf, device="cpu", **PIPE)
    eager.record, graphed.record = {}, {}
    params = sd_from_flax(flax_params)
    for i, q in enumerate([Q, torch.tensor(0.7)]):
        ge, gg = torch.Generator().manual_seed(i), torch.Generator().manual_seed(i)
        assert torch.equal(eager.calibrate(params, data["cal"], q, generator=ge),
                           graphed.calibrate(params, data["cal"], q, generator=gg))
        for k in ("cal_scores", "cal_weights"):
            assert torch.equal(eager.record[k], graphed.record[k])
        assert torch.equal(ge.get_state(), gg.get_state())
    assert standin.replays(graphed) == 3  # every chunk call after the first
    assert dataclasses.asdict(graphed.ccfg)["finetune_guidance_scaler"] == scaler
