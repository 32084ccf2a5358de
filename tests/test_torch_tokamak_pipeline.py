"""The tokamak serving path against the JAX package on a tiny config
(UNet1D dim 8, DDIM 4 of 8 timesteps, a few closed-loop sims):
`TokamakPipeline.calibrate` and an unguided and a guided `evaluate` (DDIM of
UNet1D -> KSTAR surrogate -> metrics) from the same weights, with the JAX key
chain's draws replayed into the port; the exact `state_dir` resume of
`run_inference`; a sampler the package does not have."""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from tokamak_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, PIPE, calibrate_noise, check_metrics, data, flax_params, jax_data, sampler_noise,
    sd_from_flax,
)
from safediffcon_tpu.tasks.tokamak import config as JC
from safediffcon_tpu.tasks.tokamak import pipeline as JP
from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakPipeline,
    posttrain_config,
    run_inference,
)
from safediffcon_torch.tasks.tokamak.pipeline import init_params

torch.set_num_threads(1)


def test_calibrate_and_evaluate_match_jax(data, flax_params):
    cal, test = data["cal"], data["test"]
    jp = JP.TokamakPipeline(JC.TokamakConformalConfig(**CONF), **PIPE)
    q_ref = jp.calibrate(flax_params, jax_data(cal), 0.0, jax.random.PRNGKey(1))
    m_ref = jp.evaluate(flax_params, jax_data(test), q_ref, jax.random.PRNGKey(2))
    g_ref = jp.evaluate(flax_params, jax_data(test), q_ref, jax.random.PRNGKey(3), guided=True)

    tp = TokamakPipeline(TokamakConformalConfig(**CONF), device="cpu", **PIPE)
    params = sd_from_flax(flax_params)
    q = tp.calibrate(params, cal, 0.0, noise=iter(calibrate_noise(jax.random.PRNGKey(1))))
    m = tp.evaluate(params, test, q, noise=iter([sampler_noise(jax.random.PRNGKey(2))]))
    g = tp.evaluate(params, test, q, guided=True,
                    noise=iter([sampler_noise(jax.random.PRNGKey(3))]))
    # float32 UNet1D + sampler (~1e-6 relative), then the surrogate, whose
    # 1e-3 action quantisation turns that into up to ~1e-4 of a metric
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    check_metrics(m, m_ref, rtol=1e-3)
    check_metrics(g, g_ref, rtol=1e-3)
    # the comparisons bite: a nonzero quantile, and guidance moves the samples
    assert float(q) > 0 and m["obj_mse_mean"] > 0
    assert abs(g["safety_score_mean"] - m["safety_score_mean"]) > 1e-3


def test_run_inference_state_dir_resume_is_exact(data, tmp_path):
    """A run resumed after a lost epoch equals an uninterrupted one: the
    weights, Adam moments and Q persist per epoch, and each epoch's draws
    depend on (seed, epoch) only."""
    cfg = dataclasses.replace(posttrain_config(), conformal=TokamakConformalConfig(**CONF),
                              finetune_epoch=2, train_batch_size=4)
    tp = TokamakPipeline(cfg.conformal, device="cpu", **PIPE)
    start = {k: v.clone() for k, v in init_params(tp.model, seed=3).state_dict().items()}
    train, cal, test = data["train"], data["cal"], data["test"]
    d = str(tmp_path / "state")
    pa, qa, ha = run_inference(cfg, tp, start, train, cal, test, state_dir=d)
    assert sorted(os.listdir(d)) == ["ckpt-0.pt", "ckpt-1.pt", "history.json"]
    os.remove(os.path.join(d, "ckpt-1.pt"))  # epoch 1 was lost
    seen = []
    pb, qb, hb = run_inference(cfg, tp, start, train, cal, test, state_dir=d,
                               on_epoch=seen.append)
    assert [h["epoch"] for h in hb] == [0, 1] and hb == ha and seen == hb
    assert float(qa) == float(qb)
    for name, v in pa.items():
        assert torch.equal(v, pb[name]), name
    assert any(not torch.equal(v, start[name]) for name, v in pa.items())


def test_unported_sampler_raises():
    with pytest.raises(ValueError):
        TokamakPipeline(TokamakConformalConfig(**CONF, sampler="unipc"), device="cpu", **PIPE)
