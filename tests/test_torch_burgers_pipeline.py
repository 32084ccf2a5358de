"""The Burgers serving path against the JAX package on a tiny config (UNet2D
dim 16, a few sims at the task's 128 cells): `BurgersPipeline.calibrate` +
guided `evaluate` (DDIM of UNet2D -> FD solver -> metrics) from the same
weights, with the JAX key chain's draws replayed into the port; the exact
`state_dir` resume of post-training; the loop options (`steps_per_call`)."""
import os

import numpy as np
import jax
import pytest
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, calibrate_noise, check_metrics, data, flax_params, sampler_noise,
    sd_from_flax,
)
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig,
    BurgersPipeline,
    BurgersPostTrainConfig,
    BurgersPretrainConfig,
    posttrain,
    pretrain,
)
from safediffcon_torch.tasks.burgers.pipeline import init_params

torch.set_num_threads(1)


def test_calibrate_and_evaluate_match_jax(data, flax_params):
    cal, test = data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**CONF), **PIPE)
    q_ref = jp.calibrate(flax_params, cal.data, 0.0, jax.random.PRNGKey(1))
    m_ref = jp.evaluate(flax_params, JD.BurgersDataset(test.data, test.u_phys, test.f_phys),
                        q_ref, jax.random.PRNGKey(2))

    tp = BurgersPipeline(BurgersConformalConfig(**CONF), device="cpu", **PIPE)
    params = sd_from_flax(flax_params)
    shape = (CONF["cal_batch_size"], 16, NX, 3)
    q = tp.calibrate(params, cal.data, 0.0,
                     noise=iter(calibrate_noise(jax.random.PRNGKey(1), 2, shape)))
    m = tp.evaluate(params, test, q,
                    noise=iter([sampler_noise(jax.random.PRNGKey(2), test.data.shape)]))
    # float32 UNet2D + sampler: ~1e-6 relative
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    check_metrics(m, m_ref)
    # the comparisons bite: a nonzero quantile, J and a violation rate in (0, 1)
    assert float(q) > 0 and m["control_mse_mean (J)"] > 0
    assert 0 < m["point_exceed_ratio (R_p)"] < 1


def test_posttrain_state_dir_resume_is_exact(data, tmp_path):
    """A run resumed after a lost epoch equals an uninterrupted one: the
    TrainState and Q persist per epoch, and each epoch's draws depend on
    (seed, epoch) only."""
    cfg = BurgersPostTrainConfig(conformal=BurgersConformalConfig(**CONF), finetune_epoch=2,
                                 finetune_steps=2, finetune_batch_size=4,
                                 finetune_subset_size=8)
    tp = BurgersPipeline(cfg.conformal, device="cpu", **PIPE)
    init_params(tp.model, seed=3)
    train, cal, test = data["train"], data["cal"], data["test"]
    d = str(tmp_path / "pt_state")
    sa, qa, ha = posttrain(cfg, tp, None, train, cal, test, state_dir=d)
    assert sorted(os.listdir(d)) == ["ckpt-0.pt", "ckpt-1.pt", "history.json"]
    os.remove(os.path.join(d, "ckpt-1.pt"))  # epoch 1 was lost
    sb, qb, hb = posttrain(cfg, tp, None, train, cal, test, state_dir=d)
    assert [h["epoch"] for h in hb] == [0, 1] and hb == ha
    assert float(qa) == float(qb) and sa.step == sb.step == 4
    for name, v in sa.ema_params.items():
        assert torch.equal(v, sb.ema_params[name]), name
    for name, v in sa.model.state_dict().items():
        assert torch.equal(v, sb.model.state_dict()[name]), name


def test_unported_options_raise(data):
    with pytest.raises(ValueError):  # a sampler the package does not have
        BurgersPipeline(BurgersConformalConfig(**CONF, sampler="unipc"), device="cpu", **PIPE)
    # steps_per_call is ported: each step draws its own (t, noise), so
    # chunks of 4 give the weights of single steps where no reshuffle falls
    # inside a chunk (one step of batch 16 over the 16 train sims)
    states = [pretrain(BurgersPretrainConfig(**PIPE), data["train"], num_steps=1,
                       steps_per_call=k, device="cpu") for k in (4, 1)]
    assert states[0].step == states[1].step == 1
    for name, v in states[0].model.state_dict().items():
        assert torch.equal(v, states[1].model.state_dict()[name]), name
    # post-training chunks (3 steps, no evaluation point inside the epoch)
    tp = BurgersPipeline(BurgersConformalConfig(**CONF), device="cpu", **PIPE)
    init_params(tp.model, seed=3)
    runs = [posttrain(BurgersPostTrainConfig(conformal=BurgersConformalConfig(**CONF),
                                             steps_per_call=k, finetune_epoch=1,
                                             finetune_steps=3, finetune_batch_size=4,
                                             finetune_subset_size=10**6),
                      tp, None, data["train"], data["cal"], data["test"]) for k in (4, 2, 1)]
    for state, _, hist in runs:
        assert state.step == 3 and hist[0]["loss"] == runs[-1][2][0]["loss"]
        for name, v in state.model.state_dict().items():
            assert torch.equal(v, runs[-1][0].model.state_dict()[name]), name
