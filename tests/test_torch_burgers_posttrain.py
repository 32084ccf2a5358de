"""Burgers post-training against the JAX package: 2 epochs of 1 AdamW step of
the reweighted denoising loss, an evaluation after each step and a
recalibration between the epochs, from the same weights, with the JAX key
chain's draws replayed into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, calibrate_noise, check_metrics, compare_params, data, flax_params,
    sampler_noise, sd_from_flax, train_draws,
)
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig,
    BurgersPipeline,
    BurgersPostTrainConfig,
    posttrain,
)

torch.set_num_threads(1)


def test_posttrain_matches_jax(data, flax_params):
    """2 epochs of 1 step at batch 4; subset 4 makes every step end an
    evaluation, and epoch 0 ends in a recalibration, so epoch 1's weights
    follow a nonzero Q-hat."""
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
    tp = BurgersPipeline(cfg.conformal, device="cpu", **PIPE)
    state, q, hist = posttrain(cfg, tp, sd_from_flax(flax_params), train, cal, test, noise=noise)
    assert next(noise, None) is None

    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    assert float(q) > 0
    for rec, ref in zip(hist, hist_ref, strict=True):
        np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(rec["quantile"], ref["quantile"], rtol=1e-4)
        for m, m_ref in zip(rec["eval_history"], ref["eval_history"], strict=True):
            check_metrics(m, m_ref, flips=1)
    assert state.step == int(jstate.step) == 2
    compare_params(state.model.state_dict(), jstate.params, flax_params, pt["finetune_lr"])


