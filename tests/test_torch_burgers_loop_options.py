"""Burgers post-training with `steps_per_call` against the JAX package, with
JAX's key chain replayed into the port: chunks of k steps inside each
evaluation segment, single steps for a segment's remainder."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, check_metrics, compare_params, data, flax_params, sampler_noise,
    sd_from_flax, train_draws,
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


def test_burgers_posttrain_steps_per_call_matches_jax(data, flax_params):
    """1 epoch of 3 steps at batch 4 with steps_per_call 2 and an evaluation
    every 2 steps (subset 8): a chunk of 2, the evaluation, then a single
    step (the segment's remainder), as JAX chunks inside eval segments."""
    ccfg = dict(CONF, w_score=2.0)
    pt = dict(finetune_epoch=1, finetune_steps=3, finetune_batch_size=4,
              finetune_subset_size=8, finetune_lr=1e-3, steps_per_call=2)
    train, cal, test = data["train"], data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**ccfg), **PIPE)
    jcfg = JC.BurgersPostTrainConfig(conformal=JC.BurgersConformalConfig(**ccfg), **pt)
    jds = {k: JD.BurgersDataset(v.data, v.u_phys, v.f_phys) for k, v in data.items()}
    jstate, q_ref, hist_ref = JP.posttrain(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, flax_params), jds["train"], jds["cal"],
        jds["test"])

    cfg = BurgersPostTrainConfig(conformal=BurgersConformalConfig(**ccfg), **pt)
    shape = (4, 16, NX, 3)
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    rng, key = jax.random.split(rng)  # the chunk of 2: split(key, 2)
    noise = [train_draws(k, shape, CONF["timesteps"]) for k in jax.random.split(key, 2)]
    rng, key = jax.random.split(rng)  # the evaluation after step 2
    noise.append(sampler_noise(key, test.data.shape))
    rng, key = jax.random.split(rng)  # the single step: split(key, 1)
    noise.append(train_draws(jax.random.split(key, 1)[0], shape, CONF["timesteps"]))
    noise = iter(noise)
    tp = BurgersPipeline(cfg.conformal, device="cpu", **PIPE)
    state, q, hist = posttrain(cfg, tp, sd_from_flax(flax_params), train, cal, test,
                               noise=noise)
    assert next(noise, None) is None
    assert state.step == int(jstate.step) == 3
    # JAX's epoch loss repeats each chunk's mean per step: the same mean
    np.testing.assert_allclose(hist[0]["loss"], hist_ref[0]["loss"], rtol=1e-4)
    for m, m_ref in zip(hist[0]["eval_history"], hist_ref[0]["eval_history"], strict=True):
        check_metrics(m, m_ref, flips=1)
    compare_params(state.model.state_dict(), jstate.params, flax_params, pt["finetune_lr"])

