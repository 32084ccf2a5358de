"""Burgers inference-time fine-tuning against the JAX package: one InfFT
epoch (a guided sample with gradients through the final DDIM step, the
safety loss into AdamW, then calibrate and evaluate), from the same weights,
with the JAX key chain's draws replayed into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, calibrate_noise, check_metrics, compare_params, data, flax_params,
    sampler_noise, sd_from_flax,
)
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig,
    BurgersInfFTConfig,
    BurgersPipeline,
    inference_finetune,
)

torch.set_num_threads(1)


def _unclipped_safety(params):
    """Random weights predict samples whose s channel is clipped at +1 near
    its max, where InfFT's amax loss has no gradient (reference semantics).
    A small final conv with a bias on the s output (eps_s ~ 2) shifts the
    final x0 estimate of s below the clip, so the loss reaches every
    weight."""
    out = jax.tree_util.tree_map(np.copy, params)
    conv = out["params"]["final_conv"]
    conv["kernel"] *= 0.01
    conv["bias"][2] = 2.0
    return out


def test_inference_finetune_matches_jax(data, flax_params):
    """One InfFT epoch: a guided sample with gradients through the final
    DDIM step, the loss into AdamW, then calibrate and evaluate."""
    flax_params = _unclipped_safety(flax_params)
    ccfg = dict(CONF, w_score=2.0)
    ift = dict(InfFT_iters=2, finetune_lr=1e-3)
    cal, test = data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**ccfg), **PIPE)
    jds = {k: JD.BurgersDataset(v.data, v.u_phys, v.f_phys) for k, v in data.items()}
    jcfg = JC.BurgersInfFTConfig(conformal=JC.BurgersConformalConfig(**ccfg), **ift)
    jstate, q_ref, hist_ref = JP.inference_finetune(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, flax_params), jds["cal"], jds["test"])

    cfg = BurgersInfFTConfig(conformal=BurgersConformalConfig(**ccfg), **ift)
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    rng, key = jax.random.split(rng)
    noise = [sampler_noise(key, test.data.shape)]
    rng, key = jax.random.split(rng)
    noise.extend(calibrate_noise(key, 2, (4, 16, NX, 3)))
    rng, key = jax.random.split(rng)
    noise.append(sampler_noise(key, test.data.shape))
    noise = iter(noise)
    tp = BurgersPipeline(cfg.conformal, device="cpu", **PIPE)
    state, q, hist = inference_finetune(cfg, tp, sd_from_flax(flax_params), cal, test, noise=noise)
    assert next(noise, None) is None

    (rec,), (ref,) = hist, hist_ref
    # a guided 3-step DDIM chain, then the final step with gradients
    np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=1e-4)
    assert ref["loss"] > 0
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    check_metrics(rec["eval"], ref["eval"], flips=1)
    assert state.step == int(jstate.step) == 1
    compare_params(state.model.state_dict(), jstate.params, flax_params, ift["finetune_lr"])


