"""The loop options in the task pipelines against the JAX package, with JAX's
key chain replayed into the port: tokamak `pretrain(steps_per_call=2)` (a
chunk of 2, then a tail step) and a tokamak post-training epoch with
`optimizer="sgd"`. Burgers `posttrain` with `steps_per_call` is in
test_torch_burgers_loop_options.py, the smoke `device_pool` epoch in
test_torch_smoke_device_pool.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import tokamak_replay as TR
from tokamak_replay import data, flax_params  # noqa: F401  (fixtures)
from safediffcon_tpu.tasks.tokamak import config as JTC
from safediffcon_tpu.tasks.tokamak import pipeline as JTP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakPipeline,
    TokamakPretrainConfig,
    posttrain_config,
    pretrain,
    run_inference,
)

torch.set_num_threads(1)


def test_tokamak_pretrain_steps_per_call_matches_jax(data, flax_params, monkeypatch):
    """3 steps at steps_per_call 2 on 8 train trajectories of batch 4: one
    chunk of 2 (its 8 indices from one draw), then a tail step after a
    reshuffle; JAX logs each chunk's mean loss."""
    pre = dict(**TR.PIPE, timesteps=100, batch_size=4, cosine_t_max=4, checkpoint_every=10**9)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JTP, "log", Recorder())
    jstate = JTP.pretrain(JTC.TokamakPretrainConfig(**pre), TR.jax_data(data["train"]),
                          num_steps=3, log_every=1, steps_per_call=2,
                          params=jax.tree_util.tree_map(jnp.asarray, flax_params))
    cfg = TokamakPretrainConfig(**pre)
    rng, draws = jax.random.PRNGKey(cfg.seed), []
    for kk in (2, 1):  # per chunk split(rng), split(key, kk), then accumulated_grads' split
        rng, key = jax.random.split(rng)
        for step_key in jax.random.split(key, kk):
            draws.append(TR.train_draws(jax.random.split(step_key, 1)[0], TR.SHAPE, 100))
    losses = []
    noise = iter(draws)
    state = pretrain(cfg, data["train"], num_steps=3, params=TR.sd_from_flax(flax_params),
                     device="cpu", noise=noise, losses=losses, steps_per_call=2)
    assert next(noise, None) is None and state.step == int(jstate.step) == 3
    losses = [float(v) for v in losses]
    # as the k = 1 test: the Adam steps agree to ~1e-6 of lr
    np.testing.assert_allclose([np.mean(losses[:2]), losses[2]], losses_ref, rtol=2e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(state.model, state.model.state_dict()))[0])
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        np.testing.assert_allclose(got[path], np.asarray(ref), rtol=0, atol=0.05 * cfg.lr,
                                   err_msg=str(path))


def test_tokamak_sgd_posttrain_epoch_matches_jax(data, flax_params):
    """One post-training epoch (calibrate -> one reweighted step -> evaluate)
    with `optimizer="sgd"`, the tokamak config's other optimizer (momentum
    0.9, the first step -lr * g)."""
    conf = dict(TR.CONF, guidance_scaler=posttrain_config().conformal.guidance_scaler)
    cut = dict(finetune_epoch=1, finetune_steps=1, train_batch_size=4, optimizer="sgd",
               finetune_lr=1e-2)
    jcfg = dataclasses.replace(JTC.posttrain_config(), **cut,
                               conformal=JTC.TokamakConformalConfig(**conf))
    cfg = dataclasses.replace(posttrain_config(), **cut, conformal=TokamakConformalConfig(**conf))
    train, cal, test = data["train"], data["cal"], data["test"]
    jp = JTP.TokamakPipeline(jcfg.conformal, **TR.PIPE)
    p_ref, q_ref, h_ref = JTP.run_inference(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, flax_params), TR.jax_data(train),
        TR.jax_data(cal), TR.jax_data(test))

    tp = TokamakPipeline(cfg.conformal, device="cpu", **TR.PIPE)
    noise = TR.epoch_draws(cfg, backward=False)
    params, q, hist = run_inference(cfg, tp, TR.sd_from_flax(flax_params), train, cal, test,
                                    noise=noise)
    assert next(noise, None) is None
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    np.testing.assert_allclose(hist[0]["loss"], h_ref[0]["loss"], rtol=1e-4)
    # SGD moves each weight by -lr * g: the update agrees with JAX's to 1e-3
    # of the largest update (float32 gradients summed in another order)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(TR.build_model(**TR.PIPE, device="meta"), params))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(flax_params)[0])
    upd_ref, upd = [], []
    for path, ref in jax.tree_util.tree_flatten_with_path(p_ref)[0]:
        upd_ref.append((np.asarray(ref) - start[path]).ravel())
        upd.append((got[path] - start[path]).ravel())
    upd_ref, upd = np.concatenate(upd_ref), np.concatenate(upd)
    scale = np.abs(upd_ref).max()
    assert scale > 0
    np.testing.assert_allclose(upd, upd_ref, rtol=0, atol=1e-3 * scale)
    TR.check_metrics(hist[0]["eval"], h_ref[0]["eval"], rtol=1e-3)
