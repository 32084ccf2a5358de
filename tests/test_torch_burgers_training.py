"""Burgers pretraining against the JAX package: 3 steps of Adam with the
periodic cosine learning rate, clip and EMA on a tiny UNet2D, from the same
weights, with JAX's draws replayed into the port and the same numpy batch
order."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    NX, PIPE, data, flax_params, sd_from_flax, train_draws,
)
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.burgers import BurgersPretrainConfig, pretrain

torch.set_num_threads(1)


def test_pretrain_matches_jax(data, flax_params, monkeypatch):
    pre = dict(**PIPE, timesteps=100, batch_size=4, cosine_t_max=4, checkpoint_every=10**9,
               lr=1e-4)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    train = data["train"]
    jstate = JP.pretrain(JC.BurgersPretrainConfig(**pre),
                         JD.BurgersDataset(train.data, train.u_phys, train.f_phys), num_steps=3,
                         log_every=1, params=jax.tree_util.tree_map(jnp.asarray, flax_params))

    cfg = BurgersPretrainConfig(**pre)
    rng, draws = jax.random.PRNGKey(cfg.seed), []
    for _ in range(3):  # run_train_loop's split, then accumulated_grads' split
        rng, key = jax.random.split(rng)
        draws.append(train_draws(jax.random.split(key, 1)[0], (4, 16, NX, 3), 100))
    losses = []
    noise = iter(draws)
    state = pretrain(cfg, train, num_steps=3, params=sd_from_flax(flax_params), device="cpu",
                     noise=noise, losses=losses)
    assert next(noise, None) is None and state.step == 3
    # the first loss sees identical inputs; later ones follow Adam steps that
    # agree to ~1e-6 of lr
    np.testing.assert_allclose([float(v) for v in losses], losses_ref, rtol=2e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(state.model, state.model.state_dict()))[0])
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        np.testing.assert_allclose(got[path], np.asarray(ref), rtol=0, atol=0.05 * cfg.lr,
                                   err_msg=str(path))


