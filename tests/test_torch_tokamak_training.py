"""Tokamak training against the JAX package on the tiny config, with JAX's
draws replayed into the port: three pretrain steps (Adam (0.9, 0.99), the
periodic cosine learning rate, clip, EMA), and one post-training epoch of
`run_inference` (calibrate -> one reweighted denoising step -> evaluate;
plain Adam (0.99, 0.999), no clip, no EMA). The InfFT epoch is in
test_torch_tokamak_infft.py."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from tokamak_replay import (  # noqa: F401  (data, flax_params: fixtures)
    PIPE, check_epoch_against_jax, data, flax_params, jax_data, pretrain_draws, sd_from_flax,
)
from safediffcon_tpu.tasks.tokamak import config as JC
from safediffcon_tpu.tasks.tokamak import pipeline as JP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.tokamak import TokamakPretrainConfig, pretrain

torch.set_num_threads(1)


def test_pretrain_matches_jax(data, flax_params, monkeypatch):
    pre = dict(**PIPE, timesteps=100, batch_size=4, cosine_t_max=4, checkpoint_every=10**9)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    jstate = JP.pretrain(JC.TokamakPretrainConfig(**pre), jax_data(data["train"]), num_steps=3,
                         log_every=1, params=jax.tree_util.tree_map(jnp.asarray, flax_params))
    cfg = TokamakPretrainConfig(**pre)
    losses = []
    noise = pretrain_draws(cfg.seed, 3)
    state = pretrain(cfg, data["train"], num_steps=3, params=sd_from_flax(flax_params),
                     device="cpu", noise=noise, losses=losses)
    assert next(noise, None) is None and state.step == 3
    # the first loss sees identical inputs; later ones follow Adam steps that
    # agree to ~1e-6 of lr
    np.testing.assert_allclose([float(v) for v in losses], losses_ref, rtol=2e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(state.model, state.model.state_dict()))[0])
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        np.testing.assert_allclose(got[path], np.asarray(ref), rtol=0, atol=0.05 * cfg.lr,
                                   err_msg=str(path))


def test_posttrain_epoch_matches_jax(data, flax_params):
    check_epoch_against_jax(data, flax_params, backward=False)


def test_posttrain_epochs_match_jax(data, flax_params):
    """Two epochs of two steps: the key chain across steps and epochs
    (`tokamak_replay.epoch_draws`, which `tools/tokamak_weight_swap.py`
    replays too); each value within tokamak_replay.LATER_RTOL."""
    check_epoch_against_jax(data, flax_params, backward=False, epochs=2, batches=2)
