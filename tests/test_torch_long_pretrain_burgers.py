"""A longer pretrain of the port's Burgers UNet2D against the JAX package:
25 steps of the tiny model (the round-1 Burgers recipe cut in width and depth:
Adam (0.9, 0.99), the periodic cosine learning rate over several periods,
the global-norm clip, the EMA), in float32 and in bfloat16 compute, with
JAX's key chain replayed into the port: the loss curve step by step and
the EMA weights at the end (tests/test_torch_long_pretrain.py does the same
for the tokamak UNet1D)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from burgers_replay import NX, PIPE, data, flax_params, sd_from_flax, train_draws  # noqa: F401
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.burgers import BurgersPretrainConfig, pretrain
from safediffcon_torch.tasks.burgers.pipeline import build_model

torch.set_num_threads(1)

STEPS = 25


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_long_pretrain_follows_jax(data, flax_params, monkeypatch, compute_dtype):
    pre = dict(**PIPE, timesteps=100, batch_size=4, cosine_t_max=10, lr=1e-3,
               checkpoint_every=10**9, compute_dtype=compute_dtype)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    train = data["train"]
    jstate = JP.pretrain(JC.BurgersPretrainConfig(**pre),
                         JD.BurgersDataset(train.data, train.u_phys, train.f_phys),
                         num_steps=STEPS, log_every=1,
                         params=jax.tree_util.tree_map(jnp.asarray, flax_params))
    cfg = BurgersPretrainConfig(**pre)
    rng, draws = jax.random.PRNGKey(cfg.seed), []
    for _ in range(STEPS):  # run_train_loop's split, then accumulated_grads' split
        rng, key = jax.random.split(rng)
        draws.append(train_draws(jax.random.split(key, 1)[0], (4, 16, NX, 3), 100))
    losses = []
    state = pretrain(cfg, train, num_steps=STEPS, params=sd_from_flax(flax_params),
                     device="cpu", noise=iter(draws), losses=losses)
    losses = np.array([float(v) for v in losses])
    losses_ref = np.array(losses_ref)
    assert losses.shape == losses_ref.shape == (STEPS,)
    rel = np.abs(losses - losses_ref) / losses_ref
    got = dict(jax.tree_util.tree_flatten_with_path(state_dict_to_flax(
        build_model(**PIPE, device="meta"), state.ema_params))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(flax_params)[0])
    diffs, moved = [], []
    for path, ref in jax.tree_util.tree_flatten_with_path(jstate.ema_params)[0]:
        ref = np.asarray(ref)
        diffs.append(np.abs(got[path] - ref).ravel())
        moved.append(np.abs(ref - start[path]).ravel())
    diffs, moved = np.concatenate(diffs), np.concatenate(moved)
    if compute_dtype is None:
        # float32: no drift (seen over 100 steps: losses 6.5e-6 apart, the
        # EMA 1.9e-6 at most, against a lr of 1e-3)
        assert rel.max() < 2e-5, rel.max()
        assert diffs.max() < 1e-2 * cfg.lr, diffs.max()
    else:
        # bf16: the runs part by rounding (seen over 100 steps: 2 % mean
        # loss difference over the last 30, 4.6 % at most; the EMA 3.5 % of
        # the mean distance it moved)
        assert rel.mean() < 3e-2 and rel.max() < 1e-1, (rel.mean(), rel.max())
        assert diffs.mean() < 0.1 * moved.mean(), (diffs.mean(), moved.mean())
    assert losses[-5:].mean() < 0.5 * losses[0]
