"""A long pretrain of the port against the JAX package: 150 steps of the
tiny tokamak UNet1D (the recipe of the round-1 tokamak run cut in width and
depth: Adam (0.9, 0.99), the periodic cosine learning rate over several
periods, the global-norm clip, the EMA), in float32 and in bfloat16 compute,
with JAX's key chain replayed into the port. The single-step tests bound
each step's difference; this one bounds what 150 of them add up to: the
loss curve step by step and the EMA weights at the end."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tokamak_replay import (  # noqa: F401  (data, flax_params: fixtures)
    PIPE, data, flax_params, jax_data, pretrain_draws, sd_from_flax,
)
from safediffcon_tpu.tasks.tokamak import config as JC
from safediffcon_tpu.tasks.tokamak import pipeline as JP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.tokamak import TokamakPretrainConfig, pretrain
from safediffcon_torch.tasks.tokamak.pipeline import build_model

torch.set_num_threads(1)

STEPS = 150


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_long_pretrain_follows_jax(data, flax_params, monkeypatch, compute_dtype):
    pre = dict(**PIPE, timesteps=100, batch_size=4, cosine_t_max=50, lr=1e-3,
               checkpoint_every=10**9, compute_dtype=compute_dtype)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    jstate = JP.pretrain(JC.TokamakPretrainConfig(**pre), jax_data(data["train"]),
                         num_steps=STEPS, log_every=1,
                         params=jax.tree_util.tree_map(jnp.asarray, flax_params))
    cfg = TokamakPretrainConfig(**pre)
    losses = []
    state = pretrain(cfg, data["train"], num_steps=STEPS, params=sd_from_flax(flax_params),
                     device="cpu", noise=pretrain_draws(cfg.seed, STEPS), losses=losses)
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
        # float32: no drift over 150 steps (seen at 200: losses 3.8e-7 apart, the
        # EMA 8.2e-7 at most, against a lr of 1e-3)
        assert rel.max() < 2e-6, rel.max()
        assert diffs.max() < 1e-2 * cfg.lr, diffs.max()
    else:
        # bf16: each step rounds its activations to 8 bits on both sides in
        # other orders, so the runs part by rounding, not by a trend (seen at 200:
        # 0.67 % mean loss difference over the last 50 steps, 2.3 % at most;
        # the EMA 2.5 % of the mean distance it moved)
        assert rel[-50:].mean() < 2e-2 and rel.max() < 1e-1, (rel[-50:].mean(), rel.max())
        assert diffs.mean() < 0.1 * moved.mean(), (diffs.mean(), moved.mean())
    # both learn: the loss falls by the same factor
    assert losses[-20:].mean() < 0.3 * losses[0]
    np.testing.assert_allclose(losses[-20:].mean(), losses_ref[-20:].mean(), rtol=1e-2)
