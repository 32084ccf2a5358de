"""The two fine-tuning steps of `make_finetune_steps` against the JAX
package's: one post-training `weighted_step` (per-sample weighted denoising
loss) and one InfFT `backward_step` (guided sample, resample with gradients
through the final DDIM step, backward loss), from the same flax weights, with
the JAX key chain's draws replayed into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as JConf
from safediffcon_tpu.tasks.smoke import SmokeInferenceConfig as JInfConfig
from safediffcon_tpu.tasks.smoke import SmokePipeline as JPipeline
from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_torch.models.convert import load_flax_params, state_dict_to_flax
from safediffcon_torch.tasks.smoke import (
    SmokeConformalConfig,
    SmokeInferenceConfig,
    SmokePipeline,
    make_finetune_steps,
)
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

torch.set_num_threads(1)

SHAPE = (3, 4, 16, 16, 7)  # batch, frames, size, size, channels
CONF = dict(ddim_sampling_steps=3, timesteps=6, standard_fixed_ratio=10.0, safe_bound=0.001)
# dim 16: every conv bias before a GroupNorm(8) has a real gradient
PIPE = dict(dim=16, dim_mults=(1, 2))
INF = dict(finetune_lr=1e-4, finetune_epoch=1, finetune_steps=1, finetune_batch_size=3)


@pytest.fixture(scope="module")
def setup():
    """The JAX pipeline, seeded flax weights (the port's `init_params` carried
    over by the weight bridge, whose round trip is exact) and a batch."""
    jp = JPipeline(JConf(**CONF), **PIPE)
    net = init_params(build_model(**PIPE, device="cpu"), seed=0)
    params = state_dict_to_flax(net, net.state_dict())
    rng = np.random.default_rng(0)
    batch = (0.5 * rng.normal(size=SHAPE)).astype(np.float32)
    return jp, params, batch


def _port(params, **inf):
    tp = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE)
    load_flax_params(tp.model, params)
    tx, weighted_step, backward_step = make_finetune_steps(
        SmokeInferenceConfig(conformal=SmokeConformalConfig(**CONF), **{**INF, **inf}), tp)
    return tp, tx.init(list(tp.model.parameters())), weighted_step, backward_step


def _compare_params(tp, new_params, old_params, lr):
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(tp.model, tp.model.state_dict()))[0])
    old = dict(jax.tree_util.tree_flatten_with_path(old_params)[0])
    moved, diffs = 0.0, []
    for path, ref in jax.tree_util.tree_flatten_with_path(new_params)[0]:
        ref = np.asarray(ref)
        moved = max(moved, float(np.abs(ref - old[path]).max()))
        diffs.append(np.abs(got[path] - ref).ravel())
    diffs = np.concatenate(diffs)
    # Adam's first update is lr * g / (|g| + 1e-8): an entry whose gradient
    # is near 1e-8 moves by any amount in (-lr, lr) under rounding noise, so
    # every entry within 2 lr of JAX and all but 1% within 0.01 lr (a wrong
    # gradient moves most entries by about lr)
    frac = float(np.mean(diffs > 0.01 * lr))
    assert diffs.max() < 2 * lr and frac < 1e-2, (diffs.max() / lr, frac)
    assert moved > 0.5 * lr  # the comparison bites


def _sampler_noise(key, shape, n_steps):
    """ddim_sample's draws from `key`: the initial noise, then one split per
    stochastic step."""
    init = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    steps, k = [], key
    for _ in range(n_steps):
        k, sub = jax.random.split(k)
        steps.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return init, steps


def test_weighted_step_matches_jax(setup):
    jp, params, batch = setup
    w = np.array([0.5, 1.5, 1.0], np.float32)
    cfg = JInfConfig(conformal=JConf(**CONF), **INF)
    tx, weighted_step, _, _ = JP.make_finetune_steps(cfg, jp)
    key = jax.random.PRNGKey(7)
    p_new, _, loss_ref = weighted_step(jax.tree_util.tree_map(jnp.asarray, params),
                                       tx.init(params), key, jnp.asarray(batch), jnp.asarray(w))
    rng_t, rng_n = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(rng_t, (SHAPE[0],), 0, CONF["timesteps"])))
    n = torch.from_numpy(np.array(jax.random.normal(rng_n, SHAPE, jnp.float32)))

    tp, opt_state, weighted, _ = _port(params)
    loss = weighted(opt_state, torch.from_numpy(batch), torch.from_numpy(w), noise=(t.long(), n))
    # one float32 forward of the same weights on the same inputs
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    assert opt_state.count == 1
    _compare_params(tp, p_new, params, INF["finetune_lr"])


@pytest.mark.parametrize("use_guidance", [True])
def test_backward_step_matches_jax(setup, use_guidance):
    jp, params, batch = setup
    Q = 0.02
    cfg = JInfConfig(conformal=JConf(**CONF, use_guidance=use_guidance),
                     backward_finetune=True, **INF)
    tx, _, _, backward_step = JP.make_finetune_steps(cfg, jp)
    key = jax.random.PRNGKey(9)
    p_new, _, loss_ref = backward_step(jax.tree_util.tree_map(jnp.asarray, params),
                                       tx.init(params), key, jnp.asarray(batch), jnp.asarray(Q))
    n_steps = CONF["ddim_sampling_steps"] - 1
    draws = [_sampler_noise(k, SHAPE, n_steps) for k in jax.random.split(key)]

    tp, opt_state, _, backward = _port(params)
    assert tp.ccfg.use_guidance == use_guidance
    loss = backward(opt_state, torch.from_numpy(batch), torch.tensor(Q), noise=draws)
    # a guided 3-step DDIM chain, then the final step with gradients: float32
    # sums in another order through ~3 UNet3D evaluations
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4, atol=1e-7)
    assert float(loss_ref) != 0.0
    _compare_params(tp, p_new, params, INF["finetune_lr"])
