"""The last public names of the JAX package, against their ports:
`GaussianDiffusion.loss` / `per_sample_loss` (JAX's key chain replayed into
`t=` / `noise=`), `conformal_quantile`, `get_w_scheduler`,
`make_diffusion_train_step` and `chunked_train_steps` (an Adam step with the
global-norm clip and the reweighted loss, against optax), and the package's
top-level exports. Inputs are built with numpy from a seed; float32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

import safediffcon_torch
import safediffcon_tpu
from safediffcon_tpu.core import conformal as JC
from safediffcon_tpu.core import diffusion as JD
from safediffcon_tpu.core import schedules as JS
from safediffcon_tpu.core import train as JT
from safediffcon_tpu.tasks.smoke.task import SmokeConditioner as JCond
from safediffcon_torch.core import conformal as TC
from safediffcon_torch.core import diffusion as TD
from safediffcon_torch.core import schedules as TS
from safediffcon_torch.core import train as TT
from safediffcon_torch.tasks.smoke.task import train_conditioner

torch.set_num_threads(1)

T_STEPS = 100


def test_package_exports_the_jax_names():
    assert safediffcon_torch.__all__ == safediffcon_tpu.__all__
    for name in safediffcon_tpu.__all__:
        assert getattr(safediffcon_torch, name).__name__ == name
    assert safediffcon_torch.GaussianDiffusion is TD.GaussianDiffusion
    assert safediffcon_torch.make_schedule is TS.make_schedule


def _draws(key, shape):
    """JAX's draws of one loss call: split, randint, normal."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, T_STEPS)
    noise = jax.random.normal(rng_n, shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("objective", ["pred_noise", "pred_v"])
def test_gaussian_diffusion_losses_match_jax(objective):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(4, 4, 6, 6, 7)).astype(np.float32)
    a = rng.normal(size=(7,)).astype(np.float32)
    weights = np.array([1.0, 2.0, 0.5, 0.0], np.float32)

    def j_apply(params, x, tt):
        return jnp.tanh(x * params) + 1e-3 * tt[:, None, None, None, None]

    def t_apply(x, tt):
        return torch.tanh(x * torch.from_numpy(a)) + 1e-3 * tt[:, None, None, None, None]

    jd = JD.GaussianDiffusion(j_apply, JS.make_schedule(T_STEPS, "sigmoid", objective),
                              JD.DiffusionConfig(timesteps=T_STEPS, objective=objective))
    td = TD.GaussianDiffusion(t_apply, TS.make_schedule(T_STEPS, "sigmoid", objective,
                                                        device="cpu"),
                              TD.DiffusionConfig(timesteps=T_STEPS, objective=objective))
    key = jax.random.PRNGKey(3)
    t, noise = _draws(key, x0.shape)
    ref = jd.per_sample_loss(jnp.asarray(a), key, jnp.asarray(x0), JCond())
    out = td.per_sample_loss(torch.from_numpy(x0), train_conditioner(), t=t, noise=noise)
    assert out.shape == (4,)
    # float32 elementwise math and one mean per sample
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-7)
    ref = jd.loss(jnp.asarray(a), key, jnp.asarray(x0), JCond(), jnp.asarray(weights))
    out = td.loss(torch.from_numpy(x0), train_conditioner(), torch.from_numpy(weights),
                  t=t, noise=noise)
    np.testing.assert_allclose(float(out), float(ref), rtol=2e-6)
    # without t / noise the draws come from the generator, and repeat with it
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    x = torch.from_numpy(x0)
    assert torch.equal(td.per_sample_loss(x, generator=g()), td.per_sample_loss(x, generator=g()))
    assert float(td.loss(x, generator=g())) == pytest.approx(
        float(td.per_sample_loss(x, generator=g()).mean()), rel=1e-6)


@pytest.mark.parametrize("convention", ["alpha", "one_minus_alpha"])
@pytest.mark.parametrize("case", ["plain", "inf_weights", "all_zero"])
def test_conformal_quantile_matches_jax(convention, case):
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=60).astype(np.float32)
    w = rng.exponential(size=60).astype(np.float32)
    if case == "inf_weights":
        w[[4, 17]] = np.inf
    elif case == "all_zero":
        w[:] = 0.0
    for alpha in (0.04, 0.9, 0.98):
        ref = JC.conformal_quantile(jnp.asarray(scores), jnp.asarray(w), alpha, convention)
        out = TC.conformal_quantile(torch.from_numpy(scores), torch.from_numpy(w), alpha,
                                    convention)
        # the normalized weights differ by a few ulps (float32 sums in
        # another order); the rank statistic is one of them times a score
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("name", [None, "constant", "cosine", "plain_cosine", "sigmoid",
                                  "sigmoid_flip"])
def test_get_w_scheduler_matches_jax(name):
    assert TS.get_w_scheduler is TS.get_J_scheduler
    ours, ref = TS.get_w_scheduler(name), JS.get_w_scheduler(name)
    for t in (0, 1, 250, 999):
        assert ours(t) == float(ref(t)), t
    with pytest.raises(ValueError, match="unknown J scheduler"):
        TS.get_w_scheduler("linear")


class _Denoiser(nn.Module):
    """x (B, 5, 3) -> tanh(x W + b) + t / 1000, with weights from numpy."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x, t):
        return torch.tanh(x @ self.w + self.b) + 1e-3 * t[:, None, None]


def _j_apply(params, x, t):
    return jnp.tanh(x @ params["w"] + params["b"]) + 1e-3 * t[:, None, None]


def _setup(k_batches):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    batches = rng.normal(size=(k_batches, 6, 5, 3)).astype(np.float32)
    weights = rng.exponential(size=(6,)).astype(np.float32)
    sched_j = JS.make_schedule(T_STEPS, "sigmoid")
    cfg_j = JD.DiffusionConfig(timesteps=T_STEPS)
    model = _Denoiser(w, b)
    state = TT.TrainState.create(model, TT.make_optimizer("adam", 1e-2, max_grad_norm=1.0))
    jstate = JT.TrainState.create({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  JT.make_optimizer("adam", 1e-2, max_grad_norm=1.0))
    step = TT.make_diffusion_train_step(model, TS.make_schedule(T_STEPS, "sigmoid", device="cpu"),
                                        TD.DiffusionConfig(timesteps=T_STEPS))
    return batches, weights, sched_j, cfg_j, state, jstate, step


def _assert_params(state, jstate):
    # Adam: entries agree to a few float32 ulps of the update (units of lr)
    for name in ("w", "b"):
        np.testing.assert_allclose(getattr(state.model, name).detach().numpy(),
                                   np.asarray(jstate.params[name]), rtol=0, atol=2e-6)


def test_make_diffusion_train_step_matches_jax():
    """Three reweighted Adam steps with the clip: losses and weights."""
    batches, weights, sched_j, cfg_j, state, jstate, step = _setup(3)
    jstep = JT.make_diffusion_train_step(_j_apply, sched_j, cfg_j, donate=False)
    rng = jax.random.PRNGKey(11)
    for i in range(3):
        rng, key = jax.random.split(rng)
        jstate, jloss = jstep(jstate, key, jnp.asarray(batches[i]), jnp.asarray(weights))
        t, noise = _draws(key, batches[i].shape)
        loss = step(state, torch.from_numpy(batches[i]), torch.from_numpy(weights),
                    t=t, noise=noise)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
        _assert_params(state, jstate)
    assert state.step == int(jstate.step) == 3


def test_chunked_train_steps_match_jax():
    """k = 4 steps in one call: JAX splits the chunk's key into k step keys;
    the port takes each step's (t, noise) in order. Mean loss and weights."""
    batches, _, sched_j, cfg_j, state, jstate, step = _setup(4)
    ones = jnp.ones((6,), jnp.float32)
    jstep = JT.make_diffusion_train_step(_j_apply, sched_j, cfg_j, donate=False)
    jmulti = JT.chunked_train_steps(lambda s, k, b: jstep(s, k, b, ones), 4, donate=False)
    key = jax.random.PRNGKey(12)
    jstate, jloss = jmulti(jstate, key, jnp.asarray(batches))
    draws = [_draws(k, batches.shape[1:]) for k in jax.random.split(key, 4)]
    multi = TT.chunked_train_steps(step, 4)
    loss = multi(state, torch.from_numpy(batches), noise=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    _assert_params(state, jstate)
    assert state.step == 4
    with pytest.raises(ValueError, match="not 4"):
        multi(state, torch.from_numpy(batches[:3]))
