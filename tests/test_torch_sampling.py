"""Parity of the port's guided DDIM sampler and the smoke task's guidance,
conditioning and conformal statistics with the JAX package.

The denoiser is a small closed-form function written once per framework, so
the tests isolate the sampler; the UNet3D itself is held against flax in
test_torch_unet3d.py and the two together in test_torch_smoke_pipeline.py.
JAX draws each step's noise from a split key inside its scan; the eta=1
test replays that key chain and hands the draws to the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.core.sampling import ddim_sample as jax_ddim_sample
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.tasks.smoke import task as JT
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.sampling import ddim_sample
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.tasks.smoke import task as TT

torch.set_num_threads(1)

SHAPE = (2, 4, 8, 8, 7)
T, STEPS = 20, 5
TASK = dict(safe_bound=0.05, w_safe=0.9, standard_fixed_ratio=10.0)


def jax_denoiser(params, x, t):
    return jnp.tanh(x * params["a"] + 0.01 * t[:, None, None, None, None])


def torch_denoiser(a):
    return lambda x, t: torch.tanh(x * a + 0.01 * t[:, None, None, None, None])


def replay_noise(key, shape, n_steps):
    """The draws of JAX ddim_sample(rng=key): initial noise from the key,
    then one split per scan step."""
    init = np.array(jax.random.normal(key, shape, jnp.float32))
    steps, rng = [], key
    for _ in range(n_steps):
        rng, k = jax.random.split(rng)
        steps.append(np.array(jax.random.normal(k, shape, jnp.float32)))
    return init, steps


@pytest.fixture(scope="module")
def conds():
    rng = np.random.default_rng(0)
    init = rng.normal(size=SHAPE[:1] + SHAPE[2:4]).astype(np.float32)
    control = rng.normal(size=SHAPE[:4] + (2,)).astype(np.float32)
    return init, control


def _both(eta, conds, guided, with_control):
    init, control = conds
    ctrl = control if with_control else None
    jcond = JT.SmokeConditioner(init=jnp.asarray(init),
                                control=None if ctrl is None else jnp.asarray(ctrl))
    tcond = TT.SmokeConditioner(init=torch.from_numpy(init),
                                control=None if ctrl is None else torch.from_numpy(ctrl))
    jcfg = JDiffusionConfig(timesteps=T, sampling_timesteps=STEPS, ddim_eta=eta,
                            beta_schedule="sigmoid")
    tcfg = DiffusionConfig(timesteps=T, sampling_timesteps=STEPS, ddim_eta=eta,
                           beta_schedule="sigmoid")
    jg = JT.guidance_grad_fn(0.02, JT.SmokeTaskConfig(**TASK)) if guided else None
    tg = TT.guidance_grad_fn(0.02, TT.SmokeTaskConfig(**TASK)) if guided else None
    return (jcfg, jcond, jg), (tcfg, tcond, tg)


@pytest.mark.parametrize("guided,with_control", [(True, False), (False, True), (True, True)])
def test_ddim_eta0_given_init_noise(conds, guided, with_control):
    (jcfg, jcond, jg), (tcfg, tcond, tg) = _both(0.0, conds, guided, with_control)
    x0 = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    ref = jax_ddim_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "sigmoid"), jcfg,
                          jax.random.PRNGKey(0), SHAPE, cond=jcond, guidance_grad=jg,
                          init_noise=jnp.asarray(x0))
    out = ddim_sample(torch_denoiser(0.5), make_schedule(T, "sigmoid", device="cpu"), tcfg,
                      SHAPE, cond=tcond, guidance_grad=tg, init_noise=torch.from_numpy(x0))
    # five float32 steps of elementwise math: 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_ddim_eta1_replayed_key_chain(conds):
    (jcfg, jcond, jg), (tcfg, tcond, tg) = _both(1.0, conds, True, False)
    key = jax.random.PRNGKey(7)
    ref = jax_ddim_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "sigmoid"), jcfg,
                          key, SHAPE, cond=jcond, guidance_grad=jg)
    init, steps = replay_noise(key, SHAPE, STEPS - 1)
    out = ddim_sample(torch_denoiser(0.5), make_schedule(T, "sigmoid", device="cpu"), tcfg,
                      SHAPE, cond=tcond, guidance_grad=tg, init_noise=torch.from_numpy(init),
                      step_noise=[torch.from_numpy(s) for s in steps])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_ddim_final_step_grad_matches_jax(conds):
    """With final_step_grad the weight gradient flows through the final
    denoise step only, on both sides."""
    (jcfg, jcond, jg), (tcfg, tcond, tg) = _both(1.0, conds, True, False)
    key = jax.random.PRNGKey(3)
    sched = jax_make_schedule(T, "sigmoid")

    def loss(a):
        out = jax_ddim_sample(jax_denoiser, {"a": a}, sched, jcfg, key, SHAPE, cond=jcond,
                              guidance_grad=jg, final_step_grad=True)
        return (out ** 2).sum()

    ref = jax.grad(loss)(0.5)
    init, steps = replay_noise(key, SHAPE, STEPS - 1)
    a = torch.tensor(0.5, requires_grad=True)
    out = ddim_sample(torch_denoiser(a), make_schedule(T, "sigmoid", device="cpu"), tcfg, SHAPE,
                      cond=tcond, guidance_grad=tg, final_step_grad=True,
                      init_noise=torch.from_numpy(init),
                      step_noise=[torch.from_numpy(s) for s in steps])
    (out ** 2).sum().backward()
    np.testing.assert_allclose(float(a.grad), float(ref), rtol=1e-4)


def test_step_noise_length_is_checked():
    cfg = DiffusionConfig(timesteps=T, sampling_timesteps=STEPS)
    with pytest.raises(ValueError):
        ddim_sample(torch_denoiser(0.5), make_schedule(T, "sigmoid", device="cpu"), cfg, SHAPE,
                    step_noise=[torch.zeros(SHAPE)])


def test_generator_draws_are_seeded():
    cfg = DiffusionConfig(timesteps=T, sampling_timesteps=STEPS, ddim_eta=1.0)
    sched = make_schedule(T, "sigmoid", device="cpu")
    a, b = (ddim_sample(torch_denoiser(0.5), sched, cfg, SHAPE,
                        generator=torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b)


def test_smoke_task_statistics():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    cfg_j, cfg_t = JT.SmokeTaskConfig(**TASK), TT.SmokeTaskConfig(**TASK)
    tx = torch.from_numpy(x)
    # float32 means over a few hundred cells: 1e-5
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TT.guidance_values(tx, 0.02, cfg_t).numpy(),
                               JT.guidance_values(jnp.asarray(x), 0.02, cfg_j), **tol)
    for mode in ("train", "test"):
        np.testing.assert_allclose(TT.shift_weights(tx, 0.02, cfg_t, mode).numpy(),
                                   JT.shift_weights(jnp.asarray(x), 0.02, cfg_j, mode), **tol)
    np.testing.assert_allclose(TT.guidance_grad_fn(0.02, cfg_t)(tx).numpy(),
                               JT.guidance_grad_fn(0.02, cfg_j)(jnp.asarray(x)), **tol)
    y = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    np.testing.assert_allclose(TT.conformal_score(tx, torch.from_numpy(y)).numpy(),
                               JT.conformal_score(jnp.asarray(x), jnp.asarray(y)), **tol)
    np.testing.assert_allclose(TT.tile_rate_channels(tx).numpy(),
                               JT.tile_rate_channels(jnp.asarray(x)), **tol)
