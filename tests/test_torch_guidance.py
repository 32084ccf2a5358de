"""Parity of the port's guidance combinations (`core/guidance.py`) with the
JAX package: the epsilon-orthogonal projections in each norm, alone, inside
`model_predictions`, and through guided DDIM and ancestral sampling (as
`proj_guidance`), on the replayed JAX draws."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core import diffusion as JD
from safediffcon_tpu.core import guidance as JG
from safediffcon_tpu.core import sampling as JS
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.tasks.burgers import task as JK
from safediffcon_torch.core import guidance as TG
from safediffcon_torch.core import sampling as TS
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.tasks.burgers import task as TK

torch.set_num_threads(1)

SHAPE = (2, 16, 8, 3)
NORMS = ["F", "1D_x", "1D_t"]
TASK = dict(u_bound=0.8, w_score=5.0)
Q = 12.0  # relu(s + Q - 0.64) > 0 for any s >= -10, as of a clipped x_start


def jax_denoiser(params, x, t):
    return jnp.tanh(x * params["a"] + 0.01 * t[:, None, None, None])


def torch_denoiser(a):
    return lambda x, t: torch.tanh(x * a + 0.01 * t[:, None, None, None])


def as_tensor(a):
    return torch.from_numpy(np.array(a))


def _pair(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("norm", NORMS)
def test_projection_matches_jax(norm):
    ep, nj = _pair(0)
    ref = JG.get_proj_ep_orthogonal(norm)(jnp.asarray(ep), jnp.asarray(nj))
    out = TG.get_proj_ep_orthogonal(norm)(torch.from_numpy(ep), torch.from_numpy(nj))
    # float32 sums over at most 768 products: 1e-5 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the projection acts: it is not the additive combination
    assert float((out - TG.additive(torch.from_numpy(ep), torch.from_numpy(nj))).abs().max()) > 0.1


def test_additive_and_unknown_norm():
    ep, nj = _pair(1)
    np.testing.assert_array_equal(TG.additive(torch.from_numpy(ep), torch.from_numpy(nj)).numpy(),
                                  np.asarray(JG.additive(jnp.asarray(ep), jnp.asarray(nj))))
    with pytest.raises(NotImplementedError):
        TG.get_proj_ep_orthogonal("L1")


@pytest.fixture(scope="module")
def conds():
    rng = np.random.default_rng(2)
    u0, uT = [(0.5 * rng.normal(size=(SHAPE[0], SHAPE[2]))).astype(np.float32) for _ in range(2)]
    return (JK.BurgersConditioner(u0=jnp.asarray(u0), uT=jnp.asarray(uT)),
            TK.BurgersConditioner(u0=torch.from_numpy(u0), uT=torch.from_numpy(uT)))


def _guidance():
    jcfg, tcfg = JK.BurgersTaskConfig(**TASK), TK.BurgersTaskConfig(**TASK)
    return (jax.grad(lambda x: JK.guidance_values(x, Q, jcfg).sum()),
            TK.guidance_grad_fn(Q, tcfg))


@pytest.mark.parametrize("norm", NORMS)
def test_model_predictions_with_projection_match_jax(norm):
    x = _pair(3)[0]
    jg, tg = _guidance()
    ref = JS.model_predictions(jax_denoiser, {"a": 0.7}, jax_make_schedule(100, "cosine"),
                               JD.DiffusionConfig(timesteps=100), jnp.asarray(x), 60,
                               guidance_grad=jg, j_scale=0.3, clip_x_start=True,
                               rederive_pred_noise=True,
                               proj_guidance=JG.get_proj_ep_orthogonal(norm))
    out = TS.model_predictions(torch_denoiser(0.7), make_schedule(100, "cosine", device="cpu"),
                               DiffusionConfig(timesteps=100), torch.from_numpy(x), 60,
                               guidance_grad=tg, j_scale=0.3, clip_x_start=True,
                               rederive_pred_noise=True,
                               proj_guidance=TG.get_proj_ep_orthogonal(norm))
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", NORMS)
def test_ddim_with_projection_matches_jax(conds, norm):
    jcond, tcond = conds
    jg, tg = _guidance()
    key = jax.random.PRNGKey(4)
    T, steps = 100, 10
    ref = JS.ddim_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "cosine"),
                         JD.DiffusionConfig(timesteps=T, sampling_timesteps=steps, ddim_eta=1.0),
                         key, SHAPE, cond=jcond, guidance_grad=jg,
                         proj_guidance=JG.get_proj_ep_orthogonal(norm))
    init, rng, draws = as_tensor(jax.random.normal(key, SHAPE, jnp.float32)), key, []
    for _ in range(steps - 1):
        rng, k = jax.random.split(rng)
        draws.append(as_tensor(jax.random.normal(k, SHAPE, jnp.float32)))
    out = TS.ddim_sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"),
                         DiffusionConfig(timesteps=T, sampling_timesteps=steps, ddim_eta=1.0),
                         SHAPE, cond=tcond, guidance_grad=tg, init_noise=init, step_noise=draws,
                         proj_guidance=TG.get_proj_ep_orthogonal(norm))
    # 10 float32 DDIM steps on values of order 1: 1e-5; "F"'s coefficient is
    # one float32 sum over all 768 cells of the batch, which XLA sums in
    # another order, and the clipped x_start's rederived noise amplifies that
    # (3.1e-5 here): 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4 if norm == "F" else 1e-5)
    additive = TS.ddim_sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"),
                              DiffusionConfig(timesteps=T, sampling_timesteps=steps,
                                              ddim_eta=1.0),
                              SHAPE, cond=tcond, guidance_grad=tg, init_noise=init,
                              step_noise=draws)
    assert float((additive - out).abs().max()) > 1e-3  # the projection acts


def test_ancestral_with_projection_matches_jax(conds):
    """The guidance_on_x0=False branch combines its gradient at x_{t-1}
    through proj_guidance."""
    jcond, tcond = conds
    jg, tg = _guidance()
    key = jax.random.PRNGKey(6)
    T = 30
    proj_j, proj_t = JG.get_proj_ep_orthogonal("1D_x"), TG.get_proj_ep_orthogonal("1D_x")
    ref = JS.ancestral_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "cosine"),
                              JD.DiffusionConfig(timesteps=T), key, SHAPE, cond=jcond,
                              guidance_grad=jg, proj_guidance=proj_j, guidance_on_x0=False)
    init, rng, draws = as_tensor(jax.random.normal(key, SHAPE, jnp.float32)), key, []
    for _ in range(2 * (T - 1)):
        rng, k = jax.random.split(rng)
        draws.append(as_tensor(jax.random.normal(k, SHAPE, jnp.float32)))
    out = TS.ancestral_sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"),
                              DiffusionConfig(timesteps=T), SHAPE, cond=tcond, guidance_grad=tg,
                              proj_guidance=proj_t, guidance_on_x0=False, init_noise=init,
                              step_noise=draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
