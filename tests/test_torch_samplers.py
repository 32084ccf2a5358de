"""Parity of the port's samplers beyond DDIM with the JAX package: the
"pred_x0" / "pred_v" objectives of `model_predictions`, `ancestral_sample`
in each of its modes, `dpm_solver_sample` (plain, guided, noise-matched, and
its final-step gradient), the DPM step coefficients, and `sample`'s
dispatch.

The denoiser is a small closed-form function written once per framework and
the conditioner is the Burgers task's, so the tests isolate the samplers.
JAX draws from split and folded keys inside its scans; the tests replay
those key chains and hand the draws to the port in the order it takes them."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core import diffusion as JD
from safediffcon_tpu.core import sampling as JS
from safediffcon_tpu.core.schedules import get_J_scheduler as jax_j_scheduler
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.tasks.burgers import task as JK
from safediffcon_torch.core import sampling as TS
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.schedules import get_J_scheduler, make_schedule
from safediffcon_torch.tasks.burgers import task as TK

torch.set_num_threads(1)

SHAPE = (2, 16, 8, 3)
TASK = dict(u_bound=0.8, w_score=5.0)
Q = 12.0  # relu(s + Q - 0.64) > 0 for any s >= -10, as of a clipped x_start


# its output reaches past [-1, 1], so that a "pred_x0" model's clip acts
def jax_denoiser(params, x, t):
    return 1.5 * jnp.tanh(x * params["a"] + 0.01 * t[:, None, None, None])


def torch_denoiser(a):
    return lambda x, t: 1.5 * torch.tanh(x * a + 0.01 * t[:, None, None, None])


def as_tensor(a):
    return torch.from_numpy(np.array(a))


def normal(key):
    return as_tensor(jax.random.normal(key, SHAPE, jnp.float32))


@pytest.fixture(scope="module")
def conds():
    rng = np.random.default_rng(0)
    u0, uT = (0.5 * rng.normal(size=(SHAPE[0], SHAPE[2]))).astype(np.float32), \
        (0.5 * rng.normal(size=(SHAPE[0], SHAPE[2]))).astype(np.float32)
    jcond = JK.BurgersConditioner(u0=jnp.asarray(u0), uT=jnp.asarray(uT))
    tcond = TK.BurgersConditioner(u0=torch.from_numpy(u0), uT=torch.from_numpy(uT))
    return jcond, tcond


def guidance(guided):
    if not guided:
        return None, None
    jcfg, tcfg = JK.BurgersTaskConfig(**TASK), TK.BurgersTaskConfig(**TASK)
    return (jax.grad(lambda x: JK.guidance_values(x, Q, jcfg).sum()),
            TK.guidance_grad_fn(Q, tcfg))


@pytest.mark.parametrize("objective", ["pred_x0", "pred_v"])
@pytest.mark.parametrize("clip", [False, True])
def test_model_predictions_objectives_match_jax(objective, clip):
    """x_start from the model output (or from v) and pred_noise from it; no
    guidance for these objectives, as in JAX."""
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    jcfg = JD.DiffusionConfig(timesteps=100, objective=objective)
    tcfg = DiffusionConfig(timesteps=100, objective=objective)
    jg, tg = guidance(True)
    ref = JS.model_predictions(jax_denoiser, {"a": 1.5}, jax_make_schedule(100, "cosine"), jcfg,
                               jnp.asarray(x), 37, guidance_grad=jg, clip_x_start=clip)
    out = TS.model_predictions(torch_denoiser(1.5), make_schedule(100, "cosine", device="cpu"),
                               tcfg, torch.from_numpy(x), 37, guidance_grad=tg,
                               clip_x_start=clip)
    # a few float32 products and one division on values of order 1: 1e-6
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if clip:  # the clip acts
        assert float(out.pred_x_start.abs().max()) == 1.0


def test_unknown_objective_raises():
    with pytest.raises(ValueError):
        TS.model_predictions(torch_denoiser(1.0), make_schedule(10, "cosine", device="cpu"),
                             DiffusionConfig(timesteps=10, objective="pred_eps"),
                             torch.zeros(SHAPE), 3)


def ancestral_draws(key, T, per_step):
    """ancestral_sample's draws from `key`: the initial noise from the key,
    then per step t = T-1 ... 1 one split per posterior step and recurrence;
    the t = 0 step's draws are multiplied by 0 and not replayed."""
    init, steps, rng = normal(key), [], key
    for _ in range((T - 1) * per_step):
        rng, k = jax.random.split(rng)
        steps.append(normal(k))
    return init, steps


# (guided, guidance_on_x0, recurrence, fix_final_step)
ANCESTRAL = [
    (False, True, False, True),
    (True, True, False, True),
    (True, False, False, True),
    (True, False, False, False),  # the reference quirk at t = 0
    (True, False, True, True),
    (True, True, True, True),
]


@pytest.mark.parametrize("guided,on_x0,recurrence,fix_final", ANCESTRAL)
def test_ancestral_matches_jax(conds, guided, on_x0, recurrence, fix_final):
    T = 100
    jcond, tcond = conds
    jg, tg = guidance(guided)
    key = jax.random.PRNGKey(11)
    kw = dict(guidance_on_x0=on_x0, recurrence=recurrence, fix_final_step=fix_final)
    ref = JS.ancestral_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "cosine"),
                              JD.DiffusionConfig(timesteps=T), key, SHAPE, cond=jcond,
                              guidance_grad=jg, j_scheduler=jax_j_scheduler("sigmoid_flip"), **kw)
    per_step = 1 + int(guided and not on_x0) + int(recurrence)
    init, steps = ancestral_draws(key, T, per_step)
    out = TS.ancestral_sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"),
                              DiffusionConfig(timesteps=T), SHAPE, cond=tcond,
                              guidance_grad=tg, j_scheduler=get_J_scheduler("sigmoid_flip"),
                              init_noise=init, step_noise=steps, **kw)
    # 100 float32 posterior steps of elementwise math; XLA's exp and log are
    # not torch's to the last bit: 1e-5 on values of order 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if guided and on_x0:  # the guidance acts (on the same draws)
        unguided = TS.ancestral_sample(torch_denoiser(0.5),
                                       make_schedule(T, "cosine", device="cpu"),
                                       DiffusionConfig(timesteps=T), SHAPE, cond=tcond,
                                       init_noise=init, step_noise=steps, **kw)
        assert float((unguided - out).abs().max()) > 1e-2


def test_ancestral_final_step_modes_differ(conds):
    """fix_final_step=False skips the guided t = 0 update: the two modes
    part, so the parity cases above tell them apart."""
    _, tcond = conds
    _, tg = guidance(True)
    out = {fix: TS.ancestral_sample(torch_denoiser(0.5), make_schedule(20, "cosine", device="cpu"),
                                    DiffusionConfig(timesteps=20), SHAPE, cond=tcond,
                                    guidance_grad=tg, guidance_on_x0=False, fix_final_step=fix,
                                    generator=torch.Generator().manual_seed(0))
           for fix in (True, False)}
    assert float((out[True] - out[False]).abs().max()) > 1e-2


def test_ancestral_step_noise_length_is_checked():
    with pytest.raises(ValueError):
        TS.ancestral_sample(torch_denoiser(0.5), make_schedule(10, "cosine", device="cpu"),
                            DiffusionConfig(timesteps=10), SHAPE, recurrence=True,
                            step_noise=[torch.zeros(SHAPE)] * 9)


COND_KEY = 0x636F6E64  # the key JAX's noise-matched DPM folds in: b"cond"


def dpm_draws(key, cfg):
    """dpm_solver_sample's draws from `key`: the initial noise, and with
    noise_matched_cond the first imposition's eps from fold_in(key, b"cond")
    and one eps per step from fold_in of that key with the step's t_next."""
    if not cfg.noise_matched_cond:
        return normal(key), []
    cond_key = jax.random.fold_in(key, COND_KEY)
    pairs = TS._ddim_times(cfg)
    return normal(key), [normal(cond_key)] + [normal(jax.random.fold_in(cond_key, tn))
                                              for _, tn in pairs[:-1]]


# (T, steps, guided, noise_matched, J scheduler)
DPM = [
    (1000, 25, False, False, None),
    (1000, 25, True, False, "sigmoid"),
    (100, 10, True, True, None),
    (1000, 200, True, False, None),
]


@pytest.mark.parametrize("T,steps,guided,matched,j_name", DPM)
def test_dpm_matches_jax(conds, T, steps, guided, matched, j_name):
    jcond, tcond = conds
    jg, tg = guidance(guided)
    key = jax.random.PRNGKey(5)
    jcfg = JD.DiffusionConfig(timesteps=T, sampling_timesteps=steps, noise_matched_cond=matched)
    tcfg = DiffusionConfig(timesteps=T, sampling_timesteps=steps, noise_matched_cond=matched)
    ref = JS.dpm_solver_sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "cosine"), jcfg,
                               key, SHAPE, cond=jcond, guidance_grad=jg,
                               j_scheduler=jax_j_scheduler(j_name))
    init, step_noise = dpm_draws(key, tcfg)
    out = TS.dpm_solver_sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"),
                               tcfg, SHAPE, cond=tcond, guidance_grad=tg,
                               j_scheduler=get_J_scheduler(j_name), init_noise=init,
                               step_noise=step_noise)
    # 25-200 float32 multistep updates on values of order 1, with the step
    # coefficients a few float32 ulps apart (test_dpm_coefficients_match_jax):
    # 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if matched:  # the returned sample holds the conditions exactly
        np.testing.assert_array_equal(out.numpy(), tcond.apply(out).numpy())
    if guided:  # the guidance acts
        unguided = TS.dpm_solver_sample(torch_denoiser(0.5),
                                        make_schedule(T, "cosine", device="cpu"), tcfg, SHAPE,
                                        cond=tcond, init_noise=init, step_noise=step_noise)
        assert float((unguided - out).abs().max()) > 1e-2


def test_dpm_final_step_grad_matches_jax(conds):
    """With final_step_grad the weight gradient flows through the final
    denoise step only, on both sides."""
    jcond, tcond = conds
    jg, tg = guidance(True)
    key = jax.random.PRNGKey(3)
    T, steps = 1000, 20
    sched = jax_make_schedule(T, "cosine")
    jcfg = JD.DiffusionConfig(timesteps=T, sampling_timesteps=steps)

    def loss(a):
        out = JS.dpm_solver_sample(jax_denoiser, {"a": a}, sched, jcfg, key, SHAPE, cond=jcond,
                                   guidance_grad=jg, final_step_grad=True)
        return (out ** 2).sum()

    ref = jax.grad(loss)(0.5)
    a = torch.tensor(0.5, requires_grad=True)
    out = TS.dpm_solver_sample(torch_denoiser(a), make_schedule(T, "cosine", device="cpu"),
                               DiffusionConfig(timesteps=T, sampling_timesteps=steps), SHAPE,
                               cond=tcond, guidance_grad=tg, final_step_grad=True,
                               init_noise=normal(key))
    (out ** 2).sum().backward()
    # a sum of ~768 float32 products: 1e-4 relative
    np.testing.assert_allclose(float(a.grad), float(ref), rtol=1e-4)
    assert float(ref) != 0.0


def jax_dpm_coefficients(acp, pairs):
    """The JAX sampler's own per-step values, from its formulas
    (safediffcon_tpu/core/sampling.py:dpm_solver_sample) jitted in a scan on
    the float32 table: (h, sigma_s / sigma_t, alpha_s * expm1(-h), the 2M
    weights 1 + 1/(2r) and 1/(2r))."""
    acp = jnp.asarray(acp)

    def lam(t):
        a = acp[t]
        return 0.5 * (jnp.log(a) - jnp.log1p(-a))

    def body(h_prev, pair):
        t, t_next = pair[0], pair[1]
        h = lam(t_next) - lam(t)
        a_s, s_s = jnp.sqrt(acp[t_next]), jnp.sqrt(1.0 - acp[t_next])
        s_t = jnp.sqrt(1.0 - acp[t])
        r = h_prev / h
        return h, jnp.stack([h, s_s / s_t, a_s * jnp.expm1(-h), 1.0 + 1.0 / (2.0 * r),
                             1.0 / (2.0 * r)])

    _, out = jax.jit(lambda p: jax.lax.scan(body, jnp.ones(()), p))(
        jnp.asarray(pairs[:-1], jnp.int32))
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("T,steps", [(1000, 25), (1000, 200), (100, 20), (1000, 999)])
def test_dpm_coefficients_match_jax(T, steps):
    """The port takes each step's coefficients on the host in float64 from
    the float32 table, each rounded once to float32. JAX takes them in
    float32 with XLA's own log, log1p, expm1 and rsqrt, which are up to 1, 2,
    5 and 1 float32 ulp off the correctly rounded value on this CPU; and h
    is the difference of two lambdas of size up to |log a|, so an ulp of
    theirs is many of h's. Each coefficient must agree to 8 float32 ulps plus
    the change that an error of 4 ulps of the lambdas' terms in each of
    JAX's h (and h_prev) makes in it."""
    cfg = DiffusionConfig(timesteps=T, sampling_timesteps=steps)
    pairs = TS._ddim_times(cfg)
    acp = make_schedule(T, "cosine", device="cpu").alphas_cumprod.numpy()
    ref = jax_dpm_coefficients(acp, pairs)
    ulp = lambda v: np.spacing(np.float32(np.abs(v))).astype(np.float64)  # noqa: E731

    def dh(t, t_next):  # the error XLA's float32 lambdas can put into h
        terms = [abs(np.log(np.float64(acp[s]))) + abs(np.log1p(-np.float64(acp[s])))
                 for s in (t, t_next)]
        return 4 * sum(ulp(v) for v in terms)

    h_prev, dh_prev = None, 0.0
    for i, (t, t_next) in enumerate(pairs[:-1]):
        h, c_img, c_x0, w = TS._dpm_coefficients(acp, t, t_next, h_prev)
        e_h = dh(t, t_next)
        a_s = np.sqrt(np.float64(acp[t_next]))
        checks = [(np.float32(h), ref[i, 0], e_h), (c_img, ref[i, 1], 0.0),
                  (c_x0, ref[i, 2], a_s * np.exp(-h) * e_h)]
        if w is not None:
            # 1/(2r) = h / (2 h_prev)
            e_w = e_h / (2 * abs(h_prev)) + abs(h) * dh_prev / (2 * h_prev ** 2)
            checks += [(w[0], ref[i, 3], e_w), (w[1], ref[i, 4], e_w)]
        for k, (got, want, err) in enumerate(checks):
            assert abs(got - want) <= 8 * ulp(want) + err, (i, k, got, want, err)
        h_prev, dh_prev = h, e_h


def test_sample_dispatches_like_jax(conds):
    """`sample` is DDIM below `timesteps` sampling steps and ancestral at
    or above; each equals JAX's `sample` on the replayed draws."""
    jcond, tcond = conds
    T = 20
    key = jax.random.PRNGKey(2)
    for steps in (5, None, T):
        jcfg = JD.DiffusionConfig(timesteps=T, sampling_timesteps=steps, ddim_eta=1.0)
        tcfg = DiffusionConfig(timesteps=T, sampling_timesteps=steps, ddim_eta=1.0)
        ref = JS.sample(jax_denoiser, {"a": 0.5}, jax_make_schedule(T, "cosine"), jcfg, key,
                        SHAPE, cond=jcond)
        if tcfg.is_ddim:
            init, rng, draws = normal(key), key, []
            for _ in range(steps - 1):
                rng, k = jax.random.split(rng)
                draws.append(normal(k))
        else:
            init, draws = ancestral_draws(key, T, 1)
        out = TS.sample(torch_denoiser(0.5), make_schedule(T, "cosine", device="cpu"), tcfg,
                        SHAPE, cond=tcond, init_noise=init, step_noise=draws)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5,
                                   err_msg=str(steps))


def test_get_sampler():
    assert TS.get_sampler("ddim") is TS.ddim_sample
    assert TS.get_sampler("dpm") is TS.dpm_solver_sample
    with pytest.raises(ValueError):
        TS.get_sampler("unipc")
