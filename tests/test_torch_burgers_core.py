"""The diffusion core the Burgers task adds to the port, against the JAX
package and the reference goldens: the cosine and linear schedules, the
guidance step-size (J) schedulers, both learning-rate schedules, AdamW with
clipping against optax, guided DDIM with a J scheduler and the `sample`
dispatcher, the Burgers task math (conditioner, guidance, weights, scores,
InfFT loss, metrics), and `p_losses` / `ddim_sample` on
`tests/golden/diffusion_reference.npz` (made by the reference torch
GaussianDiffusion)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from safediffcon_tpu.core import sampling as JSmp
from safediffcon_tpu.core import schedules as JS
from safediffcon_tpu.core import train as JT
from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.tasks.burgers import metrics as JM
from safediffcon_tpu.tasks.burgers import task as JK
from safediffcon_torch.core import sampling as TSmp
from safediffcon_torch.core import schedules as TS
from safediffcon_torch.core import train as TT
from safediffcon_torch.core.diffusion import DiffusionConfig, p_losses
from safediffcon_torch.tasks.burgers import metrics as TM
from safediffcon_torch.tasks.burgers import task as TK

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "diffusion_reference.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cosine", "linear"])
@pytest.mark.parametrize("timesteps", [1000, 100])
def test_beta_schedule_tables_equal(kind, timesteps):
    # float64 numpy on both sides, cast to float32 at the same points
    ref = JS.make_schedule(timesteps, kind)
    out = TS.make_schedule(timesteps, kind, device="cpu")
    for name in JS.DiffusionSchedule._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("name", [None, "constant", "cosine", "plain_cosine", "sigmoid",
                                  "sigmoid_flip"])
def test_j_schedulers_equal(name):
    ref, out = JS.get_J_scheduler(name), TS.get_J_scheduler(name)
    for t in (0, 1, 37, 500, 998, 999):
        assert out(t) == float(np.float32(ref(jnp.int32(t)))), (name, t)


def test_unknown_j_scheduler_raises():
    with pytest.raises(ValueError):
        TS.get_J_scheduler("quadratic")


def test_periodic_cosine_schedule_matches_jax():
    """CosineAnnealingLR's closed form, periodic past t_max, with and
    without eta_min."""
    for base, t_max, eta_min in ((1e-5, 10_000, 0.0), (1e-5, 2, 1e-6), (3e-4, 7, 1e-6)):
        j = JT.periodic_cosine_schedule(base, t_max, eta_min)
        t = TT.periodic_cosine_schedule(base, t_max, eta_min)
        for c in (0, 1, t_max // 2, t_max - 1, t_max, t_max + 1, 2 * t_max + 3, 19_999):
            # float32 on both sides; cos of the same float32 argument: 1 ulp
            assert t(c) == pytest.approx(float(j(jnp.int32(c))), rel=1e-6, abs=1e-13), (c,)


def test_warmup_cosine_schedule_matches_jax():
    """Linear warmup, then the cosine restarted at the warmup milestone."""
    for base, warmup, t_max in ((1e-4, 160, 40_960), (1e-3, 0, 4), (1e-3, 3, 8)):
        j = JT.warmup_cosine_schedule(base, warmup, t_max)
        t = TT.warmup_cosine_schedule(base, warmup, t_max)
        for c in (0, 1, max(warmup - 1, 0), warmup, warmup + 1, warmup + t_max, 50_000):
            assert t(c) == pytest.approx(float(j(jnp.int32(c))), rel=1e-6, abs=1e-13), (c,)


def _param_shapes():
    return [(5, 3), (4,), (2, 3, 3)]


def test_adamw_with_clip_matches_optax():
    """Five AdamW updates (betas (0.9, 0.999), weight decay 1e-2) after a
    global-norm clip at 1.0 that triggers on some steps and not others,
    with the posttrain warmup-cosine schedule."""
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in _param_shapes()]
    scales = [0.05, 3.0, 0.1, 10.0, 0.2]
    grads = [[(sc * rng.normal(size=s) / 4).astype(np.float32) for s in _param_shapes()]
             for sc in scales]
    tx = JT.make_optimizer("adamw", JT.warmup_cosine_schedule(1e-2, 2, 8), weight_decay=1e-2,
                           betas=(0.9, 0.999), max_grad_norm=1.0)
    opt = TT.make_optimizer("adamw", TT.warmup_cosine_schedule(1e-2, 2, 8), weight_decay=1e-2,
                            betas=(0.9, 0.999), max_grad_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g], ts)
        for a, b in zip(tp, jp):
            # float32 elementwise updates of size <= lr: 1e-7 absolute
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert ts.count == len(grads)
    # the decay term bites: Adam alone ends elsewhere
    plain = TT.make_optimizer("adam", TT.warmup_cosine_schedule(1e-2, 2, 8),
                              betas=(0.9, 0.999), max_grad_norm=1.0)
    pp = [torch.from_numpy(p.copy()) for p in params]
    ps = plain.init(pp)
    for g in grads:
        plain.step(pp, [torch.from_numpy(x) for x in g], ps)
    assert max(float((a - b).abs().max()) for a, b in zip(pp, tp)) > 1e-6


# ---------------------------------------------------------------------------
# Guided DDIM with a J scheduler; the sample dispatcher
# ---------------------------------------------------------------------------

SHAPE = (3, 16, 8, 3)


def _toy_models():
    a = np.random.default_rng(4).normal(size=(3,)).astype(np.float32)

    def j_apply(params, x, t):
        return jnp.tanh(x * a) + 1e-3 * t[:, None, None, None]

    def t_apply(x, t):
        return torch.tanh(x * torch.from_numpy(a)) + 1e-3 * t[:, None, None, None]

    return j_apply, t_apply


@pytest.mark.parametrize("j_name", [None, "cosine", "sigmoid_flip"])
def test_guided_ddim_with_j_scheduler_matches_jax(j_name):
    """Guidance by the Burgers safety gradient scaled by the J scheduler in
    every step and the final one, conditioned on (u0, uT), eta 1."""
    j_apply, t_apply = _toy_models()
    rng = np.random.default_rng(5)
    state = (0.1 * rng.normal(size=SHAPE)).astype(np.float32)
    init = rng.normal(size=SHAPE).astype(np.float32)
    jcfg = JDiffusionConfig(timesteps=1000, sampling_timesteps=5, ddim_eta=1.0)
    tcfg = DiffusionConfig(timesteps=1000, sampling_timesteps=5, ddim_eta=1.0)
    # the toy model's s channel sits near the clip at -1 (a statistic near
    # -10): a Q of 20 keeps the relu active
    task = dict(u_bound=0.1, w_score=0.5)
    Q = 20.0

    # JAX draws its step noise from the key; replay those draws in the port
    key = jax.random.PRNGKey(6)
    k, jax_steps = key, []
    for _ in range(4):
        k, sub = jax.random.split(k)
        jax_steps.append(_t(jax.random.normal(sub, SHAPE, jnp.float32)))
    jcond = JK.BurgersConditioner(u0=jnp.asarray(state[:, 0, :, 0]),
                                  uT=jnp.asarray(state[:, 10, :, 0]))
    ref = JSmp.ddim_sample(j_apply, None, JS.make_schedule(1000, "cosine"), jcfg, key, SHAPE,
                           cond=jcond,
                           guidance_grad=JK.guidance_grad_fn(Q, JK.BurgersTaskConfig(**task)),
                           j_scheduler=JS.get_J_scheduler(j_name),
                           init_noise=jnp.asarray(init))
    tcond = TK.BurgersConditioner(u0=_t(state[:, 0, :, 0]), uT=_t(state[:, 10, :, 0]))
    out = TSmp.sample(t_apply, TS.make_schedule(1000, "cosine", device="cpu"), tcfg, SHAPE,
                      cond=tcond,
                      guidance_grad=TK.guidance_grad_fn(Q, TK.BurgersTaskConfig(**task)),
                      j_scheduler=TS.get_J_scheduler(j_name), init_noise=_t(init),
                      step_noise=jax_steps)
    # float32 elementwise chain of 5 steps: 1e-5 absolute on values in [-1, 1]
    # (measured 5e-7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    unguided = TSmp.sample(t_apply, TS.make_schedule(1000, "cosine", device="cpu"), tcfg, SHAPE,
                           cond=tcond, init_noise=_t(init), step_noise=jax_steps)
    # the guidance acts, past the tolerance even at sigmoid_flip's small steps
    assert float((unguided - out).abs().max()) > 1e-4

def test_sample_dispatch():
    _, t_apply = _toy_models()
    sched = TS.make_schedule(10, "cosine", device="cpu")
    assert DiffusionConfig(timesteps=10, sampling_timesteps=5).is_ddim
    assert not DiffusionConfig(timesteps=10).is_ddim
    assert not DiffusionConfig(timesteps=10, sampling_timesteps=10).is_ddim
    out = TSmp.sample(t_apply, sched, DiffusionConfig(timesteps=10, sampling_timesteps=3),
                      SHAPE, generator=torch.Generator().manual_seed(0))
    assert out.shape == SHAPE and torch.isfinite(out).all()
    # as many sampling steps as timesteps: the ancestral sampler
    out = TSmp.sample(t_apply, sched, DiffusionConfig(timesteps=10), SHAPE,
                      generator=torch.Generator().manual_seed(0))
    ref = TSmp.ancestral_sample(t_apply, sched, DiffusionConfig(timesteps=10), SHAPE,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, ref) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# Burgers task math
# ---------------------------------------------------------------------------

def _batch(seed=7, b=4):
    return (0.3 * np.random.default_rng(seed).normal(size=(b, 16, 16, 3))).astype(np.float32)


def test_conditioner_matches_jax():
    """apply (u0, uT, w and the padding quirks, s row 10 zeroed),
    apply_train, loss_target and mask_output."""
    x, x0, target = _batch(8), _batch(9), _batch(10)
    u0, uT, w = x0[:, 0, :, 0], x0[:, 10, :, 0], x0[..., 1]
    j = JK.BurgersConditioner(u0=jnp.asarray(u0), uT=jnp.asarray(uT), w=jnp.asarray(w))
    t = TK.BurgersConditioner(u0=_t(u0), uT=_t(uT), w=_t(w))
    xt = _t(x)
    pairs = [
        (t.apply(xt), j.apply(jnp.asarray(x))),
        (TK.BurgersConditioner(u0=_t(u0)).apply(xt),
         JK.BurgersConditioner(u0=jnp.asarray(u0)).apply(jnp.asarray(x))),
        (t.apply_train(xt, _t(x0)), j.apply_train(jnp.asarray(x), jnp.asarray(x0))),
        (t.loss_target(xt), j.loss_target(jnp.asarray(x))),
        (t.mask_output(xt, _t(target)), j.mask_output(jnp.asarray(x), jnp.asarray(target))),
    ]
    for out, ref in pairs:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(xt, _t(x))  # the input is left as it was
    assert (t.apply(xt)[:, 10, :, 2] == 0).all()  # the reference's quirk


@pytest.mark.parametrize("use_max_safety", [True, False])
@pytest.mark.parametrize("Q", [0.0, 0.4])
def test_guidance_weights_scores_match_jax(use_max_safety, Q):
    x, state = _batch(11), _batch(12)
    # two samples below the bound, two above, for either statistic and Q
    x[:, :, :, 2] = np.abs(x[:, :, :, 2]) * np.float32([0.01, 0.02, 0.5, 1.0])[:, None, None]
    jc = JK.BurgersTaskConfig(u_bound=0.8, use_max_safety=use_max_safety, w_score=20.0)
    tc = TK.BurgersTaskConfig(u_bound=0.8, use_max_safety=use_max_safety, w_score=20.0)
    jx, tx = jnp.asarray(x), _t(x)
    # float32 means of the same values: a few ulps
    for out, ref in (
        (TK.guidance_values(tx, Q, tc), JK.guidance_values(jx, Q, jc)),
        (TK.shift_weights(tx, Q, tc), JK.shift_weights(jx, Q, jc)),
        (TK.guidance_grad_fn(Q, tc)(tx), JK.guidance_grad_fn(Q, jc)(jx)),
        (TK.conformal_score(tx, _t(state), use_max_safety),
         JK.conformal_score(jx, jnp.asarray(state), use_max_safety)),
    ):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    g = TK.guidance_values(tx, Q, tc)
    assert (g > 0).any() and (g == 0).any()  # the relu is active and inactive


@pytest.mark.parametrize("Q", [0.0, 0.5])
def test_infft_loss_and_gradient_match_jax(Q):
    pred = 3.0 * _batch(13)
    jc, tc = JK.BurgersTaskConfig(u_bound=0.8), TK.BurgersTaskConfig(u_bound=0.8)
    ref, gref = jax.value_and_grad(lambda p: JK.infft_loss(p, Q, jc))(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    out = TK.infft_loss(p, Q, tc)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gref), rtol=1e-6, atol=1e-7)
    assert out.item() > 0


def test_metrics_match_jax():
    rng = np.random.default_rng(14)
    diffused = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)
    controlled = (0.8 * rng.normal(size=(5, 11, 16))).astype(np.float32)
    target = rng.normal(size=(5, 11, 16)).astype(np.float32)
    ref = JM.evaluate_samples(jnp.asarray(diffused), jnp.asarray(controlled),
                              jnp.asarray(target), 0.8)
    out = TM.evaluate_samples(_t(diffused), _t(controlled), _t(target), 0.8)
    assert out.keys() == ref.keys()
    for name in ref:
        # the rates are counts over float32 means; J a float32 mean
        np.testing.assert_allclose(float(out[name]), float(ref[name]), rtol=1e-6, err_msg=name)
    assert 0 < float(out["point_exceed_ratio (R_p)"]) < float(out["time_exceed_ratio (R_t)"])


# ---------------------------------------------------------------------------
# Reference goldens (the reference torch GaussianDiffusion)
# ---------------------------------------------------------------------------

def _fake_apply(x, t):
    # channels-last equivalent of the reference test's FakeModel
    return 0.1 * x + 0.01 * torch.sin(t.float()).reshape(-1, 1, 1, 1)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _cl(a):
    return _t(np.transpose(a, (0, 2, 3, 1)))


def test_p_losses_matches_reference_golden(golden):
    sched = TS.make_schedule(100, "cosine", device="cpu")
    per = p_losses(_fake_apply, sched, DiffusionConfig(timesteps=100), _cl(golden["x_start"]),
                   _t(golden["t"]), _cl(golden["noise"]), TK.train_conditioner())
    np.testing.assert_allclose(per.numpy(), golden["p_losses"], rtol=2e-4)


def test_ddim_matches_reference_golden(golden):
    sched = TS.make_schedule(100, "cosine", device="cpu")
    cfg = DiffusionConfig(timesteps=100, sampling_timesteps=5, ddim_eta=0.0)
    cond = TK.BurgersConditioner(u0=_t(golden["u_init"]), uT=_t(golden["u_final"]))
    init = _cl(golden["ddim_init"])
    # eta 0: the step noise is multiplied by 0, any draws do
    out = TSmp.ddim_sample(_fake_apply, sched, cfg, tuple(init.shape), cond=cond,
                           init_noise=init, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.numpy(), np.transpose(golden["ddim_out"], (0, 2, 3, 1)),
                               atol=2e-4)
