"""The port's training machinery against the JAX package: the denoising loss
(`core/diffusion.py::p_losses`), Adam with global-norm clipping against optax,
the MultiStepLR schedule, the EMA cadence of TrainState, and gradient
accumulation. Inputs are built with numpy from a seed; float32 throughout."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch import nn

from safediffcon_tpu.core import diffusion as JD
from safediffcon_tpu.core import train as JT
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_tpu.tasks.smoke.task import SmokeConditioner as JCond
from safediffcon_torch.core import diffusion as TD
from safediffcon_torch.core import train as TT
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.tasks.smoke import pipeline as TP
from safediffcon_torch.tasks.smoke.task import train_conditioner

torch.set_num_threads(1)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_p_losses_matches_jax(objective):
    """Per-sample loss with the smoke training conditioner (frame-0 density
    from the clean sample, zero target there) and the SNR loss weight, on a
    denoiser that depends on x and t, with t and noise given."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 4, 6, 6, 7)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 17, 99], np.int32)
    a = rng.normal(size=(7,)).astype(np.float32)

    def j_apply(params, x, tt):
        return jnp.tanh(x * a) + 1e-3 * tt[:, None, None, None, None]

    def t_apply(x, tt):
        return torch.tanh(x * torch.from_numpy(a)) + 1e-3 * tt[:, None, None, None, None]

    jcfg = JD.DiffusionConfig(timesteps=100, objective=objective, beta_schedule="sigmoid")
    ref = JD.p_losses(j_apply, None, jax_make_schedule(100, "sigmoid", objective), jcfg,
                      jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), JCond())
    tcfg = TD.DiffusionConfig(timesteps=100, objective=objective, beta_schedule="sigmoid")
    out = TD.p_losses(t_apply, make_schedule(100, "sigmoid", objective, device="cpu"), tcfg,
                      torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise),
                      train_conditioner())
    assert out.shape == (3,)
    # float32 elementwise math and one mean per sample: 1e-6 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-7)
    mean = TD.diffusion_loss(t_apply, make_schedule(100, "sigmoid", objective, device="cpu"),
                             tcfg, torch.from_numpy(x0), train_conditioner(),
                             weights=torch.tensor([1.0, 2.0, 0.5]),
                             t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(mean), float((np.asarray(ref) * [1.0, 2.0, 0.5]).mean()),
                               rtol=2e-6)


def _param_shapes():
    return [(5, 3), (4,), (2, 3, 3)]


def test_adam_with_clip_matches_optax():
    """Six updates with MultiStepLR milestones at counts 2 and 4 and a clip
    at 1.0 that triggers on some steps and not on others."""
    rng = np.random.default_rng(1)
    params = [rng.normal(size=s).astype(np.float32) for s in _param_shapes()]
    scales = [0.05, 3.0, 0.1, 10.0, 0.2, 0.01]  # global norms below and above 1
    grads = [[(sc * rng.normal(size=s) / 4).astype(np.float32) for s in _param_shapes()]
             for sc in scales]
    lr_j = JP.multistep_lr(1e-2, (2, 4), 0.5)
    tx = JT.make_optimizer("adam", lr_j, betas=(0.9, 0.99), max_grad_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = TT.make_optimizer("adam", TP.multistep_lr(1e-2, (2, 4), 0.5), betas=(0.9, 0.99),
                            max_grad_norm=1.0)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g], ts)
        for a, b in zip(tp, jp):
            # float32 elementwise updates of size <= lr: 1e-7 absolute
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert ts.count == int(js[1][0].count) == len(grads)


def test_adam_without_clip_matches_optax():
    """The fine-tuning optimizer: constant lr, max_grad_norm 0 (no clip)."""
    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in _param_shapes()]
    tx = JT.make_optimizer("adam", 1e-4, betas=(0.9, 0.99), max_grad_norm=0.0)
    opt = TT.make_optimizer("adam", 1e-4, betas=(0.9, 0.99), max_grad_norm=0.0)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for _ in range(4):
        g = [(50 * rng.normal(size=s)).astype(np.float32) for s in _param_shapes()]
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)
    # the factory's other kinds: SGD (tests/test_torch_train_loop_options.py
    # holds it against optax) and an unknown name
    assert isinstance(TT.make_optimizer("sgd"), TT.SGD)
    with pytest.raises(ValueError):
        TT.make_optimizer("rmsprop")


@pytest.mark.parametrize("milestones", [(50_000, 150_000, 300_000), (3, 7)])
def test_multistep_lr_at_and_around_milestones(milestones):
    j, t = JP.multistep_lr(1e-3, milestones, 0.1), TP.multistep_lr(1e-3, milestones, 0.1)
    counts = [0, 1] + [m + d for m in milestones for d in (-1, 0, 1)]
    for c in counts:
        assert t(c) == float(j(c)), c
    # the update at count m (the (m+1)-th) is the first at the decayed rate
    m = milestones[0]
    assert t(m - 1) == pytest.approx(1e-3) and t(m) == pytest.approx(1e-4)


def test_ema_cadence_matches_jax():
    """The EMA moves only when the new step count is a multiple of 10, and
    its values follow JAX's TrainState over 21 updates."""
    rng = np.random.default_rng(3)
    model = nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)))
        model.bias.copy_(torch.from_numpy(rng.normal(size=(2,)).astype(np.float32)))
    jparams = {"w": jnp.asarray(model.weight.detach().numpy()),
               "b": jnp.asarray(model.bias.detach().numpy())}
    jstate = JT.TrainState.create(jparams, optax.adam(1e-2, b1=0.9, b2=0.99))
    state = TT.TrainState.create(model, TT.Adam(1e-2, 0.9, 0.99))
    prev = {k: v.clone() for k, v in state.ema_params.items()}
    for step in range(1, 22):
        gw = rng.normal(size=(2, 3)).astype(np.float32)
        gb = rng.normal(size=(2,)).astype(np.float32)
        jstate = jstate.apply_gradients({"w": jnp.asarray(gw), "b": jnp.asarray(gb)})
        state.apply_gradients([torch.from_numpy(gw), torch.from_numpy(gb)])
        moved = not torch.equal(prev["weight"], state.ema_params["weight"])
        assert moved == (step % 10 == 0), step
        prev = {k: v.clone() for k, v in state.ema_params.items()}
        np.testing.assert_allclose(state.ema_params["weight"].numpy(),
                                   np.asarray(jstate.ema_params["w"]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(model.bias.detach().numpy(), np.asarray(jstate.params["b"]),
                                   rtol=0, atol=1e-7)
    assert state.step == int(jstate.step) == 21


def test_accumulated_grads_match_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(6, 2)).astype(np.float32)
    batches = rng.normal(size=(3, 4, 6)).astype(np.float32)

    def j_loss(params, key, b):
        return jnp.mean(jnp.tanh(b @ params["w"]) ** 2)

    jl, jg = JT.accumulated_grads(j_loss, 3)({"w": jnp.asarray(w)}, jax.random.PRNGKey(0),
                                              jnp.asarray(batches))
    wt = torch.from_numpy(w.copy()).requires_grad_()
    seen = []

    def t_loss(i, b):
        seen.append(i)
        return torch.mean(torch.tanh(b @ wt) ** 2)

    tl, tg = TT.accumulated_grads(t_loss, [wt], torch.from_numpy(batches))
    assert seen == [0, 1, 2]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    # three float32 backward passes summed: 1e-6 of the largest entry
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg["w"]), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(jg["w"])).max()))


def test_unported_loop_options_raise():
    """The loop options of the JAX loop are ported: each runs the one step
    asked for, on batches of the asked size (their semantics against JAX are
    in tests/test_torch_train_loop_options.py)."""
    model = nn.Linear(2, 2)
    state = TT.TrainState.create(model, TT.Adam(1e-3))
    data = np.arange(8, dtype=np.float32).reshape(4, 2)
    for kw in (dict(steps_per_call=4), dict(device_pool=2), dict(pool_refresh_every=3)):
        seen = []
        TT.run_train_loop(lambda s, b: seen.append(b.clone()) or b.sum(), state, data,
                          batch_take=2, num_steps=1, **kw)
        assert len(seen) == 1 and seen[0].shape == (2, 2) and seen[0].dtype == torch.float32
