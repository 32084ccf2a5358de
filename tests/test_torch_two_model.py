"""Two-model composed sampling and the w-only prior against the JAX package:
`compose_two_model_apply` (plain and normalized), the prior's input and
output masks and its training loss (`ModelWConditioner`), one
`pretrain(model_w=True)` run on a tiny UNet2D, and
`BurgersPipeline(two_model=True)` calibrate + guided evaluate from the same
pair of weights with the JAX key chain's draws replayed into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, calibrate_noise, check_metrics, compare_params, data, flax_params,
    sampler_noise, sd_from_flax, train_draws,
)
from safediffcon_tpu.core import diffusion as JDiff
from safediffcon_tpu.core import sampling as JS
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_tpu.tasks.burgers import task as JK
from safediffcon_torch.core import sampling as TS
from safediffcon_torch.core.diffusion import DiffusionConfig, p_losses
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.burgers import (
    BurgersConformalConfig,
    BurgersInfFTConfig,
    BurgersPipeline,
    BurgersPostTrainConfig,
    BurgersPretrainConfig,
    inference_finetune,
    posttrain,
    pretrain,
)
from safediffcon_torch.tasks.burgers import task as TK
from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params

torch.set_num_threads(1)

SHAPE = (2, 16, 8, 3)


def _x(seed):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def test_w_prior_masks_match_jax():
    x = _x(0)
    for jfn, tfn in ((JK.mask_model_w_input, TK.mask_model_w_input),
                     (JK.mask_model_w_output, TK.mask_model_w_output)):
        tx = torch.from_numpy(x)
        np.testing.assert_array_equal(tfn(tx).numpy(), np.asarray(jfn(jnp.asarray(x))))
        assert torch.equal(tx, torch.from_numpy(x))  # the input is left as it was
    masked = TK.mask_model_w_input(torch.from_numpy(x))
    assert (masked[:, 1:10, :, 0] == 0).all()
    assert torch.equal(masked[:, 0], torch.from_numpy(x[:, 0]))


def _toy_jax(params, x, t):
    return jnp.tanh(x * params["a"] + 0.01 * t[:, None, None, None])


def _toy_torch(params, x, t):
    return torch.tanh(x * params["a"] + 0.01 * t[:, None, None, None])


@pytest.mark.parametrize("normalize_beta", [False, True])
@pytest.mark.parametrize("with_scheduler", [False, True])
def test_compose_two_model_apply_matches_jax(normalize_beta, with_scheduler):
    x, t = _x(1), np.array([37, 37], np.int32)
    kw = dict(prior_beta=0.5, normalize_beta=normalize_beta)
    ref = JS.compose_two_model_apply(
        _toy_jax, _toy_jax, mask_w_input=JK.mask_model_w_input,
        mask_w_output=JK.mask_model_w_output,
        w_scheduler=(lambda s: 0.25 + s / 100) if with_scheduler else None, **kw,
    )(({"a": 0.5}, {"a": -1.3}), jnp.asarray(x), jnp.asarray(t))
    out = TS.compose_two_model_apply(
        _toy_torch, _toy_torch, mask_w_input=TK.mask_model_w_input,
        mask_w_output=TK.mask_model_w_output,
        w_scheduler=(lambda s: 0.25 + s / 100) if with_scheduler else None, **kw,
    )(({"a": 0.5}, {"a": -1.3}), torch.from_numpy(x), torch.from_numpy(t).long())
    # a few float32 operations on values of order 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the prior acts on the w channels and leaves u as the main model's
    main = _toy_torch({"a": 0.5}, torch.from_numpy(x), torch.from_numpy(t).long())
    assert torch.equal(out[..., 0], main[..., 0]) != normalize_beta
    assert float((out[..., 1:] - main[..., 1:]).abs().max()) > 1e-2


def test_model_w_loss_matches_jax():
    """The prior's denoising loss: its input masked, no loss on u."""
    x0, noise = _x(2), _x(3)
    t = np.array([5, 61], np.int32)
    jcfg, tcfg = JDiff.DiffusionConfig(timesteps=100), DiffusionConfig(timesteps=100)
    ref = JDiff.p_losses(lambda p, x, s: _toy_jax(p, JK.mask_model_w_input(x), s), {"a": 0.7},
                         jax_make_schedule(100, "cosine"), jcfg, jnp.asarray(x0),
                         jnp.asarray(t), jnp.asarray(noise), JK.ModelWConditioner())
    out = p_losses(lambda x, s: _toy_torch({"a": 0.7}, TK.mask_model_w_input(x), s),
                   make_schedule(100, "cosine", device="cpu"), tcfg, torch.from_numpy(x0),
                   torch.from_numpy(t).long(), torch.from_numpy(noise), TK.ModelWConditioner())
    # means of 768 float32 squares: 1e-6 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    full = p_losses(lambda x, s: _toy_torch({"a": 0.7}, x, s),
                    make_schedule(100, "cosine", device="cpu"), tcfg, torch.from_numpy(x0),
                    torch.from_numpy(t).long(), torch.from_numpy(noise), TK.BurgersConditioner())
    assert (full > out).all()  # the u channel's loss is gone


def test_pretrain_model_w_matches_jax(data, flax_params, monkeypatch):
    """Two steps of the w-only prior's pretrain, from the same weights and
    draws: the losses and the weights after them."""
    pre = dict(**PIPE, timesteps=100, batch_size=4, cosine_t_max=4, checkpoint_every=10**9,
               lr=1e-4)
    losses_ref = []

    class Recorder:
        def info(self, msg, *args):
            if " step %d loss " in msg:
                losses_ref.append(args[2])

    monkeypatch.setattr(JP, "log", Recorder())
    train = data["train"]
    jstate = JP.pretrain(JC.BurgersPretrainConfig(**pre),
                         JD.BurgersDataset(train.data, train.u_phys, train.f_phys), num_steps=2,
                         log_every=1, params=jax.tree_util.tree_map(jnp.asarray, flax_params),
                         model_w=True)
    cfg = BurgersPretrainConfig(**pre)
    rng, draws = jax.random.PRNGKey(cfg.seed), []
    for _ in range(2):  # run_train_loop's split, then accumulated_grads' split
        rng, key = jax.random.split(rng)
        draws.append(train_draws(jax.random.split(key, 1)[0], (4, 16, NX, 3), 100))
    losses = []
    state = pretrain(cfg, train, num_steps=2, params=sd_from_flax(flax_params), device="cpu",
                     noise=iter(draws), losses=losses, model_w=True)
    # the first loss sees identical inputs, the second follows one Adam step
    np.testing.assert_allclose([float(v) for v in losses], losses_ref, rtol=2e-5)
    # Adam steps each weight by about lr * sign(g): see compare_params (the
    # masked u rows leave more gradients near 0 than the main model's)
    compare_params(state.model.state_dict(), jstate.params, flax_params, cfg.lr)
    # the prior's loss is not the main model's on the same draws
    plain = []
    pretrain(cfg, train, num_steps=1, params=sd_from_flax(flax_params), device="cpu",
             noise=iter(draws), losses=plain)
    assert abs(float(plain[0]) - float(losses[0])) > 1e-3 * float(losses[0])


@pytest.fixture(scope="module")
def prior_params():
    net = init_params(build_model(**PIPE, device="cpu"), seed=1)
    return state_dict_to_flax(net, net.state_dict())


def test_two_model_calibrate_and_evaluate_match_jax(data, flax_params, prior_params):
    """`BurgersPipeline(two_model=True, prior_beta=0.5)` (the JAX CLI's
    default beta) from the pair (main, prior)."""
    cal, test = data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**CONF), two_model=True, prior_beta=0.5,
                            **PIPE)
    pair = (flax_params, prior_params)
    q_ref = jp.calibrate(pair, cal.data, 0.0, jax.random.PRNGKey(1))
    m_ref = jp.evaluate(pair, JD.BurgersDataset(test.data, test.u_phys, test.f_phys), q_ref,
                        jax.random.PRNGKey(2))

    tp = BurgersPipeline(BurgersConformalConfig(**CONF), two_model=True, prior_beta=0.5,
                         device="cpu", **PIPE)
    params = (sd_from_flax(flax_params), sd_from_flax(prior_params))
    shape = (CONF["cal_batch_size"], 16, NX, 3)
    q = tp.calibrate(params, cal.data, 0.0,
                     noise=iter(calibrate_noise(jax.random.PRNGKey(1), 2, shape)))
    m = tp.evaluate(params, test, q,
                    noise=iter([sampler_noise(jax.random.PRNGKey(2), test.data.shape)]))
    # two float32 UNet2D forwards per step: ~1e-6 relative, as the one-model test
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    check_metrics(m, m_ref)
    assert float(q) > 0 and m["control_mse_mean (J)"] > 0
    # the prior acts: the main model alone gives another Q-hat
    one = BurgersPipeline(BurgersConformalConfig(**CONF), device="cpu", **PIPE)
    q_one = one.calibrate(params[0], cal.data, 0.0,
                          noise=iter(calibrate_noise(jax.random.PRNGKey(1), 2, shape)))
    assert abs(float(q_one) - float(q)) > 1e-3 * abs(float(q))


def test_two_model_params_and_finetuning_are_refused(data):
    tp = BurgersPipeline(BurgersConformalConfig(**CONF), two_model=True, device="cpu", **PIPE)
    with pytest.raises(ValueError):
        tp.apply_fn(None)  # a pair is required
    assert tp.apply_fn((None, None))(torch.zeros(1, 16, NX, 3), torch.zeros(1).long()).shape \
        == (1, 16, NX, 3)
    with pytest.raises(ValueError, match="sampling/eval surface"):
        posttrain(BurgersPostTrainConfig(), tp, (None, None), data["train"], data["cal"],
                  data["test"])
    with pytest.raises(ValueError, match="sampling/eval surface"):
        inference_finetune(BurgersInfFTConfig(), tp, (None, None), data["cal"], data["test"])
