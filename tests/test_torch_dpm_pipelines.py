"""The Burgers and tokamak pipelines with `sampler="dpm"`
(DPM-Solver++(2M) in calibration and test sampling) against the JAX package
on tiny configs: calibrate + evaluate from the same weights with the JAX
draws replayed (the smoke task's are in test_torch_smoke_dpm.py). DPM draws
only its initial noise per sampler call (`normal(key)`), so each call's
draws are (init_noise, [])."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import burgers_replay as BR
import tokamak_replay as TR
from safediffcon_tpu.tasks.burgers import config as JBC
from safediffcon_tpu.tasks.burgers import data as JBD
from safediffcon_tpu.tasks.burgers import pipeline as JBP
from safediffcon_tpu.tasks.tokamak import config as JTC
from safediffcon_tpu.tasks.tokamak import pipeline as JTP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks import burgers, tokamak
from safediffcon_torch.tasks.burgers.pipeline import build_model as burgers_model
from safediffcon_torch.tasks.burgers.pipeline import init_params as burgers_init
from safediffcon_torch.tasks.tokamak.pipeline import build_model as tokamak_model
from safediffcon_torch.tasks.tokamak.pipeline import init_params as tokamak_init

torch.set_num_threads(1)


def dpm_draws(key, shape):
    """One DPM sampler call's draws from its key: the initial noise only."""
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32))), []


def dpm_noise(rng, shapes):
    """The draws of a JAX loop that takes `rng, key = split(rng)` per sampler
    call (calibrate's chunks)."""
    for shape in shapes:
        rng, key = jax.random.split(rng)
        yield dpm_draws(key, shape)


def flax_of(net):
    return state_dict_to_flax(net, net.state_dict())


# ---------------------------------------------------------------------------
# Burgers: UNet2D dim 16 at the task's 128 cells
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def burgers_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("burgers") / "burgers.npz")
    burgers.generate_burgers_dataset(path, n_train=1, n_cal=8, n_test=4, seed=0, nx=BR.NX,
                                     device="cpu")
    return {s: burgers.BurgersDataset.load(path, s) for s in ("cal", "test")}


def test_burgers_dpm_calibrate_and_evaluate_match_jax(burgers_data):
    cal, test = burgers_data["cal"], burgers_data["test"]
    conf = dict(BR.CONF, sampler="dpm", ddim_sampling_steps=5)
    params = flax_of(burgers_init(burgers_model(**BR.PIPE, device="cpu"), seed=0))
    jp = JBP.BurgersPipeline(JBC.BurgersConformalConfig(**conf), **BR.PIPE)
    q_ref = jp.calibrate(params, cal.data, 0.0, jax.random.PRNGKey(1))
    m_ref = jp.evaluate(params, JBD.BurgersDataset(test.data, test.u_phys, test.f_phys), q_ref,
                        jax.random.PRNGKey(2))

    tp = burgers.BurgersPipeline(burgers.BurgersConformalConfig(**conf), device="cpu", **BR.PIPE)
    sd = BR.sd_from_flax(params)
    shape = (conf["cal_batch_size"], 16, BR.NX, 3)
    q = tp.calibrate(sd, cal.data, 0.0, noise=dpm_noise(jax.random.PRNGKey(1), [shape] * 2))
    m = tp.evaluate(sd, test, q, noise=iter([dpm_draws(jax.random.PRNGKey(2), test.data.shape)]))
    # float32 UNet2D + sampler: ~1e-6 relative
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    BR.check_metrics(m, m_ref)
    assert float(q) > 0 and m["control_mse_mean (J)"] > 0


# ---------------------------------------------------------------------------
# Tokamak: UNet1D dim 8 on the closed loop's trajectories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tokamak_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokamak") / "tokamak.npz")
    tokamak.generate_tokamak_dataset(path, n_train=8, n_cal=8, n_test=4, seed=0, gen_batch=32,
                                     device="cpu")
    return {s: tokamak.TokamakDataset.load(path, s) for s in ("cal", "test")}


def test_tokamak_dpm_calibrate_and_evaluate_match_jax(tokamak_data):
    cal, test = tokamak_data["cal"], tokamak_data["test"]
    conf = dict(TR.CONF, sampler="dpm")
    params = flax_of(tokamak_init(tokamak_model(**TR.PIPE, device="cpu"), seed=0))
    jp = JTP.TokamakPipeline(JTC.TokamakConformalConfig(**conf), **TR.PIPE)
    q_ref = jp.calibrate(params, TR.jax_data(cal), 0.0, jax.random.PRNGKey(1))
    m_ref = jp.evaluate(params, TR.jax_data(test), q_ref, jax.random.PRNGKey(2))
    g_ref = jp.evaluate(params, TR.jax_data(test), q_ref, jax.random.PRNGKey(3), guided=True)

    tp = tokamak.TokamakPipeline(tokamak.TokamakConformalConfig(**conf), device="cpu", **TR.PIPE)
    sd = TR.sd_from_flax(params)
    q = tp.calibrate(sd, cal, 0.0, noise=dpm_noise(jax.random.PRNGKey(1), [TR.SHAPE] * 2))
    m = tp.evaluate(sd, test, q, noise=iter([dpm_draws(jax.random.PRNGKey(2), TR.SHAPE)]))
    g = tp.evaluate(sd, test, q, guided=True,
                    noise=iter([dpm_draws(jax.random.PRNGKey(3), TR.SHAPE)]))
    # float32 UNet1D + sampler (~1e-6 relative), then the surrogate, whose
    # 1e-3 action quantisation turns that into up to ~1e-4 of a metric
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    TR.check_metrics(m, m_ref, rtol=1e-3)
    TR.check_metrics(g, g_ref, rtol=1e-3)
    assert float(q) > 0 and abs(g["safety_score_mean"] - m["safety_score_mean"]) > 1e-3
