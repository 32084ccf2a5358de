"""The few-step samplers of `burgers_dpm_refscale` on the Burgers pipeline
against the JAX package, at the recipe's step counts of the config's 1,000
timesteps and a small width (UNet2D dim 16, a few sims at the task's 128
cells): stochastic DDIM 20 (eta 1) and DPM-Solver++ 2M at 20 and 50 steps,
calibrate at Q = 0 and the guided evaluate from the same seeded random
weights in float32, with JAX's key chain replayed into the port (each
sampler call's initial noise, then, for DDIM, one split per stochastic
step). The existing pipeline tests run DDIM 3 of 100 timesteps and DPM 5
of 100, whose coefficients are not those of 20 of 1,000. Trained weights
in bf16: `tools/burgers_sampler_swap.py`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burgers_replay import (  # noqa: F401  (data, flax_params: fixtures)
    CONF, NX, PIPE, as_tensor, check_metrics, data, flax_params, sd_from_flax,
)
from safediffcon_tpu.tasks.burgers import config as JC
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import pipeline as JP
from safediffcon_torch.tasks.burgers import BurgersConformalConfig, BurgersPipeline

torch.set_num_threads(1)


def draws(sampler, n_steps, key, shape):
    """One sampler call's draws from `key`: the initial noise, then, for
    DDIM, one split per stochastic step (DPM draws nothing more)."""
    init, steps, k = as_tensor(jax.random.normal(key, shape, jnp.float32)), [], key
    for _ in range(n_steps - 1 if sampler == "ddim" else 0):
        k, sub = jax.random.split(k)
        steps.append(as_tensor(jax.random.normal(sub, shape, jnp.float32)))
    return init, steps


@pytest.mark.parametrize("sampler,n_steps", [pytest.param("ddim", 20, id="ddim"),
                                             pytest.param("dpm", 20, id="dpm"),
                                             pytest.param("dpm", 50, id="dpm50")])
def test_few_step_calibrate_and_evaluate_match_jax(data, flax_params, sampler, n_steps):
    CONF20 = dict(CONF, sampler=sampler, ddim_sampling_steps=n_steps, timesteps=1000)
    cal, test = data["cal"], data["test"]
    jp = JP.BurgersPipeline(JC.BurgersConformalConfig(**CONF20), **PIPE)
    q_ref = jp.calibrate(flax_params, cal.data, 0.0, jax.random.PRNGKey(0))
    m_ref = jp.evaluate(flax_params, JD.BurgersDataset(test.data, test.u_phys, test.f_phys),
                        q_ref, jax.random.PRNGKey(5000))

    tp = BurgersPipeline(BurgersConformalConfig(**CONF20), device="cpu", **PIPE)
    params = sd_from_flax(flax_params)
    shape = (CONF20["cal_batch_size"], 16, NX, 3)

    def cal_noise(rng):
        for _ in range(CONF20["num_cal_batch"]):  # `rng, key = split(rng)` per chunk
            rng, key = jax.random.split(rng)
            yield draws(sampler, n_steps, key, shape)

    tp.record = {}
    q = tp.calibrate(params, cal.data, 0.0, noise=cal_noise(jax.random.PRNGKey(0)))
    m = tp.evaluate(params, test, q,
                    noise=iter([draws(sampler, n_steps, jax.random.PRNGKey(5000),
                                      test.data.shape)]))
    # float32 UNet2D over 20-50 steps: ~1e-6 relative
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    check_metrics(m, m_ref)
    # the comparisons bite: every calibration score counted, a nonzero
    # quantile, J, and a violation rate in (0, 1)
    assert tp.record["cal_scores"].shape == (len(cal.data),)
    assert float(q) > 0 and m["control_mse_mean (J)"] > 0
    assert 0 < m["point_exceed_ratio (R_p)"] < 1
