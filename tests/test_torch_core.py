"""Parity of the port's diffusion core with the JAX package: schedules, DDIM
time pairs and weighted-conformal math (both rank conventions)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core import conformal as JC
from safediffcon_tpu.core import schedules as JS
from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.core.sampling import _ddim_times as jax_ddim_times
from safediffcon_torch.core import conformal as TC
from safediffcon_torch.core import schedules as TS
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.core.sampling import _ddim_times

torch.set_num_threads(1)


@pytest.mark.parametrize("timesteps", [1000, 6])
def test_schedule_tables_equal(timesteps):
    # both sides build the tables in float64 numpy and cast to float32 at the
    # same points, so the float32 tables agree bit for bit
    ref = JS.make_schedule(timesteps, "sigmoid")
    out = TS.make_schedule(timesteps, "sigmoid", device="cpu")
    for name in JS.DiffusionSchedule._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert out.num_timesteps == timesteps


def test_unported_schedule_raises():
    with pytest.raises(ValueError):
        TS.make_schedule(10, "quadratic", device="cpu")


@pytest.mark.parametrize("timesteps,steps", [(1000, 100), (6, 3), (1000, 200), (10, 10)])
def test_ddim_time_pairs_equal(timesteps, steps):
    ref = jax_ddim_times(JDiffusionConfig(timesteps=timesteps, sampling_timesteps=steps))
    out = _ddim_times(DiffusionConfig(timesteps=timesteps, sampling_timesteps=steps))
    assert out == [tuple(p) for p in ref]
    assert out[-1][1] == -1


@pytest.mark.parametrize("convention", ["alpha", "one_minus_alpha"])
@pytest.mark.parametrize("n,alpha", [(200, 0.04), (50, 0.1), (4, 0.25), (7, 0.01), (1, 0.5)])
def test_quantile_rank_both_conventions(n, alpha, convention):
    assert TC.quantile_rank(n, alpha, convention) == JC.quantile_rank(n, alpha, convention)


@pytest.mark.parametrize("case", ["finite", "with_inf", "all_zero"])
def test_normalize_weights(case):
    w = np.random.default_rng(0).exponential(size=16).astype(np.float32)
    if case == "with_inf":
        w[[2, 9]] = np.inf
    elif case == "all_zero":
        w[:] = 0.0
    ref = np.asarray(JC.normalize_weights(jnp.asarray(w)))
    out = TC.normalize_weights(torch.from_numpy(w)).numpy()
    # float32 sums in another order: a few ulps
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("convention", ["alpha", "one_minus_alpha"])
def test_weighted_quantile(convention):
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=40).astype(np.float32)
    w = rng.exponential(size=40).astype(np.float32)
    ref = JC.conformal_quantile(jnp.asarray(scores), jnp.asarray(w), 0.1, convention)
    out = TC.weighted_quantile(TC.normalize_weights(torch.from_numpy(w)) * torch.from_numpy(scores),
                               0.1, convention)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
