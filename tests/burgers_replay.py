"""Shared setup of the Burgers parity tests (`test_torch_burgers_*.py`): a
tiny config, the dataset and seeded weights, and the JAX key chain's draws
replayed as the port's explicit noise."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from safediffcon_torch.tasks.burgers import BurgersDataset, generate_burgers_dataset
from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params

# 128 cells: the explicit solver stays finite on random-weight samples
# there (at 32 cells their jagged u0 row blows it up)
NX = 128
CONF = dict(cal_batch_size=4, num_cal_batch=2, n_cal_samples=8, n_test_samples=4,
            test_batch_size=4, ddim_sampling_steps=3, timesteps=100, w_score=5.0, alpha=0.7)
# dim 16 mults (1, 2): every block kind once, one down- and one upsample
PIPE = dict(dim=16, dim_mults=(1, 2))
STEPS = CONF["ddim_sampling_steps"] - 1  # stochastic DDIM steps per sampler call


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("burgers") / "burgers.npz")
    generate_burgers_dataset(path, n_train=16, n_cal=8, n_test=4, seed=0, nx=NX, device="cpu")
    return {s: BurgersDataset.load(path, s) for s in ("train", "cal", "test")}


@pytest.fixture(scope="module")
def flax_params():
    """Seeded weights as a flax tree: the port's `init_params` carried over by
    the weight bridge (whose round trip is exact)."""
    net = init_params(build_model(**PIPE, device="cpu"), seed=0)
    return state_dict_to_flax(net, net.state_dict())


def sd_from_flax(params):
    return flax_to_state_dict(build_model(**PIPE, device="meta"), params)


def as_tensor(a):
    return torch.from_numpy(np.array(a))


def sampler_noise(key, shape):
    """ddim_sample's draws from `key`: the initial noise, then one split per
    stochastic step."""
    init = as_tensor(jax.random.normal(key, shape, jnp.float32))
    steps, k = [], key
    for _ in range(STEPS):
        k, sub = jax.random.split(k)
        steps.append(as_tensor(jax.random.normal(sub, shape, jnp.float32)))
    return init, steps


def calibrate_noise(rng, n_calls, shape):
    """`calibrate`'s draws: `rng, key = split(rng)` per chunk."""
    out = []
    for _ in range(n_calls):
        rng, key = jax.random.split(rng)
        out.append(sampler_noise(key, shape))
    return out


def train_draws(key, shape, timesteps):
    """A train step's (t, noise) from its key: `rng_t, rng_n = split(key)`."""
    rng_t, rng_n = jax.random.split(key)
    return (as_tensor(jax.random.randint(rng_t, (shape[0],), 0, timesteps)).long(),
            as_tensor(jax.random.normal(rng_n, shape, jnp.float32)))


def check_metrics(got, ref, flips=0):
    """J and its spread follow a float32 10,000-step rollout: 1e-3. The
    rates count cells of the 4 x 11 x 128 rollout past |u| > u_bound: equal
    counts (their float32 means differ in the last bit), or, after an
    optimizer step (weights equal to ~0.01 lr, not to the bit), up to
    `flips` cells on the other side of the bound."""
    assert set(got) == set(ref)
    b = CONF["n_test_samples"]
    unit = {"point_exceed_ratio (R_p)": 1 / (b * 11 * NX),
            "time_exceed_ratio (R_t)": 1 / (b * 11), "sample_exceed_ratio (R_s)": 1 / b}
    for name, r in ref.items():
        if "ratio" in name:
            assert got[name] == pytest.approx(float(r), abs=flips * unit[name] + 1e-6), name
        else:
            np.testing.assert_allclose(got[name], float(r), rtol=1e-3, atol=1e-7, err_msg=name)


def compare_params(got_sd, ref_params, start_params, lr):
    """AdamW from the same gradients: Adam's early updates are about
    lr * g / |g|, so an entry whose gradient is near 0 may land anywhere
    within 2 lr of JAX's; all but 1 % within 0.01 lr (a wrong gradient moves
    most entries by about lr)."""
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(build_model(**PIPE, device="meta"), got_sd))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(start_params)[0])
    moved, diffs = 0.0, []
    for path, ref in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        ref = np.asarray(ref)
        moved = max(moved, float(np.abs(ref - start[path]).max()))
        diffs.append(np.abs(got[path] - ref).ravel())
    diffs = np.concatenate(diffs)
    frac = float(np.mean(diffs > 0.01 * lr))
    assert diffs.max() < 2 * lr and frac < 1e-2, (diffs.max() / lr, frac)
    assert moved > 0.5 * lr  # the comparison bites


