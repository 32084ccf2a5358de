"""Shared setup of the tokamak parity tests (`test_torch_tokamak_{pipeline,
training,infft}.py`): a tiny config, a dataset from the port's closed loop,
seeded weights, the JAX key chain's draws replayed as the port's explicit
noise, and the check of one `run_inference` epoch."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.tokamak import config as JC
from safediffcon_tpu.tasks.tokamak import data as JD
from safediffcon_tpu.tasks.tokamak import pipeline as JP
from safediffcon_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from safediffcon_torch.tasks.tokamak import (
    TokamakConformalConfig,
    TokamakDataset,
    TokamakPipeline,
    finetune_config,
    generate_tokamak_dataset,
    posttrain_config,
    run_inference,
)
from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

# DDIM 4 of 8 timesteps, a handful of sims (tests/test_e2e_tokamak.py:50-57)
CONF = dict(cal_batch_size=4, num_cal_batch=2, n_cal_samples=8, n_test_samples=4,
            test_batch_size=4, ddim_sampling_steps=4, timesteps=8)
PIPE = dict(dim=8, dim_mults=(1, 2))
STEPS = CONF["ddim_sampling_steps"] - 1  # stochastic DDIM steps per sampler call
SHAPE = (4, 128, 12)  # a calibration chunk, the test split
# Two epochs of two steps against JAX: every value after the first step
# within 2e-3 (seen: 6.3e-4 at most, a metric's std; the rest under 2e-4)
LATER_RTOL = 2e-3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokamak") / "tokamak.npz")
    generate_tokamak_dataset(path, n_train=8, n_cal=8, n_test=4, seed=0, gen_batch=32,
                             device="cpu")
    return {s: TokamakDataset.load(path, s) for s in ("train", "cal", "test")}


def jax_data(d):
    return JD.TokamakDataset(d.data, d.state_phys)


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


def sampler_noise(key, shape=SHAPE, steps=STEPS):
    """ddim_sample's draws from `key`: the initial noise, then one split per
    stochastic step (`steps`: the DDIM steps less one)."""
    init = as_tensor(jax.random.normal(key, shape, jnp.float32))
    out, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(as_tensor(jax.random.normal(sub, shape, jnp.float32)))
    return init, out


def calibrate_draws(rng, n_calls=2, shape=SHAPE, steps=STEPS):
    """`calibrate`'s draws, one sampler call at a time: `rng, key = split(rng)`
    per chunk."""
    for _ in range(n_calls):
        rng, key = jax.random.split(rng)
        yield sampler_noise(key, shape, steps)


def calibrate_noise(rng, n_calls=2, shape=SHAPE, steps=STEPS):
    """`calibrate_draws` as a list."""
    return list(calibrate_draws(rng, n_calls, shape, steps))


def train_draws(key, shape, timesteps):
    """A train step's (t, noise) from its key: `rng_t, rng_n = split(key)`."""
    rng_t, rng_n = jax.random.split(key)
    return (as_tensor(jax.random.randint(rng_t, (shape[0],), 0, timesteps)).long(),
            as_tensor(jax.random.normal(rng_n, shape, jnp.float32)))


def pretrain_draws(seed, num_steps, shape=SHAPE, timesteps=100):
    """`pretrain`'s draws step by step from PRNGKey(seed): run_train_loop's
    split, then accumulated_grads' split (one micro-batch)."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(num_steps):
        rng, key = jax.random.split(rng)
        yield train_draws(jax.random.split(key, 1)[0], shape, timesteps)


def check_metrics(got, ref, rtol):
    """Every metric of the set within `rtol` (and 1e-6 absolute: a ratio
    of 0 stays 0)."""
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], float(r), rtol=rtol, atol=1e-6, err_msg=name)


def compare_params(got_sd, ref_params, start_params, lr):
    """Adam from the same gradients: a first step is lr * g / (|g| + eps),
    so an entry whose gradient is near 0 may land anywhere within 2 lr of
    JAX's; all but 1 % within 0.01 lr (a wrong gradient moves most entries
    by about lr)."""
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


def epoch_draws(cfg, backward: bool, n_test=SHAPE[0], cal_chunk=50):
    """`run_inference`'s draws in the order the port consumes them, from
    JAX's key chain, epoch by epoch: fold_in(seed, epoch); calibrate (a call
    per chunk of min(cal_chunk, cal_batch_size) of each calibration batch);
    the steps (post-train: each step's (t, noise); backward: per test batch
    of `n_test` a split, then a sampler call per step); evaluate."""
    conf = cfg.conformal
    steps, sample = conf.ddim_sampling_steps - 1, SHAPE[1:]
    chunk = min(cal_chunk, conf.cal_batch_size)
    cal_calls = conf.num_cal_batch * -(-conf.cal_batch_size // chunk)
    for epoch in range(cfg.finetune_epoch):
        rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), epoch)
        rng, key = jax.random.split(rng)
        yield from calibrate_draws(key, cal_calls, (chunk, *sample), steps)
        if backward:
            b = conf.test_batch_size
            for lo in range(0, n_test, b):
                rng, _ = jax.random.split(rng)
                for _ in range(cfg.finetune_steps):
                    rng, key = jax.random.split(rng)
                    yield sampler_noise(key, (min(b, n_test - lo), *sample), steps)
        else:
            for _ in range(cfg.finetune_steps):
                rng, key = jax.random.split(rng)
                yield train_draws(key, (cfg.train_batch_size, *sample), conf.timesteps)
        rng, key = jax.random.split(rng)
        yield sampler_noise(key, (n_test, *sample), steps)


def check_epoch_against_jax(data, flax_params, backward: bool, epochs=1, batches=1):
    """`epochs` epochs of `run_inference` (calibrate -> the post-training or
    InfFT steps -> evaluate) of JAX and of the port with JAX's draws
    replayed: each epoch's Q-hat, loss and metrics, and after a single step
    the weights. `batches` > 1 makes each epoch that many steps: the
    post-training's at one batch each, the backward fine-tune's one per
    batch of the test split cut in `batches`. Every value after the first
    step is held to LATER_RTOL."""
    base = finetune_config() if backward else posttrain_config()
    cut = dict(finetune_epoch=epochs, finetune_steps=1 if backward else batches,
               train_batch_size=4)
    # InfFT: the random model's final x0 estimate of q95 is clipped at -1
    # where it is least, so the safety term relu(threshold - min q95 + Q)
    # has no gradient; the objective term (w_obj 1) on βp and li, which sit
    # inside the clip, gives one
    conf = dict(CONF, guidance_scaler=base.conformal.guidance_scaler,
                w_obj=1.0 if backward else 0.0,
                test_batch_size=CONF["test_batch_size"] // (batches if backward else 1))
    jcfg = dataclasses.replace(JC.finetune_config() if backward else JC.posttrain_config(),
                               **cut, conformal=JC.TokamakConformalConfig(**conf))
    cfg = dataclasses.replace(base, **cut, conformal=TokamakConformalConfig(**conf))
    train, cal, test = data["train"], data["cal"], data["test"]
    jp = JP.TokamakPipeline(jcfg.conformal, **PIPE)
    p_ref, q_ref, h_ref = JP.run_inference(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, flax_params), jax_data(train),
        jax_data(cal), jax_data(test))

    tp = TokamakPipeline(cfg.conformal, device="cpu", **PIPE)
    noise = epoch_draws(cfg, backward, n_test=len(test))
    params, q, hist = run_inference(cfg, tp, sd_from_flax(flax_params), train, cal, test,
                                    noise=noise)
    assert next(noise, None) is None and len(hist) == len(h_ref) == epochs
    # Q-hat precedes the step: the same weights, float32 sampling
    np.testing.assert_allclose(hist[0]["quantile"], h_ref[0]["quantile"], rtol=1e-4)
    assert hist[0]["loss"] > 0
    if epochs == batches == 1:
        np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
        np.testing.assert_allclose(hist[0]["loss"], h_ref[0]["loss"], rtol=1e-4)
        compare_params(params, p_ref, flax_params, cfg.finetune_lr)
        # evaluated after one Adam step of lr ~1e-5 whose entries agree to
        # ~1e-2 lr: the metrics within 1e-3, as the serving test holds them
        check_metrics(hist[0]["eval"], h_ref[0]["eval"], rtol=1e-3)
        return
    for h, r in zip(hist, h_ref):
        if h["epoch"]:
            np.testing.assert_allclose(h["quantile"], r["quantile"], rtol=LATER_RTOL)
        np.testing.assert_allclose(h["loss"], r["loss"], rtol=LATER_RTOL)
        check_metrics(h["eval"], r["eval"], rtol=LATER_RTOL)
