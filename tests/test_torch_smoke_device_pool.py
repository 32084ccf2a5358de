"""One smoke post-training epoch of `run_inference` with `device_pool`
against the JAX package on a tiny UNet3D: the epoch draws a pool of 3 of the
4 train sims (`default_rng(seed + 31 + epoch)`), holds it in bfloat16 with
the reweights and gathers each batch by index; then it recalibrates Q-hat and
evaluates through the solver. The same flax weights on both sides, JAX's key
chain replayed into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as JConf
from safediffcon_tpu.tasks.smoke import SmokeDataset as JDataset
from safediffcon_tpu.tasks.smoke import SmokeInferenceConfig as JInfConfig
from safediffcon_tpu.tasks.smoke import SmokePipeline as JPipeline
from safediffcon_tpu.tasks.smoke import pipeline as JP
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.tasks.smoke import (
    SmokeConformalConfig,
    SmokeDataset,
    SmokeInferenceConfig,
    SmokePipeline,
    generate_smoke_dataset,
    run_inference,
)
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

torch.set_num_threads(1)

RECORD_FRAMES, TIME_SCALE, SPACE_SCALE = 2, 8, 4  # 16 solver frames, 32^2 records
CONF = dict(cal_batch_size=4, num_cal_batch=1, n_test_samples=2, test_batch_size=2,
            ddim_sampling_steps=3, timesteps=6, alpha=0.25, standard_fixed_ratio=10.0,
            safe_bound=0.001)
# dim 16: every conv bias before a GroupNorm(8) has a real gradient
PIPE = dict(dim=16, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=40,
            solver_time_scale=TIME_SCALE, solver_space_scale=SPACE_SCALE, solver_backend="xla")
INF = dict(finetune_epoch=1, finetune_steps=2, finetune_batch_size=2, finetune_lr=1e-4,
           device_pool=3)


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "smoke.npz")
    generate_smoke_dataset(path, n_train=4, n_cal=4, n_test=2,
                           n_frames=RECORD_FRAMES * TIME_SCALE, record_frames=RECORD_FRAMES,
                           space_scale=SPACE_SCALE, gen_batch=10, accuracy=1e-4, max_iter=40,
                           device="cpu")
    return {s: SmokeDataset.load(path, s) for s in ("train", "cal", "test")}


def _sampler_noise(key, shape):
    init = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    steps, k = [], key
    for _ in range(CONF["ddim_sampling_steps"] - 1):
        k, sub = jax.random.split(k)
        steps.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return init, steps


def _epoch_draws(seed, batch_shape, cal_shape, test_shape):
    """The epoch's draws in the order the port consumes them: fold_in(seed,
    0); per step `rng, key = split(rng)` and the step's (t, noise); then
    calibrate's and evaluate's keys, each split once more per chunk."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    draws = []
    for _ in range(INF["finetune_steps"]):
        rng, key = jax.random.split(rng)
        rng_t, rng_n = jax.random.split(key)
        t = torch.from_numpy(np.array(
            jax.random.randint(rng_t, (batch_shape[0],), 0, CONF["timesteps"]))).long()
        draws.append((t, torch.from_numpy(np.array(jax.random.normal(rng_n, batch_shape)))))
    for shape in (cal_shape, test_shape):
        rng, key = jax.random.split(rng)
        draws.append(_sampler_noise(jax.random.split(key)[1], shape))
    return draws


def test_device_pool_epoch_matches_jax(tiny_data):
    train, cal, test = tiny_data["train"], tiny_data["cal"], tiny_data["test"]
    net = init_params(build_model(dim=16, dim_mults=(1, 2), device="cpu"), seed=0)
    flax_params = state_dict_to_flax(net, net.state_dict())

    jp = JPipeline(JConf(**CONF), **PIPE)
    jcfg = JInfConfig(conformal=JConf(**CONF), **INF)
    jds = {k: JDataset(v.data, v.raw) for k, v in tiny_data.items()}
    p_ref, q_ref, h_ref = JP.run_inference(jcfg, jp, jax.tree_util.tree_map(jnp.asarray,
                                                                            flax_params),
                                           jds["train"], jds["cal"], jds["test"])

    cfg = SmokeInferenceConfig(conformal=SmokeConformalConfig(**CONF), **INF)
    tp = SmokePipeline(cfg.conformal, device="cpu", **PIPE)
    batch_shape = (INF["finetune_batch_size"], *train.data.shape[1:])
    noise = iter(_epoch_draws(cfg.seed, batch_shape, cal.data.shape, test.data.shape))
    params, q, hist = run_inference(cfg, tp, net.state_dict(), train, cal, test, noise=noise)
    assert next(noise, None) is None and len(hist) == len(h_ref) == 1

    # the weighted loss of two steps on bf16-rounded batches gathered from the
    # same pool: one float32 forward each, then an Adam step agreeing to ~1e-2 lr
    np.testing.assert_allclose(hist[0]["loss"], h_ref[0]["loss"], rtol=1e-4)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(tp.model, params))[0])
    start = dict(jax.tree_util.tree_flatten_with_path(flax_params)[0])
    moved, diffs = 0.0, []
    for path, ref in jax.tree_util.tree_flatten_with_path(p_ref)[0]:
        ref = np.asarray(ref)
        moved = max(moved, float(np.abs(ref - start[path]).max()))
        diffs.append(np.abs(got[path] - ref).ravel())
    diffs, lr = np.concatenate(diffs), INF["finetune_lr"]
    # Adam's first updates are about lr * g / |g|: an entry whose gradient is
    # near 0 may land anywhere within 2 lr of JAX's; all but 1 % within 0.01 lr
    assert diffs.max() < 2 * lr and np.mean(diffs > 0.01 * lr) < 1e-2
    assert moved > 0.5 * lr
    # Q-hat and the metrics from the trained weights: float32 sampling, the
    # same whole-batch CG to 1e-4 on both sides
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    for name, ref in h_ref[0]["eval"].items():
        if "percentage" in name:
            assert hist[0]["eval"][name] == pytest.approx(float(ref), abs=1e-9), name
        else:
            np.testing.assert_allclose(hist[0]["eval"][name], float(ref), rtol=1e-3, atol=1e-7,
                                       err_msg=name)


def test_pool_is_the_seeded_choice_in_bfloat16(tiny_data, monkeypatch):
    """The pool holds train sims `default_rng(seed + 31 + epoch).choice(n, 3)`
    rounded to bfloat16, and each step's batch is gathered from it."""
    train, cal, test = tiny_data["train"], tiny_data["cal"], tiny_data["test"]
    tp = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE)
    init_params(tp.model, seed=0)
    cfg = SmokeInferenceConfig(conformal=SmokeConformalConfig(**CONF), **INF)
    seen = []
    from safediffcon_torch.tasks.smoke import pipeline as TPm

    real = TPm.make_finetune_steps

    def spy(c, pipe):
        tx, weighted, backward = real(c, pipe)

        def weighted_spy(opt_state, batch, w, generator=None, noise=None):
            seen.append((batch.clone(), w.clone()))
            return weighted(opt_state, batch, w, generator, noise)

        return tx, weighted_spy, backward

    monkeypatch.setattr(TPm, "make_finetune_steps", spy)
    run_inference(cfg, tp, None, train, cal, test)
    assert len(seen) == INF["finetune_steps"]
    ids = np.random.default_rng(cfg.seed + 31).choice(len(train), 3, replace=False)
    pool = torch.from_numpy(train.data[ids]).to(torch.bfloat16).float()
    w_all = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE).reweights(
        SmokeDataset(train.data, train.raw), 0.0)
    for step, (batch, w) in enumerate(seen):
        sel = np.arange(2 * step, 2 * step + 2) % 3
        assert torch.equal(batch, pool[sel])
        np.testing.assert_array_equal(w.numpy(), w_all[ids][sel])
