"""The smoke pipeline with `sampler="dpm"` (DPM-Solver++(2M) in
calibration, test sampling and InfFT) against the JAX package on tiny
configs: calibrate + evaluate (UNet3D -> DPM -> the solver on kernel K1's
path -> metrics) and one InfFT `backward_step`, from the same weights with
the JAX draws replayed. DPM draws only its initial noise per sampler call
(`normal(key)`), so each call's draws are (init_noise, [])."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as JSConf
from safediffcon_tpu.tasks.smoke import SmokeDataset as JSDataset
from safediffcon_tpu.tasks.smoke import SmokeInferenceConfig as JSInf
from safediffcon_tpu.tasks.smoke import SmokePipeline as JSPipeline
from safediffcon_tpu.tasks.smoke import pipeline as JSP
from safediffcon_torch.core.sampling import dpm_solver_sample
from safediffcon_torch.models.convert import load_flax_params, state_dict_to_flax
from safediffcon_torch.tasks import smoke
from safediffcon_torch.tasks.smoke.pipeline import build_model as smoke_model
from safediffcon_torch.tasks.smoke.pipeline import init_params as smoke_init

torch.set_num_threads(1)


def dpm_noise(rng, shapes):
    """The draws of a JAX loop that takes `rng, key = split(rng)` per sampler
    call (calibrate's and evaluate's chunks): DPM's initial noise per key."""
    for shape in shapes:
        rng, key = jax.random.split(rng)
        yield torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32))), []


def flax_of(net):
    return state_dict_to_flax(net, net.state_dict())


S_FRAMES, S_TIME, S_SPACE = 4, 8, 4
S_CONF = dict(cal_batch_size=4, num_cal_batch=1, n_test_samples=2, test_batch_size=2,
              ddim_sampling_steps=3, timesteps=6, alpha=0.25, standard_fixed_ratio=10.0,
              safe_bound=0.001, sampler="dpm")
S_PIPE = dict(dim=8, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=60,
              solver_time_scale=S_TIME, solver_space_scale=S_SPACE, solver_backend="pallas_v1")


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "smoke.npz")
    smoke.generate_smoke_dataset(path, n_train=1, n_cal=4, n_test=2, n_frames=S_FRAMES * S_TIME,
                                 record_frames=S_FRAMES, space_scale=S_SPACE, gen_batch=7,
                                 accuracy=1e-4, max_iter=80, device="cpu")
    return {s: smoke.SmokeDataset.load(path, s) for s in ("cal", "test")}


def test_smoke_dpm_calibrate_and_evaluate_match_jax(smoke_data):
    cal, test = smoke_data["cal"], smoke_data["test"]
    params = flax_of(smoke_init(smoke_model(8, (1, 2), device="cpu"), seed=0))
    jp = JSPipeline(JSConf(**S_CONF), **S_PIPE)
    q_ref = jp.calibrate(params, JSDataset(cal.data, cal.raw), jnp.zeros(()),
                         jax.random.PRNGKey(1))
    m_ref = jp.evaluate(params, JSDataset(test.data, test.raw), q_ref, jax.random.PRNGKey(2))

    tp = smoke.SmokePipeline(smoke.SmokeConformalConfig(**S_CONF), device="cpu", **S_PIPE)
    assert tp.sampler_fn is dpm_solver_sample
    load_flax_params(tp.model, params)
    q = tp.calibrate(cal, 0.0, noise=dpm_noise(jax.random.PRNGKey(1), [cal.data.shape]))
    m = tp.evaluate(test, q, noise=dpm_noise(jax.random.PRNGKey(2), [test.data.shape]))
    # float32 UNet3D + sampler ~1e-6 relative; the rollout's chunked CG runs
    # to 1e-4 on both sides: 1e-3 on the metrics, threshold metrics exact
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    assert set(m) == set(m_ref)
    for name, ref in m_ref.items():
        if "percentage" in name:
            assert m[name] == pytest.approx(float(ref), abs=1e-9), name
        else:
            np.testing.assert_allclose(m[name], float(ref), rtol=1e-3, atol=1e-7, err_msg=name)
    assert m["mse"] > 0 and float(q) != 0


def test_smoke_dpm_infft_step_matches_jax():
    """One InfFT backward_step under DPM (a guided sample without
    gradients, a resample conditioned on its control with gradients through
    the final step): the loss and the weights after Adam."""
    shape = (3, 4, 16, 16, 7)
    conf = dict(ddim_sampling_steps=3, timesteps=6, standard_fixed_ratio=10.0,
                safe_bound=0.001, sampler="dpm")
    pipe = dict(dim=16, dim_mults=(1, 2))
    inf = dict(finetune_lr=1e-4, finetune_epoch=1, finetune_steps=1, finetune_batch_size=3,
               backward_finetune=True)
    params = flax_of(smoke_init(smoke_model(**pipe, device="cpu"), seed=0))
    batch = (0.5 * np.random.default_rng(0).normal(size=shape)).astype(np.float32)
    Q = 0.02
    jp = JSPipeline(JSConf(**conf), **pipe)
    tx, _, _, backward_step = JSP.make_finetune_steps(JSInf(conformal=JSConf(**conf), **inf), jp)
    key = jax.random.PRNGKey(9)
    p_new, _, loss_ref = backward_step(jax.tree_util.tree_map(jnp.asarray, params),
                                       tx.init(params), key, jnp.asarray(batch), jnp.asarray(Q))
    draws = [(torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32))), [])
             for k in jax.random.split(key)]

    tp = smoke.SmokePipeline(smoke.SmokeConformalConfig(**conf), device="cpu", **pipe)
    load_flax_params(tp.model, params)
    ttx, _, backward = smoke.make_finetune_steps(
        smoke.SmokeInferenceConfig(conformal=smoke.SmokeConformalConfig(**conf), **inf), tp)
    loss = backward(ttx.init(list(tp.model.parameters())), torch.from_numpy(batch),
                    torch.tensor(Q), noise=draws)
    # a guided 3-step chain, then the final step with gradients: float32 sums
    # in another order through ~3 UNet3D evaluations
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4, atol=1e-7)
    assert float(loss_ref) != 0.0
    got = dict(jax.tree_util.tree_flatten_with_path(flax_of(tp.model))[0])
    old = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    moved, diffs = 0.0, []
    for path, ref in jax.tree_util.tree_flatten_with_path(p_new)[0]:
        moved = max(moved, float(np.abs(np.asarray(ref) - old[path]).max()))
        diffs.append(np.abs(got[path] - np.asarray(ref)).ravel())
    diffs, lr = np.concatenate(diffs), inf["finetune_lr"]
    # Adam's first update is lr * g / (|g| + 1e-8): every entry within 2 lr of
    # JAX's and all but 1 % within 0.01 lr
    assert diffs.max() < 2 * lr and float(np.mean(diffs > 0.01 * lr)) < 1e-2
    assert moved > 0.5 * lr
