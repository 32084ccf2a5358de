"""The whole serving slice against the JAX package: `SmokePipeline.calibrate`
+ `evaluate` (guided DDIM sampling of UNet3D -> solver rollout on the
pressure-CG kernel path -> metrics) on a tiny config, with the same flax
weights on both sides and the JAX key chain's noise replayed into the port.
Also the port's dataset generator and npz loader."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.tasks.smoke import SmokeConformalConfig as JConf
from safediffcon_tpu.tasks.smoke import SmokeDataset as JDataset
from safediffcon_tpu.tasks.smoke import SmokePipeline as JPipeline
from safediffcon_tpu.tasks.smoke import data as jax_data
from safediffcon_torch.models.convert import load_flax_params
from safediffcon_torch.tasks.smoke import (
    SmokeConformalConfig,
    SmokeDataset,
    SmokePipeline,
    generate_smoke_dataset,
)
from safediffcon_torch.tasks.smoke import data as torch_data

torch.set_num_threads(1)

RECORD_FRAMES, TIME_SCALE, SPACE_SCALE = 4, 8, 4  # 32 solver frames, 32^2 records
CONF = dict(cal_batch_size=4, num_cal_batch=1, n_test_samples=2, test_batch_size=2,
            ddim_sampling_steps=3, timesteps=6, alpha=0.25, standard_fixed_ratio=10.0,
            safe_bound=0.001)
PIPE = dict(dim=8, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=60,
            solver_time_scale=TIME_SCALE, solver_space_scale=SPACE_SCALE,
            solver_backend="pallas_v1")


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "smoke.npz")
    generate_smoke_dataset(path, n_train=1, n_cal=4, n_test=2,
                           n_frames=RECORD_FRAMES * TIME_SCALE, record_frames=RECORD_FRAMES,
                           space_scale=SPACE_SCALE, gen_batch=7, accuracy=1e-4, max_iter=80,
                           device="cpu")
    return {s: SmokeDataset.load(path, s) for s in ("train", "cal", "test")}


def test_dataset_generation(tiny_data):
    d = tiny_data["cal"]
    assert d.data.shape == (4, RECORD_FRAMES, 32, 32, 7)
    assert (d.raw[..., 5] >= 0).all() and (d.raw[..., 5] <= 1).all()
    assert np.allclose(d.raw[..., 6], d.raw[:, :, :1, :1, 6])
    # frame 0 holds the 10x10 blob, subsampled by SPACE_SCALE^2
    expect = 100.0 / SPACE_SCALE ** 2
    np.testing.assert_allclose(d.raw[:, 0, :, :, 0].sum(axis=(-1, -2)), expect, atol=expect * 0.6)
    np.testing.assert_allclose(d.data * torch_data.RESCALER, d.raw, rtol=1e-6)


def test_dataset_generation_phase_seconds(tiny_data, tmp_path):
    """Timing the generator's phases leaves its output as it was."""
    path = str(tmp_path / "timed.npz")
    phases = {}
    generate_smoke_dataset(path, n_train=1, n_cal=4, n_test=2,
                           n_frames=RECORD_FRAMES * TIME_SCALE, record_frames=RECORD_FRAMES,
                           space_scale=SPACE_SCALE, gen_batch=7, accuracy=1e-4, max_iter=80,
                           device="cpu", phase_seconds=phases)
    assert sorted(phases) == ["inputs", "records", "rollout", "save"]
    assert all(v > 0 for v in phases.values())
    for split in ("train", "cal", "test"):
        np.testing.assert_array_equal(SmokeDataset.load(path, split).raw, tiny_data[split].raw)


def test_waypoint_programs_match_jax():
    """The blobs and velocity programs come from the same numpy draws."""
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        xs, ys = torch_data._waypoints(ra)
        assert (xs, ys) == jax_data._waypoints(rb)
        for a, b in zip(torch_data._velocity_program(ra, xs, ys, 256),
                        jax_data._velocity_program(rb, xs, ys, 256)):
            np.testing.assert_array_equal(a, b)


def _replayed_noise(rng, shapes, n_steps):
    """Per sampler call, the draws JAX makes: `rng, key = split(rng)` per
    chunk, then ddim_sample's initial noise and one split per step."""
    for shape in shapes:
        rng, key = jax.random.split(rng)
        init = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
        steps, k = [], key
        for _ in range(n_steps):
            k, sub = jax.random.split(k)
            steps.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
        yield init, steps


def test_calibrate_and_evaluate_match_jax(tiny_data):
    cal, test = tiny_data["cal"], tiny_data["test"]
    jp = JPipeline(JConf(**CONF), **PIPE)
    frames, size = cal.data.shape[1], cal.data.shape[2]
    params = jax.jit(jp.model.init)(jax.random.PRNGKey(0), jnp.zeros((1, frames, size, size, 7)),
                                    jnp.zeros((1,), jnp.int32))
    q_ref = jp.calibrate(params, JDataset(cal.data, cal.raw), jnp.zeros(()), jax.random.PRNGKey(1))
    m_ref = jp.evaluate(params, JDataset(test.data, test.raw), q_ref, jax.random.PRNGKey(2))

    tp = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu", **PIPE)
    load_flax_params(tp.model, jax.device_get(params))
    steps = CONF["ddim_sampling_steps"] - 1
    q = tp.calibrate(cal, 0.0, noise=_replayed_noise(jax.random.PRNGKey(1), [cal.data.shape], steps))
    m = tp.evaluate(test, q, noise=_replayed_noise(jax.random.PRNGKey(2), [test.data.shape], steps))

    # float32 UNet3D + sampler agree to ~1e-6 relative; the solver rollout
    # runs the chunked CG to 1e-4 on both sides (kernel schedule v1), so the
    # rollout metrics agree to ~1e-5 relative. Threshold metrics must agree.
    np.testing.assert_allclose(float(q), float(q_ref), rtol=1e-4)
    assert set(m) == set(m_ref)
    for name, ref in m_ref.items():
        if "percentage" in name:
            assert m[name] == pytest.approx(float(ref), abs=1e-9), name
        else:
            np.testing.assert_allclose(m[name], float(ref), rtol=1e-3, atol=1e-7, err_msg=name)
    # the comparisons bite: a guidance-side violation, a threshold metric
    # strictly between 0 and 100, and field errors from the rollout
    assert m["J_safe_target_pred"] > 0 and 0 < m["unsafe_percentage_pred_time"] < 100
    assert m["mse"] > 0 and m["n_l2"] > 0


def test_auto_backend_is_the_kernel():
    tp = SmokePipeline(SmokeConformalConfig(**CONF), device="cpu",
                       **{**PIPE, "solver_backend": "auto"})
    assert tp.solver_kw["backend"] == "pallas_v1"
    with pytest.raises(ValueError):
        SmokePipeline(SmokeConformalConfig(**CONF), device="cpu",
                      **{**PIPE, "solver_backend": "scipy"})
