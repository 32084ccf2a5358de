"""The Burgers FD solver and dataset against the JAX package:
`burgers_solve` over the full 10,000 explicit-Euler steps at two widths, the
dataset generator at the JAX end-to-end test's tiny size (the same numpy
draws, so u0 and f equal bit for bit), `stack_and_pad` and the npz loader,
and the solver's evaluation path (`control_trajectories`)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.solvers.burgers import burgers_solve as jax_burgers_solve
from safediffcon_tpu.tasks.burgers import data as JD
from safediffcon_tpu.tasks.burgers import metrics as JM
from safediffcon_torch.solvers.burgers import burgers_solve
from safediffcon_torch.tasks.burgers import BurgersDataset, generate_burgers_dataset
from safediffcon_torch.tasks.burgers import data as TD
from safediffcon_torch.tasks.burgers import metrics as TM

torch.set_num_threads(1)


@pytest.mark.parametrize("n,s", [(4, 32), (2, 128)])
def test_solver_matches_jax_full_rollout(n, s):
    """10 chunks of 1,000 steps of dt 1e-4: the same float32 arithmetic in
    the same order (measured 6e-8 of max|u|)."""
    rng = np.random.default_rng(s)
    u0 = (0.5 * rng.normal(size=(n, s))).astype(np.float32)
    f = (0.5 * rng.normal(size=(n, 10, s))).astype(np.float32)
    ref = np.asarray(jax_burgers_solve(jnp.asarray(u0), jnp.asarray(f)))
    out = burgers_solve(torch.from_numpy(u0), torch.from_numpy(f)).numpy()
    assert out.shape == ref.shape == (n, 11, s)
    np.testing.assert_array_equal(out[:, 0], u0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(out[:, -1] - out[:, 0]).max() > 0.1  # the state evolved


def test_solver_rejects_bad_shapes():
    u0 = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        burgers_solve(u0, torch.zeros((2, 9, 16)))
    with pytest.raises(ValueError):  # 10,000 steps do not split into 3 chunks
        burgers_solve(u0, torch.zeros((2, 3, 16)), num_t=3)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    d = tmp_path_factory.mktemp("burgers")
    kw = dict(n_train=16, n_cal=8, n_test=4, seed=0, nx=32)
    ref = JD.generate_burgers_dataset(str(d / "jax.npz"), **kw)
    out = generate_burgers_dataset(str(d / "port.npz"), device="cpu", solve_batch=7, **kw)
    return d, ref, out


def test_dataset_generation_matches_jax(generated):
    """u0 and f from the same numpy draws (bit for bit); u from the rollout
    (in batches of 7 here, of 4,096 in JAX)."""
    _, ref, out = generated
    assert ref.keys() == out.keys() == {"train", "cal", "test"}
    for split, (u_ref, f_ref) in ref.items():
        u, f = out[split]
        np.testing.assert_array_equal(f, f_ref)
        np.testing.assert_array_equal(u[:, 0], u_ref[:, 0])
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-5 * np.abs(u_ref).max())
    assert out["train"][0].shape == (16, 11, 32) and out["test"][1].shape == (4, 10, 32)


@pytest.mark.parametrize("use_max_safety", [True, False])
def test_loader_and_stack_and_pad_match_jax(generated, use_max_safety):
    d, _, _ = generated
    for split in ("train", "cal", "test"):
        ref = JD.BurgersDataset.load(str(d / "port.npz"), split, use_max_safety, subset=5)
        out = BurgersDataset.load(str(d / "port.npz"), split, use_max_safety, subset=5)
        np.testing.assert_array_equal(out.data, ref.data)
        np.testing.assert_array_equal(out.u_phys, ref.u_phys)
        assert len(out) == min(5, len(ref))
    batches = list(out.batches(2, shuffle=True, seed=3))
    ref_batches = list(ref.batches(2, shuffle=True, seed=3))
    for (i, b), (ri, rb) in zip(batches, ref_batches, strict=True):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(b, rb)


@pytest.mark.parametrize("partial_control,alpha", [("front_rear_quarter", 1.0), (None, 1.7)])
def test_force_variants_match_jax(partial_control, alpha):
    out = TD._varying_f(np.random.default_rng(2), 3, 32, 10, partial_control=partial_control,
                        alpha=alpha)
    ref = JD._varying_f(np.random.default_rng(2), 3, 32, 10, partial_control=partial_control,
                        alpha=alpha)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError):
        TD._varying_f(np.random.default_rng(2), 3, 32, 10, partial_control="middle")


def test_control_trajectories_match_jax():
    """The evaluation rollout: u0 from row 0 of the sample's u channel, the
    force from rows 0..9 of its f channel."""
    rng = np.random.default_rng(4)
    diffused = (0.5 * rng.normal(size=(3, 16, 32, 3))).astype(np.float32)
    ref = np.asarray(JM.control_trajectories(jnp.asarray(diffused)))
    out = TM.control_trajectories(torch.from_numpy(diffused)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
