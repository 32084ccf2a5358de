"""Parity of the port's smoke solver with `safediffcon_tpu/solvers/smoke.py`:
the staggered-grid operators, bilinear resampling with the reference's
boundary quirk, advection, the incompressible projection on each backend,
and a short `evaluate_control` rollout."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.solvers import smoke as JS
from safediffcon_torch.solvers import smoke as TS

torch.set_num_threads(1)

# float32 elementwise operators: exact up to rounding
TIGHT = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def masks():
    return JS.build_masks(), TS.build_masks("cpu")


def _vel(seed, b=2, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=(b, 128, 128, 2))).astype(np.float32)


def test_staggered_operators():
    v = _vel(0)
    p = np.random.default_rng(1).normal(size=(2, 127, 127)).astype(np.float32)
    np.testing.assert_allclose(TS.divergence(torch.from_numpy(v)).numpy(),
                               JS.divergence(jnp.asarray(v)), **TIGHT)
    np.testing.assert_allclose(TS.at_centers(torch.from_numpy(v)).numpy(),
                               JS.at_centers(jnp.asarray(v)), **TIGHT)
    # numpy's "symmetric" pad of width 1 is torch's "replicate"
    np.testing.assert_allclose(TS.pressure_gradient(torch.from_numpy(p)).numpy(),
                               JS.pressure_gradient(jnp.asarray(p)), **TIGHT)


def test_bilinear_sample_boundary_quirk():
    """Coordinates below 0, between dim-1 and dim, and past dim: clamped to
    [0, dim], and zero past dim-1."""
    rng = np.random.default_rng(2)
    field = rng.normal(size=(2, 127, 127)).astype(np.float32)
    coords = rng.uniform(-5.0, 132.0, size=(2, 127, 127, 2)).astype(np.float32)
    coords[0, 0, :4] = [[126.5, 3.0], [127.0, 126.0], [-1.0, 126.2], [126.0, 126.0]]
    out = TS.bilinear_sample(torch.from_numpy(field), torch.from_numpy(coords)).numpy()
    ref = np.asarray(JS.bilinear_sample(jnp.asarray(field), jnp.asarray(coords)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert out[0, 0, 0] == 0.0 and out[0, 0, 3] != 0.0


def test_advect_scalar():
    rng = np.random.default_rng(3)
    field = rng.uniform(size=(2, 127, 127)).astype(np.float32)
    v = _vel(4, scale=2.0)
    np.testing.assert_allclose(
        TS.advect_scalar(torch.from_numpy(field), torch.from_numpy(v)).numpy(),
        JS.advect_scalar(jnp.asarray(field), jnp.asarray(v)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas_v1", "pallas"])
def test_divergence_free_matches_jax_xla(masks, backend):
    """Every port backend against the JAX XLA projection (the bar
    tests/test_ops_pallas.py::test_rollout_backend_equality sets for the
    Pallas kernels): the projected velocity is tight; the pressure is only
    determined to the CG tolerance."""
    jm, tm = masks
    v = _vel(5)
    ref, p_ref = JS.divergence_free(jm, jnp.asarray(v), accuracy=1e-6, max_iter=300,
                                    return_pressure=True, backend="xla")
    out, p_out = TS.divergence_free(tm, torch.from_numpy(v), accuracy=1e-6, max_iter=300,
                                    return_pressure=True, backend=backend)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < 2e-3
    assert float(np.abs(p_out.numpy() - np.asarray(p_ref)).max()) < 1e-2
    if backend == "xla":  # the same batched CG: to rounding
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_unknown_backend_raises(masks):
    _, tm = masks
    with pytest.raises(ValueError):
        TS.divergence_free(tm, torch.from_numpy(_vel(6)), backend="cudnn")


def test_default_backend_is_the_kernel(masks):
    """With no backend named, the projection takes kernel K1's path
    ("auto" = "pallas_v1"), bit for bit, and not the whole-batch CG."""
    _, tm = masks
    v = torch.from_numpy(_vel(7, b=10))
    assert TS.resolve_backend("auto") == "pallas_v1"
    default = TS.divergence_free(tm, v, accuracy=1e-6, max_iter=300)
    kernel = TS.divergence_free(tm, v, accuracy=1e-6, max_iter=300, backend="pallas_v1")
    plain = TS.divergence_free(tm, v, accuracy=1e-6, max_iter=300, backend="xla")
    assert torch.equal(default, kernel)
    assert not torch.equal(default, plain)


@pytest.mark.parametrize("backend", ["xla", "pallas_v1"])
def test_evaluate_control_rollout(masks, backend):
    """3 record frames x time_scale 2 -> 5 solver steps, 6 frames at 128^2; both
    sides run their XLA CG as the reference, the port also its kernel path."""
    jm, tm = masks
    rng = np.random.default_rng(7)
    dens = np.zeros((2, 64, 64), np.float32)
    dens[:, 10:16, 20:30] = 1.0
    c1 = rng.normal(0.5, 0.05, size=(2, 3, 64, 64)).astype(np.float32)
    c2 = rng.normal(1.0, 0.1, size=(2, 3, 64, 64)).astype(np.float32)
    kw = dict(accuracy=1e-6, max_iter=300, time_scale=2, space_scale=2)
    s_ref, f_ref, rec_ref = JS.evaluate_control(jm, jnp.asarray(dens), jnp.asarray(c1),
                                                jnp.asarray(c2), backend="xla", **kw)
    s, f, rec = TS.evaluate_control(tm, torch.from_numpy(dens), torch.from_numpy(c1),
                                    torch.from_numpy(c2), backend=backend, **kw)
    assert rec.density.shape == rec_ref.density.shape == (2, 6, 127, 127)
    assert rec.velocity.shape == (2, 6, 128, 128, 2)
    # CG to 1e-6 then advection: fields agree to 1e-4 (XLA vs XLA) and to
    # the CG tolerance's effect on the velocity (kernel vs XLA)
    atol = 1e-4 if backend == "xla" else 2e-3
    np.testing.assert_allclose(rec.velocity.numpy(), rec_ref.velocity, rtol=0, atol=atol)
    np.testing.assert_allclose(rec.density.numpy(), rec_ref.density, rtol=0, atol=atol)
    np.testing.assert_allclose(rec.mass.numpy(), rec_ref.mass, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=0, atol=1e-5)
