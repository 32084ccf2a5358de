"""Kernel K1's plain version against the JAX Pallas pressure-CG kernels
(interpret mode, as tests/test_ops_pallas.py runs them), the port's batched
"xla" CG against the JAX XLA CG, gradients, and the wrapper's checks.

The CUDA kernel itself runs only on the card; `chip_smoke.py` holds it
against this plain version there."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.ops.pressure_cg import pressure_solve_pallas
from safediffcon_tpu.solvers import smoke as JS
from safediffcon_torch.ops import pressure_cg as K
from safediffcon_torch.solvers import smoke as TS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def masks():
    return JS.build_masks(), TS.build_masks("cpu")


def _div(seed, b):
    return np.random.default_rng(seed).normal(size=(b, 127, 127)).astype(np.float32)


def test_masks_and_planes_equal(masks):
    jm, tm = masks
    for name in JS.SmokeMasks._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(
        tm.planes.numpy(), np.stack([np.asarray(getattr(jm, f))
                                     for f in ("diag", "up_y", "lo_y", "up_x", "lo_x")]))


@pytest.mark.parametrize("variant,check_every", [("v1", 1), ("v2", K.BLOCK_K)])
@pytest.mark.parametrize("b", [3, 10])
def test_plain_kernel_matches_pallas(masks, variant, check_every, b):
    """Warm start from a perturbed solution; b=10 is two chunks, the second
    holding 2 samples (the batch is not a multiple of 8)."""
    jm, tm = masks
    div = _div(b, b)
    rough = np.asarray(JS.pressure_solve(jm, jnp.asarray(div), 1e-3, 500))
    guess = (rough + 0.01 * np.random.default_rng(1).normal(size=div.shape)).astype(np.float32)
    ref = np.asarray(pressure_solve_pallas(jm, jnp.asarray(div), 1e-5, 500, interpret=True,
                                           guess=jnp.asarray(guess), variant=variant))
    out, iters = K.pressure_cg(torch.from_numpy(div), torch.from_numpy(guess), tm.planes,
                               1e-5, 500, check_every)
    assert iters.shape == (-(-b // K.CHUNK),)
    assert (iters > 0).all() and (iters % check_every == 0).all()
    # same recurrence, float32 dot products summed in another order; the
    # solution is determined to the CG tolerance (measured 8e-7 of max|x|)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("warm", [False, True])
def test_xla_backend_matches_jax_xla_cg(masks, warm):
    jm, tm = masks
    div = _div(5, 3)
    guess = (0.1 * np.random.default_rng(6).normal(size=div.shape)).astype(np.float32)
    ref = np.asarray(JS.pressure_solve(jm, jnp.asarray(div), 1e-5, 500,
                                       guess=jnp.asarray(guess) if warm else None))
    out = TS.pressure_solve(tm, torch.from_numpy(div), 1e-5, 500,
                            guess=torch.from_numpy(guess) if warm else None)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_max_iter_rounding_of_the_32_check(masks):
    """accuracy 0 never converges: v1 stops at max_iter, v2 at the next
    multiple of 32 (pressure_cg.py:214-221)."""
    _, tm = masks
    div = torch.from_numpy(_div(7, 2))
    for check_every, expect in ((1, 40), (K.BLOCK_K, 64)):
        _, iters = K.pressure_cg(div, torch.zeros_like(div), tm.planes, 0.0, 40, check_every)
        assert iters.tolist() == [expect]


def test_converged_guess_returns_unchanged(masks):
    _, tm = masks
    div = torch.from_numpy(_div(8, 9))
    x, _ = K.pressure_cg(div, torch.zeros_like(div), tm.planes, 1e-5, 500, 1)
    again, iters = K.pressure_cg(div, x, tm.planes, 1e-3, 500, K.BLOCK_K)
    assert iters.tolist() == [0, 0]
    assert torch.equal(again, x)


def test_zero_chunk_stays_zero_and_finite(masks):
    """An all-zero sample in a chunk with a live one: the safe divide keeps
    the extra iterations NaN-free and the zero sample zero."""
    _, tm = masks
    div = torch.from_numpy(_div(9, 2))
    div[1] = 0.0
    x, _ = K.pressure_cg(div, torch.zeros_like(div), tm.planes, 1e-6, 500, K.BLOCK_K)
    assert torch.isfinite(x).all()
    assert (x[1] == 0).all()


@pytest.mark.parametrize("solve", ["kernel", "xla"])
def test_gradient_adjoint(masks, solve):
    """Mirrors tests/test_ops_pallas.py::test_gradient_adjoint: the backward
    pass is a solve of the cotangent, so A (dL/ddiv) = w."""
    _, tm = masks
    rng = np.random.default_rng(2)
    div = torch.from_numpy(rng.normal(size=(1, 127, 127)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(1, 127, 127)).astype(np.float32))
    guess = torch.zeros_like(w).requires_grad_()
    if solve == "kernel":
        p = K.pressure_solve_kernel(tm, div, 1e-7, 2000, guess=guess)
    else:
        p = TS.pressure_solve(tm, div, 1e-7, 2000, guess=guess)
    (p * w).sum().backward()
    recovered = TS._apply_A(tm, div.grad)
    assert float((recovered - w).abs().max()) < 1e-3
    assert (guess.grad == 0).all()


def test_wrapper_checks(masks):
    _, tm = masks
    div = torch.from_numpy(_div(10, 2))
    planes = tm.planes
    with pytest.raises(TypeError):
        K.pressure_cg(div.double(), div.double(), planes, 1e-6, 10)
    with pytest.raises(ValueError):
        K.pressure_cg(div.transpose(1, 2), div, planes, 1e-6, 10)  # not contiguous
    with pytest.raises(ValueError):
        K.pressure_cg(div, div[:1], planes, 1e-6, 10)
    with pytest.raises(ValueError):
        K.pressure_cg(div, div, planes[:4], 1e-6, 10)
    with pytest.raises(ValueError):
        K.pressure_cg(div, div, planes, 1e-6, 10, check_every=0)
    x, iters = K.pressure_cg(div[:0], div[:0], planes, 1e-6, 10)
    assert x.shape == (0, 127, 127) and iters.shape == (0,)


def test_cpu_tensors_never_reach_the_kernel(masks):
    _, tm = masks
    before = K.pressure_cg_cuda.launches
    div = torch.from_numpy(_div(11, 2))
    K.pressure_solve_kernel(tm, div, 1e-4, 50)
    assert K.pressure_cg_cuda.launches == before
