"""Kernel K2's plain version and autograd Function (`ops/conv3d_mxu.py`)
against the JAX package's Pallas kernel run in interpret mode on the CPU, at
the shapes of tests/test_conv3d_mxu.py. The CUDA kernel itself runs only on
the card (`chip_smoke.py` holds it against the plain version there)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.ops import conv3d_mxu as J
from safediffcon_torch.ops import conv3d_mxu as K

torch.set_num_threads(1)

SHAPES = [
    ((2, 4, 8, 8, 8), 8, 4),     # tiled H
    ((1, 3, 4, 8, 16), 8, 4),    # Cin != Cout
    ((1, 2, 4, 4, 4), 4, 4),     # single H tile
    ((1, 2, 12, 8, 8), 8, 8),    # H not divisible by the tile hint
    ((1, 2, 5, 8, 8), 8, 4),     # prime H
]


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], cout)) / np.sqrt(27 * shape[-1])).astype(np.float32)
    return x, k


def _torch_weight(k):
    """flax (3, 3, 3, Cin, Cout) -> (Cout, Cin, 3, 3, 3), as the weight bridge does."""
    return torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy())


@pytest.mark.parametrize("shape,cout,tile_h", SHAPES)
def test_plain_matches_pallas_interpret(shape, cout, tile_h):
    x, k = _inputs(shape, cout, 0)
    ref = np.asarray(J.conv3d_fused(jnp.asarray(x), jnp.asarray(k), tile_h, True))
    before = dict(K.conv3d_fused_cuda.launches)
    out = K.conv3d_fused(torch.from_numpy(x), K.flatten_weight(_torch_weight(k)))
    assert out.shape == ref.shape and out.dtype == torch.float32
    # float32 sums over 27 * Cin terms in another order: the JAX test's 2e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert K.conv3d_fused_cuda.launches == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("shape,cout,tile_h", [SHAPES[1], SHAPES[4]])
def test_gradients_match_jax(shape, cout, tile_h):
    """dx (the kernel's function on the cotangent with the flipped,
    transposed weight) and dW against jax.grad through the custom_vjp."""
    x, k = _inputs(shape, cout, 1)
    co = np.random.default_rng(2).normal(size=shape[:-1] + (cout,)).astype(np.float32)
    gx_ref, gk_ref = jax.grad(
        lambda a, b: (J.conv3d_fused(a, b, tile_h, True) * co).sum(), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _torch_weight(k).requires_grad_()
    (K.conv3d_fused_fn(xt, wt) * torch.from_numpy(co)).sum().backward()
    # the JAX test's gradient tolerance
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 4, 1, 0), np.asarray(gk_ref),
                               rtol=2e-4, atol=2e-4)
    assert float(wt.grad.abs().max()) > 1.0 and float(xt.grad.abs().max()) > 0.1


def test_bf16_output_dtype_and_finite():
    x, k = _inputs((1, 3, 8, 8, 8), 8, 3)
    xb = torch.from_numpy(x).bfloat16()
    wb = K.flatten_weight(_torch_weight(k)).bfloat16()
    out = K.conv3d_fused(xb, wb)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    ref = K.conv3d_fused_plain(xb.float(), wb.float())
    # float32 sums of bf16 inputs, rounded once to bf16 (8 bits): 1e-2 of max
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0,
                               atol=1e-2 * float(ref.abs().max()))
    jout = J.conv3d_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), 8, True)
    assert jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), rtol=0,
                               atol=2e-2 * float(ref.abs().max()))


def test_weight_layouts_match_jax():
    """After the bridge's (Cout, Cin, 3, 3, 3) layout, `flatten_weight` equals
    `_flatten_kernel` and `flip_transpose` equals `_flip_transpose`."""
    _, k = _inputs((1, 1, 1, 1, 5), 3, 4)
    w = _torch_weight(k)
    np.testing.assert_array_equal(K.flatten_weight(w).numpy(),
                                  np.asarray(J._flatten_kernel(jnp.asarray(k))))
    np.testing.assert_array_equal(
        K.flatten_weight(K.flip_transpose(w)).numpy(),
        np.asarray(J._flatten_kernel(J._flip_transpose(jnp.asarray(k)))))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 2, 4, 4, 3))
    w = torch.zeros((27 * 3, 5))
    with pytest.raises(TypeError):
        K.conv3d_fused(x.double(), w.double())
    with pytest.raises(TypeError):
        K.conv3d_fused(x, w.bfloat16())
    with pytest.raises(ValueError):
        K.conv3d_fused(x, torch.zeros((27 * 4, 5)))
    with pytest.raises(ValueError):
        K.conv3d_fused(x.transpose(2, 3), w)
    with pytest.raises(ValueError):  # neither CUDA nor CPU: no silent fallback
        K.conv3d_fused(x.to("meta"), w.to("meta"))
