"""The port's CPU path where it once left JAX's: the bf16 3-D conv of the
UNet3D (its 7x7x7 `init_conv` on a channels-last input, whose oneDNN bf16
backward corrupted memory) and the smoke solver's `bilinear_sample` at
non-finite coordinates (which raised in `torch.gather`), each against the
JAX package on the same inputs."""
import numpy as np
import flax.linen as nn
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.solvers import smoke as JS
from safediffcon_torch.models.unet3d import Conv3dCL, ConvTransposeCL
from safediffcon_torch.solvers import smoke as TS

torch.set_num_threads(1)


def test_bf16_init_conv_backward_matches_jax():
    """UNet3D's init_conv in bf16 compute (float32 parameters, the input a
    channels-last view as the model hands it over): the output and the
    gradients of x and of the kernel and bias against flax's
    nn.Conv(dtype=bfloat16) on the same values."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 8, 8, 7)).astype(np.float32)
    kernel = (rng.normal(size=(7, 7, 7, 7, 8)) / np.sqrt(7 ** 4)).astype(np.float32)
    bias = (0.1 * rng.normal(size=8)).astype(np.float32)
    co = rng.normal(size=(2, 4, 8, 8, 8)).astype(np.float32)

    conv = nn.Conv(8, kernel_size=(7, 7, 7), padding="SAME", dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    out_ref, vjp = jax.vjp(lambda p, a: conv.apply(p, a), params, jnp.asarray(x, jnp.bfloat16))
    gp, gx = vjp(jnp.asarray(co, jnp.bfloat16))

    m = Conv3dCL(7, 8, kernel_size=7, padding=3, dtype=torch.bfloat16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy()))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = m(xt)
    out.backward(torch.from_numpy(co).bfloat16())
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    assert m.weight.grad.dtype == torch.float32
    pairs = [(out, out_ref), (xt.grad, gx),
             (m.weight.grad.permute(2, 3, 4, 1, 0), gp["params"]["kernel"])]
    for got, ref in pairs:
        ref = np.asarray(ref, np.float32)
        # float32 sums of up to 2,401 products rounded once to bf16 on both
        # sides (the kernel's gradient then widened): sums in another order
        # may round to the neighbouring bf16 value, 1e-2 of max (measured:
        # output and dx equal, dW 2.0e-4)
        np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())
    # the bias gradient, the cotangent's sum over 512 positions: the port's
    # is the exact sum rounded once to bf16; JAX's carries its bf16
    # accumulation (measured 1.2e-2 of max off the exact sum)
    exact = np.asarray(jnp.asarray(co, jnp.bfloat16), np.float64).sum(axis=(0, 1, 2, 3))
    np.testing.assert_allclose(m.bias.grad.numpy(), exact, rtol=2.0 ** -8, atol=0)
    ref = np.asarray(gp["params"]["bias"], np.float32)
    np.testing.assert_allclose(m.bias.grad.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("halo", [False, True])
def test_bf16_conv_on_cpu_rounds_once_like_xla(halo):
    """A bf16 conv of CPU tensors is a float32 conv of the bf16-rounded
    operands, rounded once to bf16, plus the bias in bf16; the halo branch
    (the frames already padded) takes the same path. The transposed conv
    too."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 6, 8, 8, 4)).astype(np.float32))
    m = Conv3dCL(4, 5, kernel_size=3, padding=1, dtype=torch.bfloat16)
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(rng.normal(size=5).astype(np.float32)))
    xb = x.bfloat16().permute(0, 4, 1, 2, 3).float()
    pad = (0, 1, 1) if halo else (1, 1, 1)
    want = torch.nn.functional.conv3d(xb, m.weight.bfloat16().float(), None, 1, pad)
    want = (want.bfloat16() + m.bias.bfloat16().view(-1, 1, 1, 1)).permute(0, 2, 3, 4, 1)
    got = m(x, halo=halo)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)

    t = ConvTransposeCL(4, 5, (1, 4, 4), (1, 2, 2), dtype=torch.bfloat16)
    torch.nn.init.normal_(t.weight)
    w = t.weight.flip(2, 3, 4).transpose(0, 1).bfloat16().float()
    want = torch.nn.functional.conv_transpose3d(xb, w, None, stride=t.stride, padding=t.padding)
    want = (want.bfloat16() + t.bias.bfloat16().view(-1, 1, 1, 1)).permute(0, 2, 3, 4, 1)
    assert torch.equal(t(x), want)


def test_bilinear_sample_at_non_finite_coordinates_matches_jax():
    """NaN, +inf and -inf in either coordinate, alone and together, beside
    finite ones: the port's values equal JAX's (0 where a coordinate is NaN
    or past dim - 1, the clamped low edge for -inf), with no exception."""
    rng = np.random.default_rng(2)
    field = rng.normal(size=(2, 6, 5)).astype(np.float32)
    coords = rng.uniform(-1, 7, size=(2, 6, 5, 2)).astype(np.float32)
    specials = [np.nan, np.inf, -np.inf]
    for i, a in enumerate(specials):
        coords[0, i, 0] = [a, 2.5]
        coords[0, i, 1] = [1.5, a]
        for j, b in enumerate(specials):
            coords[1, i, j] = [a, b]
    ref = np.asarray(jax.jit(JS.bilinear_sample)(jnp.asarray(field), jnp.asarray(coords)))
    got = TS.bilinear_sample(torch.from_numpy(field), torch.from_numpy(coords)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got[0, 0, 0] == got[1, 0, 0] == 0.0  # a NaN coordinate reads 0
    assert got[1, 2, 2] == field[1, 0, 0]  # -inf in both: the corner [0, 0]
