"""The port's UNet2D and UNet1D at the "turbo" depth (dim_mults (1, 2, 4, 8):
four levels, three downsamples, the middle levels the two-level parity
tests never reach) against the flax modules at a small width (dim 16),
with the flax weights carried over by the bridge, every leaf perturbed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_burgers_model import _perturbed, _x
from safediffcon_tpu.models.unet1d import UNet1D as JUNet1D
from safediffcon_tpu.models.unet2d import UNet2D as JUNet2D
from safediffcon_torch.models.convert import load_flax_params, state_dict_to_flax
from safediffcon_torch.tasks.burgers import pipeline as BP
from safediffcon_torch.tasks.tokamak import pipeline as TP

torch.set_num_threads(1)

MULTS = (1, 2, 4, 8)
# float32: ~60 layers with reductions in another order (seen 1.4e-6);
# bf16: 8-bit rounding at every op in another order (seen 1.8e-2)
TOL = {None: 1e-5, "bfloat16": 3e-2}
CASES = {
    "unet2d": (BP, JUNet2D, (2, 16, 128, 3)),
    "unet1d": (TP, JUNet1D, (2, 128, 12)),
}


@pytest.mark.parametrize("name,dtype", [("unet2d", None), ("unet2d", "bfloat16"),
                                        ("unet1d", None), ("unet1d", "bfloat16")])
def test_turbo_depth_forward_matches_flax(name, dtype):
    pipe, jcls, shape = CASES[name]
    net = pipe.init_params(pipe.build_model(16, MULTS, device="cpu"), seed=0)
    params = _perturbed(state_dict_to_flax(net, net.state_dict()), 11)
    x, t = _x(shape, 12), np.array([3, 700], np.int32)
    jdt = jnp.bfloat16 if dtype else jnp.float32
    ref = np.asarray(jax.jit(jcls(dim=16, dim_mults=MULTS, compute_dtype=jdt).apply)(
        params, x, t), np.float32)
    model = load_flax_params(pipe.build_model(16, MULTS, compute_dtype=dtype, device="cpu"),
                             params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long()).float().numpy()
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())
