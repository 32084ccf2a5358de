"""The port's frame-axis sequence parallelism on the CPU: the UNet3D of
tests/test_parallel_sp.py (dim 8, mults (1, 2), 4 channels, 2 heads of 4,
GroupNorm(1), 8 frames of 8^2) split over the frames of sp = 2, sp = 4 and a
2 x 2 (data, frames) mesh of spawned gloo ranks, with conv_impl "xla" and
"pallas" (K2's plain version here) and remat "full" and "save_heavy": the
output and the gradients of every weight against the port unsharded and the
JAX package's single-device apply. Also the differentiable collectives
(halo exchange, all-reduce, key / value gather, output gather) against
their single-process forms."""
import numpy as np
import jax
import pytest
import torch

import torch_parallel_workers as W
from safediffcon_tpu.models import unet3d as JU
from safediffcon_torch.models.convert import state_dict_to_flax
from safediffcon_torch.models.unet3d import UNet3D
from safediffcon_torch.tasks.smoke.pipeline import init_params

torch.set_num_threads(1)

BASE = dict(dim=8, dim_mults=(1, 2), channels=4, attn_heads=2, attn_dim_head=4,
            resnet_groups=1)
VARIANTS = [("xla_full", dict(BASE, conv_impl="xla")),
            ("pallas_full", dict(BASE, conv_impl="pallas")),
            ("xla_save_heavy", dict(BASE, conv_impl="xla", remat_policy="save_heavy")),
            ("pallas_save_heavy", dict(BASE, conv_impl="pallas", remat_policy="save_heavy"))]


@pytest.fixture(scope="module")
def case():
    """Seeded weights, input, timesteps and loss cotangent; the unsharded
    port's results and JAX's single-device output and gradients."""
    net = init_params(UNet3D(**BASE), seed=0)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 7])
    cot = rng.normal(size=x.shape).astype(np.float32)
    one = W.unet3d_step(VARIANTS, sd, x, t, cot)

    jmodel = JU.UNet3D(**BASE, use_remat=False)
    params = state_dict_to_flax(net, sd)

    def loss(p):
        out = jmodel.apply(p, x, t.astype(np.int32))
        return (out * cot).sum() / x.shape[0], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref = dict(out=np.asarray(jout), loss=float(jloss),
               grads=dict(jax.tree_util.tree_flatten_with_path(jgrads)[0]))
    return dict(net=net, sd=sd, x=x, t=t, cot=cot, one=one, jax=ref)


def _as_flax(net, grads):
    flat = state_dict_to_flax(net, {k: torch.from_numpy(v) for k, v in grads.items()})
    return dict(jax.tree_util.tree_flatten_with_path(flat)[0])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)], ids=["sp2", "sp4", "dp2xsp2"])
def test_unet3d_frame_parallel_matches_unsharded_and_jax(mesh_shape, case, tmp_path):
    dp, sp = mesh_shape
    ranks = W.run_ranks(W.unet3d_step, dp * sp, tmp_path, VARIANTS, case["sd"], case["x"],
                        case["t"], case["cot"], mesh_shape=mesh_shape)
    ref = case["jax"]
    scale = np.abs(ref["out"]).max()
    for name, _ in VARIANTS:
        one = case["one"][name]
        assert one["frames"] is None
        for got in ranks:
            got = got[name]
            assert got["frames"] == 8 // sp  # the model split its frames
            # ~40 float32 layers with sums (conv taps, norms, attention over
            # gathered keys) in another order: JAX's SP test's 2e-5
            np.testing.assert_allclose(got["out"], one["out"], rtol=0, atol=2e-5 * scale)
            np.testing.assert_allclose(got["out"], ref["out"], rtol=0, atol=2e-5 * scale)
            # the loss sums 4,096 products of either sign: the outputs' bound
            # times the cotangent's L1 norm per sample
            loss_tol = 2e-5 * scale * np.abs(case["cot"]).sum() / case["x"].shape[0]
            np.testing.assert_allclose(got["loss"], one["loss"], rtol=0, atol=loss_tol)
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0, atol=loss_tol)
            flat = _as_flax(case["net"], got["grads"])
            flat_one = _as_flax(case["net"], one["grads"])
            for path, g in ref["grads"].items():
                g = np.asarray(g)
                # the same reassociation through the backward pass: 2e-5 of
                # each weight's largest gradient (measured ~5e-6)
                tol = 2e-5 * np.abs(g).max() + 1e-7
                np.testing.assert_allclose(flat[path], flat_one[path], rtol=0, atol=tol,
                                           err_msg=f"{name} {path}")
                np.testing.assert_allclose(flat[path], g, rtol=0, atol=tol,
                                           err_msg=f"{name} {path}")
        # every rank holds the same weights' gradients after the reduce
        for k, g in ranks[0][name]["grads"].items():
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[name]["grads"][k], g)


def test_collectives_match_single_process(tmp_path):
    """On sp = 4 ranks of 2 frames each: the halo exchange gives each rank
    its window of the zero-padded whole and sends the halo's cotangent back
    to its owner; the all-reduce, the key / value gather (backward:
    reduce-scatter) and the output gather (backward: the rank's slice)
    equal their single-process forms."""
    ranks = W.run_ranks(W.collectives, 4, tmp_path, 0, mesh_shape=(1, 4))
    rng = np.random.default_rng(0)
    full = torch.as_tensor(rng.normal(size=(2, 8, 3, 2)).astype(np.float32))
    cot = torch.as_tensor(rng.normal(size=(2, 10, 3, 2)).astype(np.float32))
    xf = full.clone().requires_grad_(True)
    padded = torch.nn.functional.pad(xf, (0, 0, 0, 0, 1, 1))
    windows = [padded.narrow(1, r * 2, 4) for r in range(4)]
    sum(((w * cot.narrow(1, r * 2, 4)).sum() for r, w in enumerate(windows))).backward()
    total = full.square().sum(dim=(1, 3), keepdim=True)
    for r, got in enumerate(ranks):
        assert (got["lo"], got["fl"]) == (2 * r, 2)
        np.testing.assert_array_equal(got["halo"], windows[r].detach().numpy())
        np.testing.assert_allclose(got["halo_grad"], xf.grad[:, 2 * r : 2 * r + 2].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["sum"], total.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(got["kv"], full.numpy())
        # each of the 4 ranks used the whole gathered tensor: 4x its slice
        np.testing.assert_allclose(got["kv_grad"], 4 * full[:, 2 * r : 2 * r + 2].numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["out"], full.numpy())
        np.testing.assert_array_equal(got["out_grad"], full[:, 2 * r : 2 * r + 2].numpy())
