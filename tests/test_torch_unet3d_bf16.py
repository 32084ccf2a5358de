"""The port's UNet3D in bfloat16 compute against the flax model in bf16
(params float32, every Dense / Conv / K2 in bf16), with the flax weights
carried over by the weight bridge, on the CPU: the forward with either conv
(the Pallas conv in interpret mode, the port's K2 as its plain version), the
parameter gradients of a denoising-loss step, and K2's bf16 dx and dW
through the autograd Function against the JAX custom_vjp."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.core.diffusion import p_losses as jax_p_losses
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.ops import conv3d_mxu as J
from safediffcon_tpu.tasks.smoke.pipeline import build_model as jax_build_model
from safediffcon_tpu.tasks.smoke.task import train_conditioner as jax_train_conditioner
from safediffcon_torch.core.diffusion import DiffusionConfig, p_losses
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.models.convert import load_flax_params, state_dict_to_flax
from safediffcon_torch.ops import conv3d_mxu as K
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params
from safediffcon_torch.tasks.smoke.task import train_conditioner

torch.set_num_threads(1)

SHAPE = (2, 4, 8, 8, 7)  # dim 8, mults (1, 2): every block kind, one down- and upsample
# bf16 keeps 8 mantissa bits; rounding at every op, in another order than
# XLA's (which may also keep excess precision between fused ops), reaches
# ~1e-2 of the output's scale (measured 1.1e-2), as JAX's own bf16 output
# does against its float32 one
TOL = 3e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def params():
    """Seeded weights through the bridge, every leaf perturbed (zero biases
    and unit scales would hide a leaf's handling)."""
    net = init_params(build_model(8, (1, 2), device="cpu"), seed=0)
    tree = state_dict_to_flax(net, net.state_dict())
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_bf16_forward_matches_flax(params, conv_impl):
    rng = np.random.default_rng(1)
    x, t = rng.normal(size=SHAPE).astype(np.float32), np.array([3, 700], np.int32)
    jm = jax_build_model(8, (1, 2), compute_dtype="bfloat16", conv_impl=conv_impl)
    ref = np.asarray(jax.jit(jm.apply)(params, x, t))
    net = load_flax_params(build_model(8, (1, 2), compute_dtype="bfloat16",
                                       conv_impl=conv_impl, device="cpu"), params)
    net32 = load_flax_params(build_model(8, (1, 2), conv_impl=conv_impl, device="cpu"), params)
    streams = []
    net.mid_block1.register_forward_hook(lambda m, i, o: streams.append(o.dtype))
    before = dict(K.conv3d_fused_cuda.launches)
    with torch.no_grad():
        out = net(_t(x), _t(t).long())
        out32 = net32(_t(x), _t(t).long())
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert streams == [torch.bfloat16]  # the residual stream is bf16
    assert K.conv3d_fused_cuda.launches == before  # CPU tensors: the plain K2
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL * scale)
    # the comparison bites: bf16 moves the output well past float32 rounding
    assert float((out - out32).abs().max()) > 1e-3 * scale


def test_bf16_p_losses_gradients_match_flax(params):
    """The parameter gradients of a smoke denoising loss (the pretrain
    step's loss) in bf16 compute; the same t and noise on both sides."""
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([40, 610], np.int32)
    jm = jax_build_model(8, (1, 2), compute_dtype="bfloat16")
    jsched = jax_make_schedule(1000, "sigmoid")
    jcfg = JDiffusionConfig(timesteps=1000, beta_schedule="sigmoid")

    def jloss(p):
        return jax_p_losses(lambda q, a, b: jm.apply(q, a, b), p, jsched, jcfg,
                            jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                            jax_train_conditioner()).mean()

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(params)
    net = load_flax_params(build_model(8, (1, 2), compute_dtype="bfloat16", device="cpu"),
                           params)
    sched = make_schedule(1000, "sigmoid", device="cpu")
    cfg = DiffusionConfig(timesteps=1000, beta_schedule="sigmoid")
    loss = p_losses(net, sched, cfg, _t(x0), _t(t).long(), _t(noise), train_conditioner()).mean()
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in net.parameters())
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(net, {k: p.grad for k, p in net.named_parameters()}))[0])
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=2e-2)
    for path, g in leaves:
        g = np.asarray(g)
        # bf16 forward and backward through ~40 layers: 1e-1 of each leaf's
        # largest entry (measured at most 4.5e-2), and at least 1e-3 of the
        # largest gradient anywhere (a conv bias before a per-channel
        # GroupNorm has gradient 0 in exact arithmetic, so both sides hold
        # rounding noise there, measured below 4e-4 of it)
        atol = max(1e-1 * np.abs(g).max(), 1e-3 * top)
        np.testing.assert_allclose(got[path], g, rtol=0, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("shape,cout", [((2, 4, 8, 8, 8), 8), ((1, 3, 4, 8, 16), 8)])
def test_k2_bf16_dx_and_dw_match_custom_vjp(shape, cout):
    """bf16 x and weight: dx through the same conv in bf16, dW in float32
    from the bf16 operands and rounded once to bf16, on both sides."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], cout)) / np.sqrt(27 * shape[-1])).astype(np.float32)
    co = rng.normal(size=shape[:-1] + (cout,)).astype(np.float32)
    xb, kb, cob = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, co))
    out_ref, vjp = jax.vjp(lambda a, b: J.conv3d_fused(a, b, 4, True), xb, kb)
    gx_ref, gk_ref = vjp(cob)
    assert gx_ref.dtype == gk_ref.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()).bfloat16().requires_grad_()
    out = K.conv3d_fused_fn(xt, wt)
    out.backward(torch.from_numpy(co).bfloat16())
    assert out.dtype == xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for got, ref in ((out, out_ref), (xt.grad, gx_ref),
                     (wt.grad.permute(2, 3, 4, 1, 0), gk_ref)):
        ref = np.asarray(ref, np.float32)
        # one float32 sum rounded to bf16 on both sides; sums in another
        # order may round to the neighbouring bf16 value: 1e-2 of max
        np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())
