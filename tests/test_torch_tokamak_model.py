"""Parity of the port's UNet1D and its 1-D blocks (`models/layers.py`,
`models/unet1d.py`) with the flax modules, with the flax weights carried
over by the weight bridge (`models/convert.py`), in float32 and in bfloat16
compute, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.core.diffusion import p_losses as jax_p_losses
from safediffcon_tpu.core.schedules import make_schedule as jax_make_schedule
from safediffcon_tpu.models import layers as JL
from safediffcon_tpu.models.unet1d import UNet1D as JUNet1D
from safediffcon_tpu.tasks.tokamak.task import train_conditioner as jax_train_conditioner
from safediffcon_torch.core.diffusion import DiffusionConfig, p_losses
from safediffcon_torch.core.schedules import make_schedule
from safediffcon_torch.models import layers as TL
from safediffcon_torch.models.convert import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from safediffcon_torch.models.unet1d import UNet1D
from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params
from safediffcon_torch.tasks.tokamak.task import train_conditioner

torch.set_num_threads(1)

DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, "bfloat16")}
# float32: ~40 layers with reductions in another order (measured 3e-7 of
# the output's scale); bf16 keeps 8 mantissa bits, rounded at every op in
# another order than XLA's (measured 1.1e-2, as JAX's bf16 output against
# its float32 one)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SHAPE = (2, 128, 12)  # batch, trajectory rows, channels


def _perturbed(params, seed):
    """flax init gives zero biases and unit scales; perturb every leaf so the
    bridge's handling of each one is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _apply_block(jmod, x, seed):
    """The flax block's perturbed params and its output on x."""
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    return params, np.asarray(jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("kernel_size", [1, 3, 7])
def test_conv1d_same(kernel_size):
    x = _x((2, 16, 5))
    m = fnn.Conv(6, kernel_size=(kernel_size,), padding="SAME")
    p, ref = _apply_block(m, x, 1)
    mod = TL.Conv1dCL(5, 6, kernel_size)
    mod.weight.data = _t(p["params"]["kernel"].transpose(2, 1, 0).copy())
    mod.bias.data = _t(p["params"]["bias"])
    with torch.no_grad():
        out = mod(_t(x)).numpy()
    # k * Cin-term float32 dot products: 1e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_downsample_1d_is_a_strided_conv():
    """ndim 1: kernel 4, stride 2, padding (1, 1), no space-to-depth."""
    x = _x((2, 16, 4), 2)
    p, ref = _apply_block(JL.Downsample(6, ndim=1), x, 3)
    mod = TL.Downsample(4, 6, ndim=1)
    mod.conv.weight.data = _t(p["params"]["Conv_0"]["kernel"].transpose(2, 1, 0).copy())
    mod.conv.bias.data = _t(p["params"]["Conv_0"]["bias"])
    with torch.no_grad():
        out = mod(_t(x)).numpy()
    assert out.shape == ref.shape == (2, 8, 6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_upsample_1d_repeats_then_convolves():
    x = _x((2, 8, 4), 4)
    p, ref = _apply_block(JL.Upsample(6, ndim=1), x, 5)
    mod = TL.Upsample(4, 6, ndim=1)
    mod.conv.weight.data = _t(p["params"]["Conv_0"]["kernel"].transpose(2, 1, 0).copy())
    mod.conv.bias.data = _t(p["params"]["Conv_0"]["bias"])
    with torch.no_grad():
        out = mod(_t(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny_params():
    """dim 8, mults (1, 2): seeded by the port's `init_params` and carried
    over by the bridge, every leaf perturbed."""
    net = init_params(build_model(8, (1, 2), device="cpu"), seed=0)
    return _perturbed(state_dict_to_flax(net, net.state_dict()), 11)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet1d_forward_matches_flax(tiny_params, dtype):
    jdt, tdt = DTYPES[dtype]
    x, t = _x(SHAPE, 12), np.array([3, 700], np.int32)
    jm = JUNet1D(dim=8, dim_mults=(1, 2), compute_dtype=jdt or jnp.float32)
    ref = np.asarray(jax.jit(jm.apply)(tiny_params, x, t))
    net = load_flax_params(build_model(8, (1, 2), compute_dtype=tdt, device="cpu"), tiny_params)
    with torch.no_grad():
        out = net(_t(x), _t(t).long())
    assert out.dtype == torch.float32 and ref.dtype == np.float32 and out.shape == SHAPE
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())
    if tdt:  # the comparison bites: bf16 moves the output well past float32 rounding
        net32 = load_flax_params(build_model(8, (1, 2), device="cpu"), tiny_params)
        with torch.no_grad():
            out32 = net32(_t(x), _t(t).long())
        assert float((out - out32).abs().max()) > 1e-3 * np.abs(ref).max()


def test_unet1d_p_losses_gradients_match_flax(tiny_params):
    """Every parameter's gradient of one tokamak denoising loss (the pretrain
    step's), the same t and noise on both sides, float32."""
    x0, noise = _x(SHAPE, 13), _x(SHAPE, 14)
    t = np.array([40, 610], np.int32)
    jm = JUNet1D(dim=8, dim_mults=(1, 2))
    jsched = jax_make_schedule(1000, "cosine")
    jcfg = JDiffusionConfig(timesteps=1000)

    def jloss(p):
        return jax_p_losses(lambda q, a, b: jm.apply(q, a, b), p, jsched, jcfg,
                            jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise),
                            jax_train_conditioner()).mean()

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(tiny_params)
    net = load_flax_params(build_model(8, (1, 2), device="cpu"), tiny_params)
    loss = p_losses(net, make_schedule(1000, "cosine", device="cpu"),
                    DiffusionConfig(timesteps=1000, beta_schedule="cosine"), _t(x0),
                    _t(t).long(), _t(noise), train_conditioner()).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_dict_to_flax(net, {k: p.grad for k, p in net.named_parameters()}))[0])
    for path, g in jax.tree_util.tree_flatten_with_path(ref)[0]:
        g = np.asarray(g)
        # float32 backward through the same layers: 1e-4 of each leaf's max
        np.testing.assert_allclose(got[path], g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                   err_msg=str(path))


def test_unet1d_bridge_round_trip_and_names():
    """flax tree -> state_dict -> flax tree is the identity, bit for bit; the
    names and shapes are flax's own (RMSNorm_0 in the pre-norm and the
    linear attention, (k, Cin, Cout) conv kernels)."""
    net = init_params(build_model(8, (1, 2), device="cpu"), seed=1)
    tree = state_dict_to_flax(net, net.state_dict())
    sd = flax_to_state_dict(net, tree)
    assert sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = state_dict_to_flax(net, sd)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0], strict=True):
        assert pa == pb and np.array_equal(a, b)
    shapes = jax.eval_shape(JUNet1D(dim=8, dim_mults=(1, 2)).init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE), jnp.zeros((2,), jnp.int32))
    assert (jax.tree_util.tree_map(lambda a: a.shape, shapes)
            == jax.tree_util.tree_map(np.shape, tree))
    assert set(tree["params"]["PreNormResidual_0"]) == {"RMSNorm_0"}
    assert tree["params"]["init_conv"]["kernel"].shape == (7, 12, 8)


def test_unet1d_bridge_is_strict(tiny_params):
    with pytest.raises(RuntimeError):  # shapes differ at another width
        load_flax_params(build_model(16, (1, 2), device="cpu"), tiny_params)
    with pytest.raises(ValueError):
        UNet1D(dim=8, dim_mults=(1, 2), compute_dtype="float16")


def test_reference_width_parameter_count():
    """The reference "turbo" UNet1D: dim 128, mults (1, 2, 4, 8), 12 channels,
    1 resnet group, 4 heads x 32."""
    with torch.device("meta"):
        net = build_model(device="meta")
    assert sum(p.numel() for p in net.parameters()) == 57_341_452
