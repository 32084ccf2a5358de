"""Parity of the port's UNet3D and its layers with the flax modules, with the
flax weights carried over by the weight bridge (`models/convert.py`).
Everything runs in float32 on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from safediffcon_tpu.models import layers as JL
from safediffcon_tpu.models import unet3d as JU
from safediffcon_tpu.tasks.smoke.pipeline import build_model as jax_build_model
from safediffcon_torch.models import layers as TL
from safediffcon_torch.models import unet3d as TU
from safediffcon_torch.models.convert import load_flax_params, state_dict_to_flax
from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

torch.set_num_threads(1)


def _perturbed(params, seed):
    """flax init gives zero biases and unit scales; perturb every leaf so the
    bridge's handling of each one is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_chan_layer_norm_biased_variance():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 8)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=8).astype(np.float32)
    ref = JL.ChanLayerNorm().apply({"params": {"g": g}}, x)
    mod = TL.ChanLayerNorm(8)
    mod.g.data = _t(g)
    # float32 reductions in another order: a few ulps
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_time_mlp_exact_gelu():
    t = np.array([0, 7, 999], np.int32)
    m = JL.TimeMLP(8, 32)
    p = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(t)), 2)["params"]
    ref = m.apply({"params": p}, jnp.asarray(t))
    mod = TL.TimeMLP(8, 32)
    for name, lin in (("Dense_0", mod.linear1), ("Dense_1", mod.linear2)):
        lin.weight.data = _t(p[name]["kernel"].T.copy())
        lin.bias.data = _t(p[name]["bias"])
    # sin/cos of t * freq up to t = 999 in float32: relative 1e-5
    np.testing.assert_allclose(mod(_t(t)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (5, 6), (16, 16)])
def test_conv_transpose_upsample_matches_flax(hw):
    """flax ConvTranspose k(1,4,4) s(1,2,2) SAME correlates the dilated input
    with the UNflipped kernel; the port reproduces that exactly."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, *hw, 5)).astype(np.float32)
    m = fnn.ConvTranspose(6, kernel_size=(1, 4, 4), strides=(1, 2, 2), padding="SAME")
    p = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)["params"]
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    mod = TU.ConvTransposeCL(5, 6, kernel_size=(1, 4, 4), stride=(1, 2, 2))
    mod.weight.data = _t(p["kernel"].transpose(4, 3, 0, 1, 2).copy())
    mod.bias.data = _t(p["bias"])
    out = mod(_t(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 3, 2 * hw[0], 2 * hw[1], 6)
    # 16-term float32 dot products: 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_strided_downsample_matches_flax():
    x = np.random.default_rng(5).normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    m = fnn.Conv(6, kernel_size=(1, 4, 4), strides=(1, 2, 2), padding=((0, 0), (1, 1), (1, 1)))
    p = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)["params"]
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    mod = TU.Conv3dCL(4, 6, kernel_size=(1, 4, 4), stride=(1, 2, 2), padding=(0, 1, 1))
    mod.weight.data = _t(p["kernel"].transpose(4, 3, 0, 1, 2).copy())
    mod.bias.data = _t(p["bias"])
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["packed", "heads"])
def test_temporal_attention_with_rope_and_bias(attn_impl):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, 3, 4, 8)).astype(np.float32)
    bias = rng.normal(size=(4, 6, 6)).astype(np.float32)
    m = JU.TemporalAttention(4, 32, attn_impl=attn_impl)
    p = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 8)["params"]
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), pos_bias=jnp.asarray(bias)))
    mod = TU.TemporalAttention(8, 4, 32)
    mod.to_qkv.weight.data = _t(p["Dense_0"]["kernel"].T.copy())
    mod.to_out.weight.data = _t(p["Dense_1"]["kernel"].T.copy())
    out = mod(_t(x), pos_bias=_t(bias)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_rel_pos_buckets_equal():
    for n in (4, 32):
        np.testing.assert_array_equal(TU._rel_pos_buckets(n, 32, 32), JU._rel_pos_buckets(n, 32, 32))


@pytest.fixture(scope="module")
def tiny_unet():
    model = jax_build_model(8, (1, 2))
    x = jnp.zeros((1, 4, 16, 16, 7))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32))
    return model, _perturbed(params, 0)


def test_unet3d_forward_through_bridge(tiny_unet):
    """dim 8, mults (1, 2), 4 frames of 16^2: every block kind once, with
    one down- and one upsample."""
    model, params = tiny_unet
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 4, 16, 16, 7)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ref = np.asarray(jax.jit(model.apply)(params, x, t))
    net = load_flax_params(build_model(8, (1, 2), device="cpu"), params)
    with torch.no_grad():
        out = net(_t(x), _t(t).long()).numpy()
    assert out.shape == ref.shape == (2, 4, 16, 16, 7)
    # ~40 float32 layers with reductions in another order: 1e-5 of the
    # output's scale (measured 1e-6)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_bridge_is_strict(tiny_unet):
    _, params = tiny_unet
    with pytest.raises(RuntimeError):  # shapes differ at another width
        load_flax_params(build_model(16, (1, 2), device="cpu"), params)


def test_conv_impl_pallas_raises():
    """conv_impl="pallas" builds (its 3x3x3 convs on kernel K2), also in
    bfloat16 and with remat "save_heavy"; an unknown flag raises."""
    net = TU.UNet3D(dim=8, dim_mults=(1, 2), conv_impl="pallas")
    assert isinstance(net.downs[0][0].block1.conv, TU.FusedConv3x3x3)
    assert isinstance(TU.UNet3D(dim=8, dim_mults=(1, 2)).downs[0][0].block1.conv, TU.Conv3dCL)
    with pytest.raises(ValueError):
        TU.UNet3D(dim=8, dim_mults=(1, 2), conv_impl="cudnn")
    net = TU.UNet3D(dim=8, dim_mults=(1, 2), conv_impl="pallas", compute_dtype="bfloat16")
    assert net.downs[0][0].block1.conv.compute_dtype == torch.bfloat16
    net = TU.UNet3D(dim=8, dim_mults=(1, 2), conv_impl="pallas", remat_policy="save_heavy")
    assert net.remat_policy == "save_heavy"
    with pytest.raises(ValueError):
        TU.UNet3D(dim=8, dim_mults=(1, 2), compute_dtype="float16")
    with pytest.raises(ValueError):
        TU.UNet3D(dim=8, dim_mults=(1, 2), remat_policy="none")


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_bridge_round_trip_exact(tiny_unet, conv_impl):
    """flax -> torch -> flax gives the same tree, leaf for leaf, for a model
    of either conv_impl (their trees and state_dicts share names)."""
    _, params = tiny_unet
    net = load_flax_params(build_model(8, (1, 2), conv_impl=conv_impl, device="cpu"), params)
    back = state_dict_to_flax(net, net.state_dict())
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))


def _grads_as_flax(net):
    return state_dict_to_flax(net, {k: p.grad for k, p in net.named_parameters()})


def test_unet3d_pallas_forward_and_grads_match_jax(tiny_unet):
    """UNet3D(conv_impl="pallas") with remat "full" on both sides: the output
    and the gradient of a loss w.r.t. every parameter, the JAX side running
    its Pallas conv in interpret mode, the port its plain K2."""
    _, params = tiny_unet
    jmodel = jax_build_model(8, (1, 2), conv_impl="pallas")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 4, 8, 8, 7)).astype(np.float32)
    t = np.array([500], np.int32)
    co = rng.normal(size=x.shape).astype(np.float32)

    def loss(p):
        out = jmodel.apply(p, x, t)
        return (out * co).sum(), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    net = load_flax_params(build_model(8, (1, 2), conv_impl="pallas", device="cpu"), params)
    out = net(_t(x), _t(t).long())
    (out * _t(co)).sum().backward()
    # ~40 float32 layers, sums in another order: 1e-5 of the output's scale
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_out)).max())
    grads = dict(jax.tree_util.tree_flatten_with_path(_grads_as_flax(net))[0])
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    top = max(float(np.abs(np.asarray(r)).max()) for _, r in ref_leaves)
    for path, ref in ref_leaves:
        ref = np.asarray(ref)
        # backward through the same layers: 1e-4 of each leaf's largest
        # entry, and at least 1e-6 of the largest gradient anywhere (a conv
        # bias before a per-channel GroupNorm has gradient 0 in exact
        # arithmetic, so both sides hold rounding noise there)
        atol = max(1e-4 * np.abs(ref).max(), 1e-6 * top)
        np.testing.assert_allclose(grads[path], ref, rtol=0, atol=atol, err_msg=str(path))


def test_remat_on_and_off_give_equal_gradients(tiny_unet):
    _, params = tiny_unet
    rng = np.random.default_rng(12)
    x, t = _t(rng.normal(size=(2, 4, 8, 8, 7)).astype(np.float32)), torch.tensor([1, 900])
    grads = []
    for use_remat in (True, False):
        net = load_flax_params(TU.UNet3D(8, (1, 2), conv_impl="pallas", use_remat=use_remat),
                               params)
        (net(x, t) ** 2).mean().backward()
        grads.append([p.grad for p in net.parameters()])
    for a, b in zip(*grads):
        # the recomputed forward repeats the same arithmetic
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_seeded_init_is_deterministic_and_flax_scaled():
    a = init_params(build_model(8, (1, 2), device="cpu"), seed=3)
    b = init_params(build_model(8, (1, 2), device="cpu"), seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.downs[0][0].block1.conv.weight.detach()  # lecun normal: var 1/fan_in
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.2
