"""Parity of the port's UNet2D and its blocks (`models/layers.py`) with the
flax modules, with the flax weights carried over by the weight bridge
(`models/convert.py`), in float32 and in bfloat16 compute, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch
import torch.nn.functional as F

from safediffcon_tpu.models import layers as JL
from safediffcon_tpu.models.unet2d import UNet2D as JUNet2D
from safediffcon_torch.models import layers as TL
from safediffcon_torch.models.convert import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)
from safediffcon_torch.models.unet2d import UNet2D
from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params

torch.set_num_threads(1)

DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16 keeps 8 mantissa bits; rounding at every op of a block, in another
# order than XLA's, reaches ~1e-2 of the output's scale (UNet2D: 1.4e-2)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _perturbed(params, seed):
    """flax init gives zero biases and unit scales; perturb every leaf so the
    bridge's handling of each one is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(out, ref, dtype):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


def _load(module, tree, names):
    """Load a flax block's params into the port block (strict), each leaf in
    torch layout, by {flax path: torch module name}."""
    out = {}
    for fpath, tname in names.items():
        node = tree
        for part in fpath.split("/"):
            node = node[part]
        for leaf, value in node.items():
            value = np.asarray(value)
            if leaf == "kernel":
                value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            out[f"{tname}.{leaf}" if tname else leaf] = torch.from_numpy(value.copy())
    module.load_state_dict(out, strict=True)
    return module


def test_rms_norm():
    x = _x((2, 5, 8))
    g = _x((8,), 1)
    ref = JL.RMSNorm().apply({"params": {"g": g}}, x)
    mod = TL.RMSNorm(8)
    mod.g.data = torch.from_numpy(g)
    _close(mod(torch.from_numpy(x)), ref, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_block_with_scale_shift(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 6, 8, 4))
    scale, shift = _x((2, 1, 1, 6), 1), _x((2, 1, 1, 6), 2)
    m = JL.ConvBlock(6, groups=2, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 3)
    ref = m.apply(p, x.astype(jdt or np.float32), (scale.astype(jdt or np.float32),
                                                   shift.astype(jdt or np.float32)))
    mod = _load(TL.ConvBlock(4, 6, groups=2, dtype=tdt),
                p["params"], {"Conv_0": "conv", "GroupNorm_0": "norm"})
    sc = tuple(torch.from_numpy(a).to(tdt or torch.float32) for a in (scale, shift))
    out = mod(torch.from_numpy(x).to(tdt or torch.float32), sc)
    assert out.dtype == (tdt or torch.float32)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dim_in", [4, 6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_block_film_and_residual(dtype, dim_in):
    jdt, tdt = DTYPES[dtype]
    x, temb = _x((2, 6, 8, dim_in)), _x((2, 16), 1)
    m = JL.ResnetBlock(6, groups=1, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x, temb), 4)
    ref = m.apply(p, x, temb)
    names = {"Dense_0": "mlp", "ConvBlock_0/Conv_0": "block1.conv",
             "ConvBlock_0/GroupNorm_0": "block1.norm", "ConvBlock_1/Conv_0": "block2.conv",
             "ConvBlock_1/GroupNorm_0": "block2.norm"}
    if dim_in != 6:
        names["Conv_0"] = "res_conv"
    mod = _load(TL.ResnetBlock(dim_in, 6, 16, groups=1, dtype=tdt), p["params"], names)
    _close(mod(torch.from_numpy(x), torch.from_numpy(temb)), ref, dtype)


@pytest.mark.parametrize("spatial", [(6, 8), (10,)], ids=["2d", "1d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_attention(dtype, spatial):
    """softmax(q) over channels, softmax(k) over tokens, q scaled after its
    softmax; ChanLayerNorm after the output Dense (RMSNorm for 1-d)."""
    jdt, tdt = DTYPES[dtype]
    x = _x((2, *spatial, 8))
    m = JL.LinearAttention(heads=2, dim_head=4, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 5)
    ref = m.apply(p, x)
    norm = "ChanLayerNorm_0" if len(spatial) > 1 else "RMSNorm_0"
    mod = _load(TL.LinearAttention(8, 2, 4, ndim=len(spatial), dtype=tdt),
                p["params"], {"Dense_0": "to_qkv", "Dense_1": "to_out", norm: "norm"})
    _close(mod(torch.from_numpy(x)), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 2, 16, 8))
    m = JL.Attention(heads=2, dim_head=4, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 6)
    ref = m.apply(p, x)
    mod = _load(TL.Attention(8, 2, 4, dtype=tdt),
                p["params"], {"Dense_0": "to_qkv", "Dense_1": "to_out"})
    _close(mod(torch.from_numpy(x)), ref, dtype)


@pytest.mark.parametrize("use_layernorm", [True, False])
def test_pre_norm_residual(use_layernorm):
    x = _x((2, 6, 8, 8))
    m = JL.PreNormResidual(fnn.Dense(8), use_layernorm=use_layernorm)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 7)
    ref = m.apply(p, x)
    norm = "ChanLayerNorm_0" if use_layernorm else "RMSNorm_0"
    mod = _load(TL.PreNormResidual(8, TL.Linear(8, 8), use_layernorm=use_layernorm),
                p["params"], {norm: "norm", "fn": "fn"})
    _close(mod(torch.from_numpy(x)), ref, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_downsample_channel_order(dtype):
    """Space-to-depth stacks the 4C channels as (p1, p2, c), as the JAX
    reshape does; `F.pixel_unshuffle`'s (c, p1, p2) gives another result."""
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 8, 12, 3))
    m = JL.Downsample(5, ndim=2, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 8)
    ref = np.asarray(m.apply(p, x), np.float32)
    mod = _load(TL.Downsample(3, 5, dtype=tdt), p["params"], {"Conv_0": "conv"})
    out = mod(torch.from_numpy(x))
    assert out.shape == (2, 4, 6, 5)
    _close(out, ref, dtype)
    # the same 1x1 conv after pixel_unshuffle's channel order misses
    unshuffled = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    wrong = mod.conv(unshuffled.permute(0, 2, 3, 1)).detach().float().numpy()
    assert np.abs(wrong - ref).max() > 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 3, 5, 4))
    m = JL.Upsample(6, ndim=2, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), x), 9)
    ref = m.apply(p, x)
    mod = _load(TL.Upsample(4, 6, dtype=tdt), p["params"], {"Conv_0": "conv"})
    out = mod(torch.from_numpy(x))
    assert out.shape == (2, 6, 10, 6)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_mlp(dtype):
    jdt, tdt = DTYPES[dtype]
    t = np.array([0, 7, 999], np.int32)
    m = JL.TimeMLP(16, 64, dtype=jdt)
    p = _perturbed(m.init(jax.random.PRNGKey(0), t), 10)
    ref = m.apply(p, t)
    mod = _load(TL.TimeMLP(16, 64, dtype=tdt),
                p["params"], {"Dense_0": "linear1", "Dense_1": "linear2"})
    _close(mod(torch.from_numpy(t).long()), ref, dtype)


# ---------------------------------------------------------------------------
# UNet2D
# ---------------------------------------------------------------------------

SHAPE = (2, 16, 32, 3)  # batch, time rows, cells, channels


@pytest.fixture(scope="module")
def tiny_params():
    """dim 16, mults (1, 2): seeded by the port's `init_params` and carried
    over by the bridge, every leaf perturbed."""
    net = init_params(build_model(16, (1, 2), device="cpu"), seed=0)
    return _perturbed(state_dict_to_flax(net, net.state_dict()), 11)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet2d_forward_matches_flax(tiny_params, dtype):
    jdt, _ = DTYPES[dtype]
    x, t = _x(SHAPE, 12), np.array([3, 700], np.int32)
    jm = JUNet2D(dim=16, dim_mults=(1, 2), compute_dtype=jdt or jnp.float32)
    ref = np.asarray(jax.jit(jm.apply)(tiny_params, x, t))
    net = load_flax_params(build_model(16, (1, 2), compute_dtype=dtype, device="cpu"),
                           tiny_params)
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t).long())
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    # float32: ~40 layers with reductions in another order (measured 7e-7)
    _close(out, ref, dtype)


def test_unet2d_gradients_match_flax(tiny_params):
    """Every parameter's gradient of a scalar loss of the float32 output."""
    x, t = _x(SHAPE, 13), np.array([5, 400], np.int32)
    r = _x(SHAPE, 14)
    jm = JUNet2D(dim=16, dim_mults=(1, 2))
    ref = jax.jit(jax.grad(lambda p: (jm.apply(p, x, t) * r).sum()))(tiny_params)
    net = load_flax_params(build_model(16, (1, 2), device="cpu"), tiny_params)
    (net(torch.from_numpy(x), torch.from_numpy(t).long()) * torch.from_numpy(r)).sum().backward()
    grads = state_dict_to_flax(net, {k: p.grad for k, p in net.named_parameters()})
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(ref)[0]:
        g = np.asarray(g)
        # float32 backward through the same layers: 1e-4 of each leaf's max
        np.testing.assert_allclose(got[path], g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                   err_msg=str(path))


def test_unet2d_bridge_round_trip_and_names():
    """flax tree -> state_dict -> flax tree is the identity, bit for bit; the
    names are flax's own (a flax init's tree has the same paths and shapes)."""
    net = init_params(build_model(16, (1, 2), device="cpu"), seed=1)
    tree = state_dict_to_flax(net, net.state_dict())
    sd = flax_to_state_dict(net, tree)
    assert sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = state_dict_to_flax(net, sd)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0], strict=True):
        assert pa == pb and np.array_equal(a, b)
    shapes = jax.eval_shape(JUNet2D(dim=16, dim_mults=(1, 2)).init, jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE), jnp.zeros((2,), jnp.int32))
    assert (jax.tree_util.tree_map(lambda a: a.shape, shapes)
            == jax.tree_util.tree_map(np.shape, tree))


def test_unet2d_bridge_is_strict(tiny_params):
    with pytest.raises(RuntimeError):  # shapes differ at another width
        load_flax_params(build_model(8, (1, 2), device="cpu"), tiny_params)
    with pytest.raises(ValueError):
        UNet2D(dim=8, dim_mults=(1, 2), compute_dtype="float16")


def test_reference_width_parameter_count():
    """The reference "turbo" UNet2D: dim 128, mults (1, 2, 4, 8), 3 channels."""
    with torch.device("meta"):
        net = build_model(device="meta")
    assert sum(p.numel() for p in net.parameters()) == 140_710_147
