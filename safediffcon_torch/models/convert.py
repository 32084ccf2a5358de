"""Weight bridge between a flax UNet3D, UNet2D or UNet1D parameter tree and
the port's `state_dict`, both ways (`flax_to_state_dict`,
`state_dict_to_flax`).

The flax tree names each submodule by class and creation order at the model's
scope (`ResnetBlock3D_4`, `_PreNormResidual3D_7`, `LinearAttention_2`,
`Conv_1`, ...). A module wrapped by a pre-norm residual is created in the
model's compact scope, before its wrapper, so it is named there too and the
wrapper's scope holds only its norm (ChanLayerNorm, or RMSNorm in UNet1D);
`nn.remat` keeps the unwrapped names. `unet3d_scope_map` and
`unet2d_scope_map` (UNet2D and UNet1D, which share their topology) replay
that creation order over the torch module tree. Leaves convert as:

  Dense kernel (in, out)                       -> Linear weight (out, in)
  Conv kernel (k, I, O)                        -> weight (O, I, k)
  Conv kernel (kH, kW, I, O)                   -> weight (O, I, kH, kW)
  Conv / ConvTranspose kernel (kD,kH,kW,I,O)   -> weight (O, I, kD, kH, kW)
  GroupNorm scale, Embed embedding             -> weight
  bias, ChanLayerNorm / RMSNorm g              -> unchanged

The flax tree is nested dicts of numpy arrays (or anything `np.asarray`
takes), with or without the top-level "params" key. Trees of either
`conv_impl` have the same names and layout (flax names `FusedConv3x3x3`
"Conv_0", as it names `nn.Conv`), and so do the port's modules, so one
bridge serves both.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from safediffcon_torch.models.layers import GroupNormCL
from safediffcon_torch.models.unet1d import UNet1D
from safediffcon_torch.models.unet2d import UNet2D
from safediffcon_torch.models.unet3d import UNet3D

Model = Union[UNet1D, UNet2D, UNet3D]

# inner flax path (below the scope) -> torch sub-path, by scope kind
_INNER = {
    "ResnetBlock3D": {
        "Dense_0": "mlp",
        "Block3D_0/Conv_0": "block1.conv",
        "Block3D_0/GroupNorm_0": "block1.norm",
        "Block3D_1/Conv_0": "block2.conv",
        "Block3D_1/GroupNorm_0": "block2.norm",
        "Conv_0": "res_conv",
    },
    "TemporalAttention": {"Dense_0": "to_qkv", "Dense_1": "to_out"},
    "SpatialLinearAttention3D": {"Dense_0": "to_qkv", "Dense_1": "to_out"},
    "_MidSpatial": {"Dense_0": "to_qkv", "Dense_1": "to_out"},
    "_PreNormResidual3D": {"ChanLayerNorm_0": ""},
    "TimeMLP": {"Dense_0": "linear1", "Dense_1": "linear2"},
    "ResnetBlock": {
        "Dense_0": "mlp",
        "ConvBlock_0/Conv_0": "block1.conv",
        "ConvBlock_0/GroupNorm_0": "block1.norm",
        "ConvBlock_1/Conv_0": "block2.conv",
        "ConvBlock_1/GroupNorm_0": "block2.norm",
        "Conv_0": "res_conv",
    },
    "LinearAttention": {"Dense_0": "to_qkv", "Dense_1": "to_out", "ChanLayerNorm_0": "norm"},
    "LinearAttention1D": {"Dense_0": "to_qkv", "Dense_1": "to_out", "RMSNorm_0": "norm"},
    "Attention": {"Dense_0": "to_qkv", "Dense_1": "to_out"},
    "PreNormResidual": {"ChanLayerNorm_0": ""},
    "PreNormResidual1D": {"RMSNorm_0": ""},
    "Downsample": {"Conv_0": "conv"},
    "Upsample": {"Conv_0": "conv"},
    "leaf": {"": ""},
}


def unet3d_scope_map(model: UNet3D) -> Dict[str, tuple]:
    """flax scope name -> (torch module prefix, scope kind)."""
    count: Counter = Counter()
    out = {
        "time_rel_pos_bias": ("time_rel_pos_bias", "leaf"),
        "TimeMLP_0": ("time_mlp", "TimeMLP"),
        "init_conv": ("init_conv", "leaf"),
        "final_conv": ("final_conv", "leaf"),
    }

    def take(kind, prefix, map_kind=None):
        out[f"{kind}_{count[kind]}"] = (prefix, map_kind or kind)
        count[kind] += 1

    def pre_norm(kind, prefix):
        # the wrapped module is created before its _PreNormResidual3D
        take(kind, prefix + ".fn")
        take("_PreNormResidual3D", prefix + ".norm")

    pre_norm("TemporalAttention", "init_temporal_attn")
    for i, level in enumerate(model.downs):
        take("ResnetBlock3D", f"downs.{i}.0")
        take("ResnetBlock3D", f"downs.{i}.1")
        pre_norm("SpatialLinearAttention3D", f"downs.{i}.2")
        pre_norm("TemporalAttention", f"downs.{i}.3")
        if not isinstance(level[4], nn.Identity):
            take("Conv", f"downs.{i}.4", "leaf")
    take("ResnetBlock3D", "mid_block1")
    pre_norm("_MidSpatial", "mid_spatial_attn")
    pre_norm("TemporalAttention", "mid_temporal_attn")
    take("ResnetBlock3D", "mid_block2")
    for i, level in enumerate(model.ups):
        take("ResnetBlock3D", f"ups.{i}.0")
        take("ResnetBlock3D", f"ups.{i}.1")
        pre_norm("SpatialLinearAttention3D", f"ups.{i}.2")
        pre_norm("TemporalAttention", f"ups.{i}.3")
        if not isinstance(level[4], nn.Identity):
            take("ConvTranspose", f"ups.{i}.4", "leaf")
    take("ResnetBlock3D", "final_block")
    return out


def unet2d_scope_map(model: UNet2D) -> Dict[str, tuple]:
    """flax scope name -> (torch module prefix, scope kind), for UNet2D and
    UNet1D (whose norms are RMSNorms)."""
    count: Counter = Counter()
    suffix = "1D" if model.ndim == 1 else ""
    out = {
        "TimeMLP_0": ("time_mlp", "TimeMLP"),
        "init_conv": ("init_conv", "leaf"),
        "final_conv": ("final_conv", "leaf"),
    }

    def take(kind, prefix, map_kind=None):
        out[f"{kind}_{count[kind]}"] = (prefix, map_kind or kind)
        count[kind] += 1

    def pre_norm(kind, prefix, map_kind=None):
        # the wrapped module is created before its PreNormResidual
        take(kind, prefix + ".fn", map_kind)
        take("PreNormResidual", prefix + ".norm", "PreNormResidual" + suffix)

    def level(name, i, resample_kind):
        take("ResnetBlock", f"{name}.{i}.0")
        take("ResnetBlock", f"{name}.{i}.1")
        pre_norm("LinearAttention", f"{name}.{i}.2", "LinearAttention" + suffix)
        if resample_kind == "Conv":
            take("Conv", f"{name}.{i}.3", "leaf")
        else:
            take(resample_kind, f"{name}.{i}.3")

    n_down, n_up = len(model.downs), len(model.ups)
    for i in range(n_down):
        level("downs", i, "Downsample" if i < n_down - 1 else "Conv")
    take("ResnetBlock", "mid_block1")
    pre_norm("Attention", "mid_attn")
    take("ResnetBlock", "mid_block2")
    for i in range(n_up):
        level("ups", i, "Upsample" if i < n_up - 1 else "Conv")
    take("ResnetBlock", "final_block")
    return out


def scope_map(model: Model) -> Dict[str, tuple]:
    if isinstance(model, UNet2D):
        return unet2d_scope_map(model)
    if isinstance(model, UNet3D):
        return unet3d_scope_map(model)
    raise TypeError(f"no weight bridge for {type(model).__name__}")


def _leaf(name: str, value: np.ndarray):
    """flax leaf -> (torch parameter name, array in torch layout)."""
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name in ("bias", "g"):
        return name, value
    raise ValueError(f"unexpected flax leaf {name!r}")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(model: Model, params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax param tree into a state_dict for `model` (UNet3D,
    UNet2D or UNet1D)."""
    if "params" in params:
        params = params["params"]
    scopes = scope_map(model)
    sd = {}
    for path, value in _flatten(params):
        scope, inner, leaf = path[0], "/".join(path[1:-1]), path[-1]
        if scope not in scopes:
            raise KeyError(f"flax scope {scope!r} has no counterpart in the port's "
                           f"{type(model).__name__}")
        prefix, kind = scopes[scope]
        sub = _INNER[kind][inner]
        name, arr = _leaf(leaf, np.asarray(value, dtype=np.float32))
        key = ".".join(p for p in (prefix, sub, name) if p)
        sd[key] = torch.tensor(arr)
    return sd


def load_flax_params(model: Model, params: Mapping) -> Model:
    """Load a flax param tree into `model` in place (strict: every tensor of
    the model must be covered, with its shape) and return the model."""
    model.load_state_dict(flax_to_state_dict(model, params), strict=True)
    return model


def save_flax_npz(path: str, params: Mapping) -> None:
    """Write a flax param tree as one npz, a key per leaf ("params/a/b/kernel")."""
    np.savez(path, **{"/".join(p): np.asarray(v) for p, v in _flatten(params)})


def load_flax_npz(path: str) -> Dict:
    """The nested flax param tree that `save_flax_npz` wrote."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            *scopes, leaf = key.split("/")
            node = tree
            for part in scopes:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


def state_dict_to_flax(model: Model, state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of `flax_to_state_dict`: {"params": nested dicts of
    float32 numpy arrays} for a state_dict of `model` (the port's weights
    handed back to the JAX package)."""
    by_module = {}
    for scope, (prefix, kind) in scope_map(model).items():
        for inner, sub in _INNER[kind].items():
            path = (scope, *inner.split("/")) if inner else (scope,)
            by_module[".".join(p for p in (prefix, sub) if p)] = path
    tree: Dict = {}
    for key, value in state_dict.items():
        mod_name, _, name = key.rpartition(".")
        if mod_name not in by_module:
            raise KeyError(f"{key!r} has no counterpart in the flax {type(model).__name__}")
        module = model.get_submodule(mod_name)
        arr = value.detach().cpu().float().numpy()
        if name == "weight":
            if isinstance(module, nn.Embedding):
                name = "embedding"
            elif isinstance(module, GroupNormCL):
                name = "scale"
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 3:
                name, arr = "kernel", arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 5:
                name, arr = "kernel", arr.transpose(2, 3, 4, 1, 0)
            else:
                raise ValueError(f"unexpected weight rank {arr.ndim} for {key!r}")
        elif name not in ("bias", "g"):
            raise ValueError(f"unexpected parameter {key!r}")
        node = tree
        for part in by_module[mod_name]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": tree}
