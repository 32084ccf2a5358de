"""Shared U-Net building blocks (torch.nn, channels-last).

Port of `safediffcon_tpu/models/layers.py`. Norms act on the trailing
channel axis, as in the flax modules. The conv blocks take `ndim`, the
number of spatial axes: 2 for the Burgers UNet2D over (B, T, X, C), 1 for
the tokamak UNet1D over (B, L, C).

Compute dtype follows flax's semantics op by op. A block built with
`dtype=torch.bfloat16` casts its input and its float32 parameters to bf16
in every Dense and Conv, as `nn.Dense(dtype=...)` / `nn.Conv(dtype=...)` do;
`GroupNormCL(dtype=...)` takes its statistics in float32 and casts its
output; ChanLayerNorm and RMSNorm carry no dtype and promote with their
float32 `g` (so a bf16 input leaves them in float32). `dtype=None` computes
in the promoted type of input and parameters, float32 in a float32 model.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from safediffcon_torch.parallel import mesh as pmesh


# compute_dtype names of the U-Nets -> the dtype their blocks take (None:
# float32, the promoted type of float32 inputs and parameters)
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to +-2 std, rescaled to
    variance 1/fan_in; drawn by inverse CDF on the CPU generator."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    w.copy_((z * math.sqrt(1.0 / fan_in) / 0.87962566103423978).to(w.dtype))


def _compute_dtype(dtype: Optional[torch.dtype], *tensors) -> torch.dtype:
    """`dtype`, else the promoted type of the tensors (flax promote_dtype)."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Linear(nn.Linear):
    """flax `nn.Dense(dtype=...)` on the trailing axis."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2dCL(nn.Conv2d):
    """flax `nn.Conv(kernel_size=(k, k), padding="SAME", dtype=...)` over
    channels-last (B, H, W, C) tensors (odd k, stride 1)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim_in, dim_out, kernel_size, padding=kernel_size // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        y = self._conv_forward(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                               self.bias.to(dt))
        return y.permute(0, 2, 3, 1)


class Conv1dCL(nn.Conv1d):
    """flax `nn.Conv(kernel_size=(k,), dtype=...)` over channels-last
    (B, L, C) tensors: SAME for odd k and stride 1, or the given stride and
    symmetric padding."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int = 1,
                 padding: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__(dim_in, dim_out, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _compute_dtype(self.compute_dtype, x, self.weight)
        y = self._conv_forward(x.transpose(1, 2).to(dt), self.weight.to(dt), self.bias.to(dt))
        return y.transpose(1, 2)


# the SAME conv of each number of spatial axes
CONV_CL = {1: Conv1dCL, 2: Conv2dCL}


class GroupNormCL(nn.Module):
    """flax `nn.GroupNorm` (epsilon 1e-5) over the trailing channel axis;
    with a dtype, the statistics and the affine map in float32 and the
    output cast to it."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, fs: Optional[pmesh.FrameShard] = None):
        """`fs`: x holds this rank's frames of a video split over a frame
        group; the statistics then span every frame, the mean first and the
        biased variance about it after, each a float32 sum all-reduced over
        the group (the two passes `var_mean` takes on the whole)."""
        b, c = x.shape[0], x.shape[-1]
        g = x.reshape(b, -1, self.groups, c // self.groups).float()
        if fs is None:
            var, mean = torch.var_mean(g, dim=(1, 3), keepdim=True, unbiased=False)
        else:
            count = g.shape[1] * g.shape[3] * fs.size
            mean = pmesh.all_reduce_sum(g.sum(dim=(1, 3), keepdim=True), fs) / count
            var = pmesh.all_reduce_sum((g - mean).square().sum(dim=(1, 3), keepdim=True),
                                       fs) / count
        g = (g - mean) * torch.rsqrt(var + self.eps)
        y = g.reshape(x.shape) * self.weight + self.bias
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class RMSNorm(nn.Module):
    """Channel RMS norm: l2-normalise over channels, scale by g * sqrt(C)
    (reference: 1D/model/unet.py:45-51)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        return x / norm * self.g * math.sqrt(x.shape[-1])


class ChanLayerNorm(nn.Module):
    """Biasless LayerNorm over channels with the biased variance
    (reference: 1D/model/unet.py:53-63)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=-1, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.g


class SinusoidalPosEmb(nn.Module):
    """Timestep embedding (reference: 1D/model/unet.py:81-107, even-dim path)."""

    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.theta = theta

    def forward(self, t):
        half_dim = self.dim // 2
        emb = math.log(self.theta) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
        emb = t.to(torch.float32)[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class TimeMLP(nn.Module):
    """sinusoidal -> Linear -> exact GELU -> Linear (reference: 1D/model/unet.py:310-315)."""

    def __init__(self, dim: int, time_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim)
        self.linear1 = Linear(dim, time_dim, dtype=dtype)
        self.linear2 = Linear(time_dim, time_dim, dtype=dtype)

    def forward(self, t):
        x = self.linear1(self.pos_emb(t))
        return self.linear2(F.gelu(x, approximate="none"))


class ConvBlock(nn.Module):
    """3-wide conv + GroupNorm + (scale, shift) + SiLU (reference:
    1D/model/unet.py:128-147)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype: Optional[torch.dtype] = None, ndim: int = 2):
        super().__init__()
        self.conv = CONV_CL[ndim](dim_in, dim_out, 3, dtype=dtype)
        self.norm = GroupNormCL(groups, dim_out, dtype=dtype)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.conv(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two conv blocks with FiLM time conditioning (Dense of silu(t)) and a
    residual, 1x1 conv when the width changes (reference:
    1D/model/unet.py:149-180)."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: Optional[int], groups: int = 8,
                 dtype: Optional[torch.dtype] = None, ndim: int = 2):
        super().__init__()
        self.mlp = Linear(time_dim, dim_out * 2, dtype=dtype) if time_dim else None
        self.block1 = ConvBlock(dim_in, dim_out, groups, dtype, ndim)
        self.block2 = ConvBlock(dim_out, dim_out, groups, dtype, ndim)
        self.res_conv = (CONV_CL[ndim](dim_in, dim_out, 1, dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            h_t = self.mlp(F.silu(time_emb))
            h_t = h_t.reshape(h_t.shape[0], *((1,) * (x.ndim - 2)), h_t.shape[-1])
            scale_shift = h_t.chunk(2, dim=-1)
        h = self.block2(self.block1(x, scale_shift))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class LinearAttention(nn.Module):
    """Linear attention over all spatial positions (reference:
    1D/model/unet.py:182-222): softmax(q) over the channel axis d,
    softmax(k) over the tokens n, q scaled after its softmax, context
    k v^T; the output Dense is followed by a ChanLayerNorm (RMSNorm for one
    spatial axis)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, ndim: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, dtype=dtype)
        self.norm = ChanLayerNorm(dim) if ndim > 1 else RMSNorm(dim)

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        q, k, v = self.to_qkv(x.reshape(b, -1, c)).chunk(3, dim=-1)

        def heads(z):  # (B, N, H*D) -> (B, H, D, N)
            return z.reshape(b, -1, self.heads, self.dim_head).permute(0, 2, 3, 1)

        q, k, v = heads(q), heads(k), heads(v)
        q = q.softmax(dim=-2)
        k = k.softmax(dim=-1)
        q = q * (self.dim_head ** -0.5)
        context = k @ v.transpose(-1, -2)  # (B, H, D, E)
        out = context.transpose(-1, -2) @ q  # (B, H, E, N)
        out = out.permute(0, 3, 1, 2).reshape(b, -1, self.heads * self.dim_head)
        return self.norm(self.to_out(out)).reshape(x.shape)


class Attention(nn.Module):
    """Full softmax attention over the spatial tokens (reference:
    1D/model/unet.py:224-258)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        b, c = x.shape[0], x.shape[-1]
        q, k, v = self.to_qkv(x.reshape(b, -1, c)).chunk(3, dim=-1)

        def heads(z):  # (B, N, H*D) -> (B, H, N, D)
            return z.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        q = q * (self.dim_head ** -0.5)
        attn = (q @ k.transpose(-1, -2)).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, -1, self.heads * self.dim_head)
        return self.to_out(out).reshape(x.shape)


class PreNormResidual(nn.Module):
    """x + fn(norm(x)): ChanLayerNorm, or RMSNorm when `use_layernorm` is
    False (reference: 1D/model/unet.py:16-22,65-76)."""

    def __init__(self, dim: int, fn: nn.Module, use_layernorm: bool = True):
        super().__init__()
        self.norm = ChanLayerNorm(dim) if use_layernorm else RMSNorm(dim)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw) + x


class Downsample(nn.Module):
    """Space-to-depth by 2 in both spatial axes, then a 1x1 conv (reference:
    1D/model/unet.py:39-43). The 4C channels are stacked in (p1, p2, c)
    order, as the JAX reshape does; `F.pixel_unshuffle` would give (c, p1,
    p2). With one spatial axis, a strided conv: kernel 4, stride 2, padding
    (1, 1) (reference: 1D/model/unet.py:30-31)."""

    def __init__(self, dim_in: int, dim_out: int, dtype: Optional[torch.dtype] = None,
                 ndim: int = 2):
        super().__init__()
        self.ndim = ndim
        if ndim == 1:
            self.conv = Conv1dCL(dim_in, dim_out, 4, stride=2, padding=1, dtype=dtype)
        else:
            self.conv = Conv2dCL(4 * dim_in, dim_out, 1, dtype=dtype)

    def forward(self, x):
        if self.ndim == 1:
            return self.conv(x)
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.conv(x.reshape(b, h // 2, w // 2, 4 * c))


class Upsample(nn.Module):
    """Nearest x2 repeat along each spatial axis, then a SAME 3-wide conv
    (reference: 1D/model/unet.py:24-37)."""

    def __init__(self, dim_in: int, dim_out: int, dtype: Optional[torch.dtype] = None,
                 ndim: int = 2):
        super().__init__()
        self.ndim = ndim
        self.conv = CONV_CL[ndim](dim_in, dim_out, 3, dtype=dtype)

    def forward(self, x):
        for axis in range(1, 1 + self.ndim):
            x = x.repeat_interleave(2, dim=axis)
        return self.conv(x)
