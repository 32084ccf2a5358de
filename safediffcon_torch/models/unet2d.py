"""Space-time 2D U-Net denoiser for the 1D Burgers task.

Port of `safediffcon_tpu/models/unet2d.py` (reference topology:
1D/model/unet.py:263-426): a 7x7 init conv, levels of [ResnetBlock x2 +
linear-attention residual] joined by pixel-unshuffle downsamples, full
attention at the bottleneck, the symmetric up path with skip
concatenations, and a final residual block over [x, init conv output].
Activations stay channels-last (B, T, X, C); each conv views its input as
NCHW with `permute`.

`compute_dtype="bfloat16"` runs every Dense and Conv in bf16 from float32
parameters, with flax's dtype semantics (`models/layers.py`); the output is
float32 either way.

The tokamak UNet1D (`models/unet1d.py`) is this network over one spatial
axis; the class builds either from its `ndim`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from safediffcon_torch.models.layers import (
    COMPUTE_DTYPES,
    CONV_CL,
    Attention,
    Downsample,
    LinearAttention,
    PreNormResidual,
    ResnetBlock,
    TimeMLP,
    Upsample,
)


class UNet2D(nn.Module):
    """UNet2D forward on (B, T, X, channels) input and (B,) timesteps."""

    ndim = 2  # spatial axes

    def __init__(
        self,
        dim: int = 128,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 3,
        resnet_block_groups: int = 1,
        attn_heads: int = 4,
        attn_dim_head: int = 32,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        dt = COMPUTE_DTYPES[compute_dtype]
        self.compute_dtype = dt or torch.float32
        groups = resnet_block_groups
        time_dim = dim * 4
        nd = self.ndim
        conv = CONV_CL[nd]
        # PreNormResidual: ChanLayerNorm over 2 spatial axes, RMSNorm over 1
        layernorm = nd > 1

        def resnet(d_in, d_out):
            return ResnetBlock(d_in, d_out, time_dim, groups, dt, nd)

        def linear_attn(d):
            return PreNormResidual(d, LinearAttention(d, attn_heads, attn_dim_head, nd, dtype=dt),
                                   use_layernorm=layernorm)

        self.time_mlp = TimeMLP(dim, time_dim, dtype=dt)
        self.init_conv = conv(channels, dim, 7, dtype=dt)

        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        num_res = len(in_out)

        # each level: [resnet, resnet, linear attention, resample]
        self.downs = nn.ModuleList()
        for i, (dim_in, dim_out) in enumerate(in_out):
            is_last = i >= num_res - 1
            self.downs.append(nn.ModuleList([
                resnet(dim_in, dim_in),
                resnet(dim_in, dim_in),
                linear_attn(dim_in),
                conv(dim_in, dim_out, 3, dtype=dt) if is_last
                else Downsample(dim_in, dim_out, dtype=dt, ndim=nd),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = resnet(mid_dim, mid_dim)
        self.mid_attn = PreNormResidual(
            mid_dim, Attention(mid_dim, attn_heads, attn_dim_head, dtype=dt),
            use_layernorm=layernorm)
        self.mid_block2 = resnet(mid_dim, mid_dim)

        self.ups = nn.ModuleList()
        for i, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = i == num_res - 1
            self.ups.append(nn.ModuleList([
                resnet(dim_out + dim_in, dim_out),
                resnet(dim_out + dim_in, dim_out),
                linear_attn(dim_out),
                conv(dim_out, dim_in, 3, dtype=dt) if is_last
                else Upsample(dim_out, dim_in, dtype=dt, ndim=nd),
            ]))

        self.final_block = resnet(dim * 2, dim)
        self.final_conv = conv(dim, channels, 1, dtype=dt)

    def forward(self, x, t):
        x = x.to(self.compute_dtype)
        time_emb = self.time_mlp(t).to(self.compute_dtype)
        x = self.init_conv(x)
        r = x

        h = []
        for res1, res2, attn, downsample in self.downs:
            x = res1(x, time_emb)
            h.append(x)
            x = attn(res2(x, time_emb))
            h.append(x)
            x = downsample(x)

        x = self.mid_block1(x, time_emb)
        x = self.mid_attn(x)
        x = self.mid_block2(x, time_emb)

        for res1, res2, attn, upsample in self.ups:
            x = res1(torch.cat([x, h.pop()], dim=-1), time_emb)
            x = res2(torch.cat([x, h.pop()], dim=-1), time_emb)
            x = upsample(attn(x))

        x = self.final_block(torch.cat([x, r], dim=-1), time_emb)
        return self.final_conv(x).to(torch.float32)
