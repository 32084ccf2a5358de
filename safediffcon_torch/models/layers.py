"""Shared U-Net building blocks (torch.nn, channels-last).

Port of the blocks of `safediffcon_tpu/models/layers.py` that UNet3D uses.
Norms act on the trailing channel axis, as in the flax modules.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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

    def __init__(self, dim: int, time_dim: int):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim)
        self.linear1 = nn.Linear(dim, time_dim)
        self.linear2 = nn.Linear(time_dim, time_dim)

    def forward(self, t):
        x = self.linear1(self.pos_emb(t))
        return self.linear2(F.gelu(x, approximate="none"))
