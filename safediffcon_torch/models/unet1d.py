"""1D U-Net denoiser for the tokamak task (channels as features).

Port of `safediffcon_tpu/models/unet1d.py` (reference topology:
1D/model/unet.py:428-563, tokamak/model/unet.py): UNet2D's network over one
spatial axis, the 128-step trajectory, with the 12 physical channels as
features; strided k4 s2 convs downsample, x2 repeats + k3 convs upsample,
and the pre-norm residuals and the linear attention normalise with RMSNorm.
Activations are channels-last (B, L, C); each conv views its input as NCL.
float32 or bf16 compute, as UNet2D.
"""
from __future__ import annotations

from typing import Optional, Sequence

from safediffcon_torch.models.unet2d import UNet2D


class UNet1D(UNet2D):
    """UNet1D forward on (B, L, channels) input and (B,) timesteps; L a
    multiple of 2^(len(dim_mults) - 1)."""

    ndim = 1

    def __init__(
        self,
        dim: int = 128,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        channels: int = 12,
        resnet_block_groups: int = 1,
        attn_heads: int = 4,
        attn_dim_head: int = 32,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__(dim, dim_mults, channels, resnet_block_groups, attn_heads,
                         attn_dim_head, compute_dtype)
