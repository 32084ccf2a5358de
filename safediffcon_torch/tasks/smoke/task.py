"""2D smoke control task: layout, conditioning, guidance, conformal stats.

Port of `safediffcon_tpu/tasks/smoke/task.py`. Layout is
channels-last: x has shape (B, F=32, 64, 64, 7) with channels (density, vx,
vy, cx, cy, smoke_rate, smoke_safe_rate); the two rate channels are scalars
tiled over space (reference: 2d/ddpm/data_2d.py:9-113).

Conditioning: the initial density (frame 0, channel 0) is always imposed;
calibration and backward sampling also condition on the control channels
3:5 over all frames; training takes frame 0's density from the clean sample
(reference: 2d/ddpm/diffusion_2d.py:330-340,396-404,437-441).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# per-channel normalization (reference: 2d/ddpm/data_2d.py:38)
RESCALER = np.array([2, 19, 20, 17, 20, 1, 1], dtype=np.float32)
FRAMES = 32
SIZE = 64
DENS, VX, VY, CX, CY, SMOKE, SAFE = range(7)


def rescaler(like: torch.Tensor) -> torch.Tensor:
    """RESCALER as a tensor on the device of `like`."""
    return torch.as_tensor(RESCALER, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class SmokeTaskConfig:
    """Guidance/conformal settings (reference: 2d/inference_2d.py args)."""

    safe_bound: float = 0.1
    w_safe: float = 0.9
    standard_fixed_ratio: float = 100.0  # guidance grad + train weights scale
    finetune_standard_fixed_ratio: float = 0.0  # composite test weight scale
    alpha: float = 0.04  # NOTE: 2d uses the INVERTED convention (1 - alpha)


@dataclasses.dataclass
class SmokeConditioner:
    """Condition tensors for sampling; None fields are skipped.

    init: (B, 64, 64) initial density (normalized)
    control: (B, F, 64, 64, 2) control fields for channels 3:5 (normalized)
    """

    init: Optional[torch.Tensor] = None
    control: Optional[torch.Tensor] = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        if self.init is not None:
            x[:, 0, :, :, DENS] = self.init
        if self.control is not None:
            x[:, :, :, :, CX : CY + 1] = self.control
        return x

    def apply_train(self, x: torch.Tensor, x_start: torch.Tensor) -> torch.Tensor:
        """Training-time conditioning: frame-0 density from the clean sample
        (reference: 2d/ddpm/diffusion_2d.py:437-441)."""
        x = x.clone()
        x[:, 0, :, :, DENS] = x_start[:, 0, :, :, DENS]
        return x

    def loss_target(self, noise: torch.Tensor) -> torch.Tensor:
        noise = noise.clone()
        noise[:, 0, :, :, DENS] = 0.0
        return noise

    def mask_output(self, model_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return model_out  # no pad masking in the 2d task


def train_conditioner() -> SmokeConditioner:
    return SmokeConditioner()


def guidance_values(x: torch.Tensor, Q, cfg: SmokeTaskConfig) -> torch.Tensor:
    """-(1-w_safe) * mean smoke_rate + w_safe * relu(final safe_rate + Q -
    safe_bound), per sample (reference: 2d/inference_2d.py:173-186).
    x is normalized (B, F, 64, 64, 7)."""
    state = x * rescaler(x)
    success = state[..., SMOKE].mean(dim=(-1, -2, -3))
    safe = torch.clamp_min(
        state[:, -1, :, :, SAFE].mean(dim=(-1, -2)) + Q - cfg.safe_bound, 0.0)
    return -(1.0 - cfg.w_safe) * success + cfg.w_safe * safe


def shift_weights(x: torch.Tensor, Q, cfg: SmokeTaskConfig,
                  mode: str = "train") -> torch.Tensor:
    """exp(-ratio * guidance) (reference: 2d/inference_2d.py:83-92); both
    modes use the current Q, a reference quirk the JAX package keeps."""
    ratio = (
        cfg.standard_fixed_ratio if mode == "train" else cfg.finetune_standard_fixed_ratio
    )
    return torch.exp(-ratio * guidance_values(x, Q, cfg))


def guidance_grad_fn(Q, cfg: SmokeTaskConfig):
    """x -> standard_fixed_ratio * d(sum guidance)/dx, by autograd
    (reference: 2d/inference_2d.py:189-195 + diffusion_2d.py:249-254)."""

    def grad(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(guidance_values(x, Q, cfg).sum(), x)
        return cfg.standard_fixed_ratio * g

    return grad


def conformal_score(pred: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """|spatial mean of final-frame safe_rate(sample) - (truth)| in physical
    units (reference: 2d/inference_2d.py:144). Inputs normalized."""
    r = float(RESCALER[SAFE])
    s_pred = pred[:, -1, :, :, SAFE].mean(dim=(-1, -2)) * r
    s_tgt = state[:, -1, 0, 0, SAFE] * r
    return (s_pred - s_tgt).abs()


def backward_loss(pred_scaled: torch.Tensor, Q, cfg: SmokeTaskConfig) -> torch.Tensor:
    """InfFT loss on UNSCALED samples: -(1-w_safe) * mean success + w_safe *
    MSE(relu(final safe + Q - bound), 0) (reference: 2d/inference_2d.py:267-284)."""
    success = pred_scaled[..., SMOKE].mean(dim=(-1, -2, -3))
    safe = torch.clamp_min(
        pred_scaled[:, -1, :, :, SAFE].mean(dim=(-1, -2)) + Q - cfg.safe_bound, 0.0)
    return -(1.0 - cfg.w_safe) * success.mean() + cfg.w_safe * (safe ** 2).mean()


def tile_rate_channels(pred_scaled: torch.Tensor) -> torch.Tensor:
    """Replace the two rate channels by their spatial means tiled over space
    (reference: 2d/inference_2d.py:231-234)."""
    out = pred_scaled.clone()
    for ch in (SMOKE, SAFE):
        out[..., ch] = pred_scaled[..., ch].mean(dim=(-1, -2), keepdim=True)
    return out
