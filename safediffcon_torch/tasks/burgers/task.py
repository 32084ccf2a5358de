"""1D Burgers control task: layout, conditioning, guidance, conformal stats.

Port of `safediffcon_tpu/tasks/burgers/task.py`. Data layout is
channels-last: x has shape (B, PAD_SIZE=16, NX=128, 3) with channels (u, f,
s): state trajectory u (rows 0..10 real), control force f (rows 0..9 real),
safety score s = u^2 (or the per-sample max of u^2 with use_max_safety)
(reference: 1D/data/burgers.py:104-142).

The conditioning / padding semantics reproduce the reference exactly,
including its quirks (reference: 1D/model/diffusion.py:336-366):
  - u0 is written into (t=0, ch u), uT into (t=COND_IDX, ch u)
  - padding zeroes u rows COND_IDX+1.., f rows COND_IDX.., s rows COND_IDX..
    (s row 10 is real data but is zeroed all the same)

The w-only prior model p(w | u0, uT) of two-model composed sampling is
trained through `mask_model_w_input` and `ModelWConditioner`, and composed
with `mask_model_w_output` (`core.sampling.compose_two_model_apply`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

SCALER = 10.0  # reference: 1D/utils/common.py:17
NT = 11
NX = 128
PAD_SIZE = 16
COND_IDX = NT - 1  # 10
U, F, S = 0, 1, 2  # channel indices


@dataclasses.dataclass(frozen=True)
class BurgersTaskConfig:
    """Static guidance/conformal settings (reference: 1D/configs/inference_config.py)."""

    u_bound: float = 0.8
    use_max_safety: bool = True
    w_score: float = 1.0
    alpha: float = 0.98


@dataclasses.dataclass
class BurgersConditioner:
    """Condition tensors for sampling; None fields are skipped.

    u0: (B, NX) initial state (normalized units)
    uT: (B, NX) target final state
    w:  (B, PAD_SIZE, NX) ground-truth control (calibration sampling only)
    """

    u0: Optional[torch.Tensor] = None
    uT: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None

    @staticmethod
    def _pad(x: torch.Tensor) -> torch.Tensor:
        # reference set_pad_condition (1D/model/diffusion.py:360-366); x is a
        # fresh tensor here
        x[:, COND_IDX + 1 :, :, U] = 0.0
        x[:, COND_IDX:, :, F] = 0.0
        x[:, COND_IDX:, :, S] = 0.0
        return x

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        if self.u0 is not None:
            x[:, 0, :, U] = self.u0
        if self.uT is not None:
            x[:, COND_IDX, :, U] = self.uT
        if self.w is not None:
            x[:, :, :, F] = self.w
        return self._pad(x)

    def apply_train(self, x: torch.Tensor, x_start: torch.Tensor) -> torch.Tensor:
        """Training-time conditioning: conditions come from the clean sample
        (reference: 1D/model/diffusion.py:659-665)."""
        x = x.clone()
        x[:, 0, :, U] = x_start[:, 0, :, U]
        x[:, COND_IDX, :, U] = x_start[:, COND_IDX, :, U]
        return self._pad(x)

    def loss_target(self, noise: torch.Tensor) -> torch.Tensor:
        # zero target noise at conditioned cells (1D/model/diffusion.py:709-714)
        noise = noise.clone()
        noise[:, 0, :, U] = 0.0
        noise[:, COND_IDX, :, U] = 0.0
        return noise

    def mask_output(self, model_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        # no loss on padded cells (1D/model/diffusion.py:720-721)
        model_out = model_out.clone()
        model_out[:, COND_IDX + 1 :, :, U] = target[:, COND_IDX + 1 :, :, U]
        model_out[:, COND_IDX:, :, F] = target[:, COND_IDX:, :, F]
        model_out[:, COND_IDX:, :, S] = target[:, COND_IDX:, :, S]
        return model_out


def train_conditioner() -> BurgersConditioner:
    """Conditioner for the training loss (conditions read from x_start)."""
    return BurgersConditioner()


# ---------------------------------------------------------------------------
# w-only prior model p(w | u0, uT): the reference's is_model_w /
# eval_two_models surface (1D/model/diffusion.py:226-244,678-679,718-720)
# ---------------------------------------------------------------------------

def mask_model_w_input(x: torch.Tensor) -> torch.Tensor:
    """Zero the u rows the prior model never sees (u_1..u_{T-1}; u0 and uT
    stay: it models p(w | u0, uT)). Applied to the model's input in
    training and in two-model sampling (reference:
    1D/model/diffusion.py:229-231,678-679)."""
    x = x.clone()
    x[:, 1:COND_IDX, :, U] = 0.0
    return x


def mask_model_w_output(out: torch.Tensor) -> torch.Tensor:
    """The prior model predicts only w: zero its whole u-channel output
    (reference: 1D/model/diffusion.py:232)."""
    out = out.clone()
    out[:, :, :, U] = 0.0
    return out


@dataclasses.dataclass
class ModelWConditioner(BurgersConditioner):
    """Training conditioner of the w-only prior model: BurgersConditioner's
    conditioning and padding, and no loss on the u channel (the reference
    copies the target into the u rows of the output before the MSE,
    1D/model/diffusion.py:718-720). The input masking is
    `mask_model_w_input` around the model, not here."""

    def mask_output(self, model_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        model_out = super().mask_output(model_out, target)
        model_out[:, :, :, U] = target[:, :, :, U]
        return model_out


# ---------------------------------------------------------------------------
# Guidance (safety) loss and distribution-shift weights
# ---------------------------------------------------------------------------

def safety_statistic(x: torch.Tensor, use_max_safety: bool = True) -> torch.Tensor:
    """Per-sample safety statistic of a normalized trajectory tensor: the
    mean over the real rows of the s channel when use_max_safety (the s
    channel then carries the per-sample max), else the amax
    (reference: 1D/utils/guidance.py:67-71)."""
    s = (x * SCALER)[:, :NT, :, S]
    if use_max_safety:
        return s.mean(dim=(-1, -2))
    return s.amax(dim=(-1, -2))


def guidance_values(x: torch.Tensor, Q, cfg: BurgersTaskConfig) -> torch.Tensor:
    """guidance(x, Q) = relu(s_stat + Q - u_bound^2) * w_score, shape (B,)
    (reference: 1D/posttrain/guidance.py:9-37)."""
    s = safety_statistic(x, cfg.use_max_safety)
    return torch.clamp_min(s + Q - cfg.u_bound**2, 0.0) * cfg.w_score


def shift_weights(x: torch.Tensor, Q, cfg: BurgersTaskConfig) -> torch.Tensor:
    """Distribution-shift weight exp(-guidance) per sample
    (reference: 1D/posttrain/guidance.py:39-46)."""
    return torch.exp(-guidance_values(x, Q, cfg))


def guidance_grad_fn(Q, cfg: BurgersTaskConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> d(sum guidance)/dx by autograd, for sampler guidance
    (reference: 1D/utils/guidance.py:79-86)."""

    def grad(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(guidance_values(x, Q, cfg).sum(), x)
        return g

    return grad


def conformal_score(pred: torch.Tensor, state: torch.Tensor,
                    use_max_safety: bool = True) -> torch.Tensor:
    """|safety statistic(sample) - safety statistic(truth)| per sample
    (reference: 1D/posttrain/conformal.py:71-80). Inputs are normalized."""
    return (safety_statistic(pred, use_max_safety)
            - safety_statistic(state, use_max_safety)).abs()


def infft_loss(pred_scaled: torch.Tensor, Q, cfg: BurgersTaskConfig) -> torch.Tensor:
    """Inference-time fine-tuning loss on UNSCALED predictions:
    MSE(relu(amax(s) + Q - u_bound^2), 0) (reference: 1D/inference/inference_ft.py:193-201)."""
    s = pred_scaled[:, :NT, :, S].amax(dim=(-1, -2))
    obj = torch.clamp_min(s + Q - cfg.u_bound**2, 0.0)
    return (obj**2).mean()
