"""Tokamak KSTAR control task: layout, conditioning, guidance, conformal stats.

Port of `safediffcon_tpu/tasks/tokamak/task.py`. Data layout is
channels-last: x has shape (B, PAD_SIZE=128, 12) with channels 0-2 the
states (βp, q95, li) over NT=122 real rows and channels 3-11 the 9 actuator
commands over 121 real rows, zero-padded to 128 and normalized by the
per-channel SCALER (reference: tokamak/data/tokamak_dataset.py:34-47).

Conditioning semantics reproduce the reference exactly
(reference: tokamak/model/diffusion.py:295-308,404-417):
  - u0 writes all three states at t=0,
  - uT writes the FULL (βp, li) target trajectories (channels 0 and 2,
    rows :NT),
  - padding zeroes state rows NT.. and action rows NT-1..,
  - calibration conditions on the ground-truth actions (all 9 channels,
    every row; the pad region is zero in the data anyway).

Safety: q95 must stay ABOVE the threshold, a lower bound, opposite in sign
to the Burgers task (reference: tokamak/utils/guidance.py:50-55).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

# per-channel normalization (reference: tokamak/utils/common.py:16)
SCALER = np.array([2, 7, 2, 1, 2, 2, 2, 2, 1, 1, 2, 3], dtype=np.float32)
NT = 122
PAD_SIZE = 128
N_STATES = 3
N_ACTIONS = 9
BP, Q95, LI = 0, 1, 2  # state channel indices


@functools.lru_cache(maxsize=None)
def _scaler(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(SCALER, device=device)


def scaler(x: torch.Tensor) -> torch.Tensor:
    """SCALER as a float32 tensor on x's device, copied there once (a copy
    from host memory in every guided step would make the host wait for the
    card)."""
    return _scaler(x.device)


@dataclasses.dataclass(frozen=True)
class TokamakTaskConfig:
    """Guidance/conformal settings (reference: tokamak/configs/inference_config.py)."""

    safety_threshold: float = 4.98
    w_obj: float = 0.0
    w_safe: float = 1.0
    guidance_scaler: float = 1.0
    alpha: float = 0.9


@dataclasses.dataclass
class TokamakConditioner:
    """Condition tensors for sampling; None fields are skipped.

    u0: (B, 3) initial state (normalized units)
    uT: (B, NT, 2) full (βp, li) target trajectories (normalized)
    w:  (B, PAD_SIZE, 9) ground-truth actions (calibration sampling only)
    """

    u0: Optional[torch.Tensor] = None
    uT: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None

    @staticmethod
    def _pad(x: torch.Tensor) -> torch.Tensor:
        # reference: tokamak/model/diffusion.py:330-332 (zero pad regions);
        # x is a fresh tensor here
        x[:, NT:, :N_STATES] = 0.0
        x[:, NT - 1 :, N_STATES:] = 0.0
        return x

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        if self.u0 is not None:
            x[:, 0, :N_STATES] = self.u0
        if self.uT is not None:
            x[:, :NT, BP] = self.uT[:, :, 0]
            x[:, :NT, LI] = self.uT[:, :, 1]
        x = self._pad(x)
        if self.w is not None:
            x[:, :, N_STATES:] = self.w
        return x

    def apply_train(self, x: torch.Tensor, x_start: torch.Tensor) -> torch.Tensor:
        """Training-time conditioning from the clean sample; padded cells
        are restored from x_start (reference: tokamak/model/diffusion.py:592-602)."""
        x = x.clone()
        x[:, 0, :N_STATES] = x_start[:, 0, :N_STATES]
        x[:, :NT, BP] = x_start[:, :NT, BP]
        x[:, :NT, LI] = x_start[:, :NT, LI]
        x[:, NT:, :N_STATES] = x_start[:, NT:, :N_STATES]
        x[:, NT - 1 :, N_STATES:] = x_start[:, NT - 1 :, N_STATES:]
        return x

    def loss_target(self, noise: torch.Tensor) -> torch.Tensor:
        # zero target noise at conditioned cells
        # (reference: tokamak/model/diffusion.py:620-623)
        noise = noise.clone()
        noise[:, 0, :N_STATES] = 0.0
        noise[:, :NT, BP] = 0.0
        noise[:, :NT, LI] = 0.0
        return noise

    def mask_output(self, model_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        # no loss on padded cells (reference: tokamak/model/diffusion.py:626-630)
        model_out = model_out.clone()
        model_out[:, NT:, :N_STATES] = target[:, NT:, :N_STATES]
        model_out[:, NT - 1 :, N_STATES:] = target[:, NT - 1 :, N_STATES:]
        return model_out


def train_conditioner() -> TokamakConditioner:
    return TokamakConditioner()


def sampling_conditioner(state: torch.Tensor, actions: bool = False) -> TokamakConditioner:
    """The condition of a normalized (B, PAD_SIZE, 12) batch: its initial
    state and (βp, li) trajectories, and with `actions` its actions
    (calibration)."""
    return TokamakConditioner(
        u0=state[:, 0, :N_STATES],
        uT=torch.stack([state[:, :NT, BP], state[:, :NT, LI]], dim=-1),
        w=state[:, :, N_STATES:] if actions else None,
    )


# ---------------------------------------------------------------------------
# Guidance / reweighting / conformal statistics
# ---------------------------------------------------------------------------

def safety_score(state_scaled: torch.Tensor) -> torch.Tensor:
    """min_t q95 per sample over (B, NT, 3) physical-unit states
    (reference: tokamak/utils/metrics.py:144-151). Its gradient is shared
    among tied minima, as JAX's is."""
    return state_scaled[:, :, Q95].amin(dim=-1)


def _objective_and_safety(state: torch.Tensor, state_target: torch.Tensor, Q,
                          cfg: TokamakTaskConfig) -> torch.Tensor:
    obj = ((state[:, :, BP] - state_target[:, :, BP]) ** 2).mean(-1) + (
        (state[:, :, LI] - state_target[:, :, LI]) ** 2
    ).mean(-1)
    safe = torch.clamp_min(cfg.safety_threshold - safety_score(state) + Q, 0.0)
    return cfg.w_obj * obj + cfg.w_safe * safe


def guidance_loss(x: torch.Tensor, state_target: torch.Tensor, Q,
                  cfg: TokamakTaskConfig) -> torch.Tensor:
    """w_obj * (MSE(βp, target) + MSE(li, target)) + w_safe * relu(threshold
    - min q95 + Q), per sample (reference: tokamak/utils/guidance.py:32-56).

    x is normalized (B, PAD, 12); state_target is physical (B, NT, 3)."""
    state = (x * scaler(x))[:, :NT, :N_STATES]
    return _objective_and_safety(state, state_target, Q, cfg)


def shift_weights(x: torch.Tensor, state_target: torch.Tensor, Q,
                  cfg: TokamakTaskConfig) -> torch.Tensor:
    """exp(-loss * guidance_scaler) (reference: tokamak/utils/guidance.py:98-128)."""
    return torch.exp(-guidance_loss(x, state_target, Q, cfg) * cfg.guidance_scaler)


def guidance_grad_fn(state_target: torch.Tensor, Q,
                     cfg: TokamakTaskConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> d(sum loss * scaler)/dx by autograd, for sampler guidance
    (reference: tokamak/utils/guidance.py:66-73)."""

    def grad(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            total = (guidance_loss(x, state_target, Q, cfg) * cfg.guidance_scaler).sum()
            (g,) = torch.autograd.grad(total, x)
        return g

    return grad


def conformal_score(pred: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """|min q95(sample) - min q95(truth)| on physical units
    (reference: tokamak/inference/conformal.py:103-108). Inputs normalized."""
    s_pred = safety_score((pred * scaler(pred))[:, :NT, :N_STATES])
    s_tgt = safety_score((state * scaler(state))[:, :NT, :N_STATES])
    return (s_pred - s_tgt).abs()


def backward_loss(pred_scaled_state: torch.Tensor, state_target: torch.Tensor, Q,
                  cfg: TokamakTaskConfig) -> torch.Tensor:
    """Backward-finetune loss on sampled trajectories (physical units):
    mean over batch of w_obj*objective + w_safe*relu(threshold - min q95 + Q)
    (reference: tokamak/inference/pipeline.py:238-268)."""
    state = pred_scaled_state[:, :NT, :N_STATES]
    return _objective_and_safety(state, state_target, Q, cfg).mean()
