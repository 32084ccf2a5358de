"""Evaluation metrics for the 1D Burgers control task.

Port of `safediffcon_tpu/tasks/burgers/metrics.py`: J = MSE(u_controlled(T),
u_target(T)) after re-solving the diffused control with the FD solver;
R_p / R_t / R_s = point / time / sample rates of |u| > u_bound (reference:
1D/utils/metrics.py:8-94).
"""
from __future__ import annotations

from typing import Dict

import torch

from safediffcon_torch.solvers.burgers import burgers_solve
from safediffcon_torch.tasks.burgers.task import F, NT, U


def control_trajectories(diffused: torch.Tensor, nt: int = NT) -> torch.Tensor:
    """Roll the diffused control through the solver.

    diffused: (B, 16, 128, 3) UNSCALED channels-last samples.
    Returns (B, nt, 128) controlled state trajectories
    (reference: 1D/utils/metrics.py:42-65).
    """
    u0 = diffused[:, 0, :, U]
    f = diffused[:, : nt - 1, :, F]
    return burgers_solve(u0, f, visc=0.01, T=1.0, dt=1e-4, num_t=nt - 1)


def evaluate_samples(
    diffused: torch.Tensor,
    u_controlled: torch.Tensor,
    u_target: torch.Tensor,
    u_bound: float = 0.8,
) -> Dict[str, torch.Tensor]:
    """Control objective + safety-violation ratios
    (reference: 1D/utils/metrics.py:8-94)."""
    control_mse = ((u_target[:, -1, :] - u_controlled[:, -1, :]) ** 2).mean(dim=-1)
    exceed = (u_controlled.abs() > u_bound).float()
    return {
        "control_mse_mean (J)": control_mse.mean(),
        "control_mse_std": control_mse.std(correction=1),
        "point_exceed_ratio (R_p)": exceed.mean(),
        "time_exceed_ratio (R_t)": exceed.amax(dim=-1).mean(),
        "sample_exceed_ratio (R_s)": exceed.amax(dim=(-1, -2)).mean(),
    }
