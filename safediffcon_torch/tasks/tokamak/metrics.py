"""Tokamak evaluation: solver rollout of diffused actions + metrics.

Port of `safediffcon_tpu/tasks/tokamak/metrics.py` (reference:
tokamak/utils/metrics.py:11-151): the diffused actions go through the
batched KSTAR surrogate, and the metrics compare the controlled states with
the targets and the safety threshold. Standard deviations are the sample
ones (ddof 1), as in JAX.
"""
from __future__ import annotations

from typing import Dict

import torch

from safediffcon_torch.solvers.kstar import simulate_batch
from safediffcon_torch.tasks.tokamak.task import BP, LI, N_STATES, NT, Q95


def control_trajectories(params, diffused_scaled: torch.Tensor) -> torch.Tensor:
    """Roll the diffused actions through the surrogate.

    diffused_scaled: (B, PAD, 12) physical units. Returns (B, NT, 3)
    controlled states (βp, q95, li) (reference: tokamak/utils/metrics.py:60-85)."""
    actions = diffused_scaled[:, : NT - 1, N_STATES:]
    outputs = simulate_batch(params, actions)  # (B, 122, 8)
    # no index list: it would be copied from the host inside a captured
    # evaluation (`pipeline.TokamakPipeline.evaluate`)
    return torch.stack([outputs[:, :, 1], outputs[:, :, 4], outputs[:, :, 6]], dim=-1)


def evaluate_samples(
    diffused_scaled: torch.Tensor,
    state_controlled: torch.Tensor,
    state_target: torch.Tensor,
    safety_threshold: float,
) -> Dict[str, torch.Tensor]:
    """The reference metric set (reference: tokamak/utils/metrics.py:11-142)."""
    m: Dict[str, torch.Tensor] = {}
    diff_states = diffused_scaled[:, :NT, :N_STATES]

    dmse = ((state_controlled - diff_states) ** 2).mean(dim=(-1, -2))
    m["diffusion_mse_mean"] = dmse.mean()
    m["diffusion_mse_std"] = dmse.std(correction=1)

    bp_mse = ((state_target[:, :, BP] - state_controlled[:, :, BP]) ** 2).mean(-1)
    li_mse = ((state_target[:, :, LI] - state_controlled[:, :, LI]) ** 2).mean(-1)
    m["beta_p_mse_mean"] = bp_mse.mean()
    m["beta_p_mse_std"] = bp_mse.std(correction=1)
    m["l_i_mse_mean"] = li_mse.mean()
    m["l_i_mse_std"] = li_mse.std(correction=1)
    m["obj_mse_mean"] = bp_mse.mean() + li_mse.mean()
    m["obj_mse_std"] = (bp_mse + li_mse).std(correction=1)

    q95 = state_controlled[:, :, Q95]
    below = q95 < safety_threshold
    m["time_below_ratio"] = below.float().mean()
    m["sample_below_ratio"] = below.any(dim=-1).float().mean()

    scores = q95.amin(dim=-1)
    m["safety_score_mean"] = scores.mean()
    m["safety_score_std"] = scores.std(correction=1)
    m["diffused_score_mse"] = (
        (diffused_scaled[:, :NT, Q95].amin(dim=-1) - scores) ** 2
    ).mean()

    # reported safe metric (reference: tokamak/utils/metrics.py:126-142)
    normalized = safety_threshold / scores
    safe = (scores >= safety_threshold).float()
    unsafe = 1.0 - safe
    inside = (normalized * safe).sum() / torch.clamp_min(safe.sum(), 1.0)
    outside = (normalized * unsafe).sum() / torch.clamp_min(unsafe.sum(), 1.0)
    m["reported_safe_metric"] = inside + outside
    return m
