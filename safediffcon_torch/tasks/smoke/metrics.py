"""2D smoke evaluation: solver rollout of diffused controls + metrics.

Port of `safediffcon_tpu/tasks/smoke/metrics.py`; the metric formulas are
the reference's (2d/inference_2d.py:407-507).
"""
from __future__ import annotations

from typing import Dict

import torch

from safediffcon_torch.solvers import smoke as S
from safediffcon_torch.tasks.smoke.task import CX, CY, DENS, SAFE, SMOKE


def solver_rollout(
    masks: S.SmokeMasks,
    pred_scaled: torch.Tensor,  # (B, F, 64, 64, 7) physical units
    data_scaled: torch.Tensor,  # (B, F, 64, 64, 7) physical units
    accuracy: float = 1e-8,  # reference eval tolerance (evaluate_solver.py:108)
    max_iter: int = 500,
    time_scale: int = 8,
    space_scale: int = 2,
    backend: str = "auto",
) -> torch.Tensor:
    """Roll the diffused controls through the solver and reassemble the
    7-channel record (reference: 2d/inference_2d.py:389-460). Initial density
    comes from the DATA; the control interior is zeroed (indirect control)."""
    size = S.N // space_scale
    lo, hi = 16 // space_scale, 112 // space_scale
    ctrl = pred_scaled[..., CX : CY + 1].clone()
    ctrl[:, :, lo:hi, lo:hi, :] = 0.0
    init_density = data_scaled[:, 0, :, :, DENS]
    smoke, safe, rec = S.evaluate_control(
        masks, init_density, ctrl[..., 0], ctrl[..., 1],
        accuracy=accuracy, max_iter=max_iter, time_scale=time_scale,
        space_scale=space_scale, backend=backend,
    )
    n_rec = smoke.shape[1]
    out = torch.zeros(pred_scaled.shape[:1] + (n_rec, size, size, 7),
                      dtype=pred_scaled.dtype, device=pred_scaled.device)
    d = rec.density[:, ::time_scale, ::space_scale, ::space_scale]
    out[:, :, : d.shape[2], : d.shape[3], DENS] = d
    v = rec.velocity[:, ::time_scale, ::space_scale, ::space_scale]
    out[..., 1] = v[..., 0]
    out[..., 2] = v[..., 1]
    # record the applied (banded) control at record resolution
    out[..., CX : CY + 1] = ctrl[:, :n_rec]
    out[..., SMOKE] = smoke[:, :, None, None]
    out[..., SAFE] = safe[:, :, None, None]
    return out


def evaluate_samples(
    pred_scaled: torch.Tensor,
    solver_out: torch.Tensor,
    Q,
    safe_bound: float,
) -> Dict[str, torch.Tensor]:
    """Metric set of multi_evaluate (reference: 2d/inference_2d.py:471-507);
    pred's rate channels must already be spatially tiled means."""
    # first frame masked out of the field-error metrics (reference :474-477)
    mask = torch.ones(pred_scaled.shape[:2], dtype=pred_scaled.dtype,
                      device=pred_scaled.device)
    mask[:, 0] = 0.0
    m5 = mask[:, :, None, None, None]
    p = pred_scaled * m5
    d = solver_out * m5

    err = p - d
    mse = torch.cat([err[..., :3], err[..., -2:]], dim=-1)
    mse = (mse ** 2).mean(dim=(1, 2, 3, 4))
    n_l2 = torch.sqrt((err[..., :3] ** 2).sum(dim=(1, 2, 3, 4))) / torch.sqrt(
        (d[..., :3] ** 2).sum(dim=(1, 2, 3, 4))
    )

    m: Dict[str, torch.Tensor] = {}
    m["J_target"] = (-solver_out[:, -1, 0, 0, SMOKE]).mean()
    m["safe_target"] = solver_out[:, -1, 0, 0, SAFE].mean()

    viol = torch.clamp_min(solver_out[:, -1, 0, 0, SAFE] - safe_bound, 0.0)
    m["J_safe_target"] = viol.mean()
    m["unsafe_percentage"] = (viol > 0).float().mean() * 100.0
    viol_pred = torch.clamp_min(pred_scaled[:, -1, 0, 0, SAFE] + Q - safe_bound, 0.0)
    m["J_safe_target_pred"] = viol_pred.mean()
    m["unsafe_percentage_pred"] = (viol_pred > 0).float().mean() * 100.0

    viol_t = torch.clamp_min(solver_out[:, :, 0, 0, SAFE] - safe_bound, 0.0)
    m["unsafe_percentage_time"] = (viol_t > 0).float().mean() * 100.0
    viol_pt = torch.clamp_min(pred_scaled[:, :, 0, 0, SAFE] + Q - safe_bound, 0.0)
    m["unsafe_percentage_pred_time"] = (viol_pt > 0).float().mean() * 100.0

    m["mse"] = mse.mean()
    m["n_l2"] = n_l2.mean()
    return m
