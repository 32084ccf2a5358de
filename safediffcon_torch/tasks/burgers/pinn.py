"""Coarse one-step PINN residual for the Burgers task.

Port of `safediffcon_tpu/tasks/burgers/pinn.py` (reference:
1D/model/pinn_loss.py:46-134, enabled by the `use_grad_norm/residual` train
options, off by default in 1D/configs/train_config.py:39): a
Crank-Nicolson-style one-step consistency check of the (u, f) channels of a
trajectory tensor at the coarse 11-step resolution, used either as an extra
loss term or as a guidance gradient.

Stencils are central differences with Dirichlet boundaries via zero ghost
cells, matching the reference's scipy-LIL-derived rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from safediffcon_torch.tasks.burgers.task import NT, U
from safediffcon_torch.tasks.burgers.task import F as F_CH


def one_step_solver_u(u: torch.Tensor, f: torch.Tensor, dt: float = 0.1, visc: float = 0.01,
                      mode: str = "mean") -> torch.Tensor:
    """Predict each frame of u from its neighbours with one coarse FD step
    (reference: 1D/model/pinn_loss.py:46-98).

    u: (B, 11, s); f: (B, 10, s). Returns u_pde (B, 11, s).
    """
    s = u.shape[-1]
    dx = 1.0 / (s + 1)

    def rhs(uu, ff):
        up = F.pad(uu, (1, 1))  # zero ghost cells
        du = (up[..., 2:] - up[..., :-2]) / (2 * dx)
        d2u = (up[..., :-2] - 2 * uu + up[..., 2:]) / dx**2
        return -uu * du + visc * d2u + ff

    u_next = u[:, :-1] + dt * rhs(u[:, :-1], f)  # forward prediction of u[1:]
    u_prev = u[:, 1:] - dt * rhs(u[:, 1:], f)  # backward prediction of u[:-1]

    if mode == "mean":
        u_pde = torch.zeros_like(u)
        u_pde[:, 1:] = u_next / 2
        u_pde[:, :-1] += u_prev / 2
    elif mode == "forward":
        u_pde = torch.cat([u[:, :1], u_next], dim=1)
    elif mode == "backward":
        u_pde = torch.cat([u_prev, u[:, -1:]], dim=1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return u_pde


def pinn_loss(u: torch.Tensor, f: torch.Tensor, mode: str = "mean",
              partially_observed: Optional[str] = None) -> torch.Tensor:
    """MSE between u and its one-step FD reconstruction
    (reference: 1D/model/pinn_loss.py:100-115)."""
    u_pde = one_step_solver_u(u, f, mode=mode)
    if partially_observed:
        nx = u.shape[-1]
        mid = slice(nx // 4, (nx * 3) // 4)
        u_pde = torch.cat([u_pde[..., : mid.start], u[..., mid], u_pde[..., mid.stop :]], dim=-1)
    return ((u_pde - u) ** 2).mean()


def residual_gradient(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """d(pinn loss)/dx over the full trajectory tensor (B, 16, 128, 3), by
    autograd, usable as an extra guidance term
    (reference: 1D/model/pinn_loss.py:129-134)."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        loss = pinn_loss(xx[:, :NT, :, U], xx[:, : NT - 1, :, F_CH], mode=mode)
        (grad,) = torch.autograd.grad(loss, xx)
    return grad
