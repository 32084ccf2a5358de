"""Finite-difference Burgers' equation solver.

Port of `safediffcon_tpu/solvers/burgers.py` (reference explicit-Euler
scheme: 1D/data/generate_burgers.py:207-299): for each interior grid point
with zero ghost cells at the domain ends,

    du/dt = -1/2 * d(u^2)/dx + visc * d2u/dx2 + f(t, x)
    d(u^2)/dx  ~ (u^2[i+1] - u^2[i-1]) / (2 dx)      (central, 2nd order)
    d2u/dx2    ~ (u[i-1] - 2 u[i] + u[i+1]) / dx^2

with dx = 1/(s+1), explicit Euler in dt, and the control force f held
constant over each of `num_t` equal chunks of the T/dt steps. The rollout is
plain PyTorch, batched over samples, with the JAX scan's arithmetic in the
same order; each Euler step is a dozen small elementwise launches (no
kernel of the TPU package lies on this path).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def burgers_solve(
    u0: torch.Tensor,
    f: torch.Tensor,
    visc: float = 0.01,
    T: float = 1.0,
    dt: float = 1e-4,
    num_t: int = 10,
) -> torch.Tensor:
    """Batched Burgers rollout on the device of `u0`.

    Args:
        u0: (N, s) initial states.
        f: (N, num_t, s) piecewise-constant control forces.
        visc, T, dt, num_t: as in the reference solver.

    Returns:
        (N, num_t + 1, s) trajectories, u0 prepended
        (reference: burgers_numeric_solve_free, 1D/data/generate_burgers.py:297-299).
    """
    n, s = u0.shape
    if f.shape != (n, num_t, s):
        raise ValueError(f"force shape {tuple(f.shape)} != {(n, num_t, s)}")
    dx = 1.0 / (s + 1)
    steps = math.ceil(T / dt)
    record_every = steps // num_t
    if record_every * num_t != steps:
        raise ValueError("T/dt must divide evenly into num_t chunks")
    inv_2dx = 0.5 / dx
    visc_inv_dx2 = visc / dx**2

    u = u0
    frames = [u0]
    for j in range(num_t):
        fj = f[:, j]
        for _ in range(record_every):
            up = F.pad(u, (1, 1))
            us = up * up
            transport = (us[:, 2:] - us[:, :-2]) * inv_2dx
            diffusion = (up[:, :-2] - 2.0 * u + up[:, 2:]) * visc_inv_dx2
            u = u + dt * (-0.5 * transport + diffusion + fj)
        frames.append(u)
    return torch.stack(frames, dim=1)
