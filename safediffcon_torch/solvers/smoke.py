"""Incompressible 2D smoke solver in PyTorch.

Port of `safediffcon_tpu/solvers/smoke.py` (itself a rebuild of the
reference's PhiFlow 0.x stack: 2d/phi/flow.py, 2d/phi/math/nd.py,
2d/phi/solver/sparse.py, 2d/apps/evaluate_solver.py):

  - MAC staggered grids are (B, 128, 128, 2) tensors (component 0 = x,
    1 = y, grid index [y, x]) over a 127x127 cell domain.
  - The masked pressure Poisson solve is matrix-free conjugate gradient
    over the 5-point obstacle stencil. backend "xla" is the plain batched
    `_cg` below, with its dot products and convergence test over the WHOLE
    batch, as the JAX XLA path has them. backends "pallas_v1" / "pallas"
    run kernel K1 (`ops/pressure_cg.py`), which shares them within chunks
    of 8 samples and tests convergence every 1 / 32 iterations, as the two
    Pallas variants do. "auto", the default of every entry point here, is
    "pallas_v1" (`resolve_backend`).
  - Semi-Lagrangian advection backtraces cell centers and bilinearly
    resamples with the reference's clamped-coordinate boundary quirk.
  - The 256-step maze rollout is a Python loop over frames with the batch
    as the leading axis.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from safediffcon_torch.ops.pressure_cg import apply_A_planes, pressure_solve_kernel

N = 128  # staggered resolution
CELLS = 127  # cell-centered resolution (reference domain [127, 127])

BACKENDS = ("xla", "pallas", "pallas_v1")


def resolve_backend(backend: str) -> str:
    """The backend a solver name runs. "auto" is "pallas_v1": kernel K1 with
    a convergence check every iteration. (The JAX package resolves "auto" to
    its XLA CG, from a TPU measurement.)"""
    if backend == "auto":
        backend = "pallas_v1"
    if backend not in BACKENDS:
        raise ValueError(f"unknown solver backend {backend!r}")
    return backend

# ---------------------------------------------------------------------------
# Obstacle layout and masks (reference: 2d/apps/evaluate_solver.py:29-65)
# ---------------------------------------------------------------------------

OBSTACLES = [
    # (size_y, size_x), (origin_y, origin_x)
    ((1, 96), (16, 16)),     # bottom
    ((8, 1), (16, 16)),      # left down
    ((16, 1), (40, 16)),     # left medium
    ((40, 1), (72, 16)),     # left up
    ((8, 1), (16, 112)),     # right down
    ((16, 1), (40, 112)),    # right medium
    ((40, 1), (72, 112)),    # right up
    ((1, 8), (112, 16)),     # bucket walls
    ((1, 16), (112, 40)),
    ((1, 16), (112, 72)),
    ((1, 8), (112, 104)),
    ((16, 1), (64, 48)),     # y-axis obstacles
    ((16, 1), (96, 48)),
    ((16, 1), (64, 80)),
    ((16, 1), (96, 80)),
    ((1, 48), (40, 40)),     # x-axis (128-40-40 = 48)
]

# absorption buckets (y, x, dy, dx) (reference: get_bucket_mask, :114-135)
BUCKET_POS = [
    (112, 22, 15, 20), (112, 54, 15, 20), (112, 86, 15, 20),
    (22, 0, 20, 16), (54, 0, 20, 16), (22, 112, 20, 15), (54, 112, 20, 15),
]
TARGET_BUCKET = 1  # smoke_outs[1] is the target (reference :283)
SAFE_BOX = (40, 44, 24, 12)  # (reference: get_bucket_mask_safe, :148)


def fluid_mask() -> np.ndarray:
    """(CELLS, CELLS) float mask: 1 fluid, 0 obstacle."""
    m = np.ones((CELLS, CELLS), np.float32)
    for (sy, sx), (oy, ox) in OBSTACLES:
        m[oy : oy + sy, ox : ox + sx] = 0.0
    return m


class SmokeMasks(NamedTuple):
    """Precomputed static masks and stencils on one device."""

    velocity_mask: torch.Tensor  # (N, N, 2)
    diag: torch.Tensor  # (CELLS, CELLS) CG diagonal
    up_y: torch.Tensor  # off-diagonal stencils
    lo_y: torch.Tensor
    up_x: torch.Tensor
    lo_x: torch.Tensor
    bucket_masks: torch.Tensor  # (7, CELLS, CELLS)
    bucket_concat: torch.Tensor  # (CELLS, CELLS)
    safe_masks: torch.Tensor  # (8, CELLS, CELLS): safe box + 7 buckets
    safe_concat: torch.Tensor

    @property
    def planes(self) -> torch.Tensor:
        """(5, CELLS, CELLS) stencil planes in K1's order."""
        return torch.stack([self.diag, self.up_y, self.lo_y, self.up_x, self.lo_x])


def build_masks(device="cuda") -> SmokeMasks:
    fm = fluid_mask()
    # The domain boundary is OPEN on all sides (2d/apps/evaluate_solver.py:63):
    # pad_fluid pads ONES, pad_active pads ZEROS (2d/phi/flow.py:414-422).
    fmp = np.pad(fm, 1, constant_values=1.0)
    amp = np.pad(fm, 1, constant_values=0.0)

    # staggered velocity mask from the padded FLUID mask (2d/phi/flow.py:455-473)
    mask_y = np.minimum(fmp[1:, 1:], fmp[:-1, 1:])
    mask_x = np.minimum(fmp[1:, 1:], fmp[1:, :-1])
    velocity_mask = np.stack([mask_x, mask_y], axis=-1)

    # CG 5-point stencil (2d/phi/solver/sparse.py:27-80): off-diagonals from
    # the ACTIVE mask, diagonal from the FLUID mask
    up_y = amp[2:, 1:-1] * amp[1:-1, 1:-1]
    lo_y = amp[:-2, 1:-1] * amp[1:-1, 1:-1]
    up_x = amp[1:-1, 2:] * amp[1:-1, 1:-1]
    lo_x = amp[1:-1, :-2] * amp[1:-1, 1:-1]
    center = -(fmp[2:, 1:-1] + fmp[:-2, 1:-1] + fmp[1:-1, 2:] + fmp[1:-1, :-2])
    diag = np.minimum(center, -1.0)

    def region_masks(regions):
        ms = np.zeros((len(regions), CELLS, CELLS), np.float32)
        for i, (y, x, dy, dx) in enumerate(regions):
            ms[i, y : min(y + dy, CELLS), x : min(x + dx, CELLS)] = 1.0
        return ms

    bucket_masks = region_masks(BUCKET_POS)
    safe_masks = region_masks([SAFE_BOX] + BUCKET_POS)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SmokeMasks(
        velocity_mask=t(velocity_mask),
        diag=t(diag), up_y=t(up_y), lo_y=t(lo_y), up_x=t(up_x), lo_x=t(lo_x),
        bucket_masks=t(bucket_masks), bucket_concat=t(bucket_masks.max(axis=0)),
        safe_masks=t(safe_masks), safe_concat=t(safe_masks.max(axis=0)),
    )


# ---------------------------------------------------------------------------
# Staggered-grid operators
# ---------------------------------------------------------------------------

def divergence(v: torch.Tensor) -> torch.Tensor:
    """(B, N, N, 2) staggered -> (B, CELLS, CELLS) cell divergence."""
    vy, vx = v[..., 1], v[..., 0]
    return (vy[:, 1:, :-1] - vy[:, :-1, :-1]) + (vx[:, :-1, 1:] - vx[:, :-1, :-1])


def pressure_gradient(p: torch.Tensor) -> torch.Tensor:
    """(B, CELLS, CELLS) -> staggered (B, N, N, 2). numpy's "symmetric" pad
    of width 1 repeats the edge value, which is torch's "replicate"."""
    pp = F.pad(p[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gy = pp[:, 1:, 1:] - pp[:, :-1, 1:]
    gx = pp[:, 1:, 1:] - pp[:, 1:, :-1]
    return torch.stack([gx, gy], dim=-1)


def _apply_A(masks: SmokeMasks, p: torch.Tensor) -> torch.Tensor:
    """Matrix-free masked 5-point Laplacian on (B, CELLS, CELLS)."""
    return apply_A_planes((masks.diag, masks.up_y, masks.lo_y, masks.up_x, masks.lo_x), p)


def _cg(masks: SmokeMasks, rhs: torch.Tensor, accuracy: float, max_iter: int,
        guess: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched CG as the reference has it (2d/phi/solver/base.py:56-110):
    dot products and the residual-max termination over the whole batch.
    The loop tests convergence on the host, once per iteration."""
    if guess is None:
        x = torch.zeros_like(rhs)
        momentum = rhs
    else:
        x = guess
        momentum = rhs - _apply_A(masks, guess)
    a_momentum = _apply_A(masks, momentum)
    residual = momentum
    i = 0
    while i < max_iter and bool(residual.abs().max() >= accuracy):
        tmp = (momentum * a_momentum).sum()
        a = (momentum * residual).sum() / tmp
        x = x + a * momentum
        residual = residual - a * a_momentum
        b = -(residual * a_momentum).sum() / tmp
        momentum = residual + b * momentum
        a_momentum = _apply_A(masks, momentum)
        i += 1
    return x


class _PressureSolve(torch.autograd.Function):
    """x = A^-1 div with the backward pass a CG solve of the cotangent (A is
    symmetric; 2d/phi/solver/sparse.py:106-112); the warm start gets no
    gradient."""

    @staticmethod
    def forward(ctx, div, guess, masks, accuracy, max_iter):
        ctx.masks, ctx.accuracy, ctx.max_iter = masks, accuracy, max_iter
        return _cg(masks, div, accuracy, max_iter, guess)

    @staticmethod
    def backward(ctx, g):
        return (_cg(ctx.masks, g.contiguous(), ctx.accuracy, ctx.max_iter),
                torch.zeros_like(g), None, None, None)


def pressure_solve(
    masks: SmokeMasks, div: torch.Tensor, accuracy: float = 1e-6,
    max_iter: int = 500, guess: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Solve the masked Poisson equation A p = div with the batched CG."""
    if guess is None:
        guess = torch.zeros_like(div)
    return _PressureSolve.apply(div, guess, masks, accuracy, max_iter)


def divergence_free(
    masks: SmokeMasks, v: torch.Tensor, accuracy: float = 1e-6,
    max_iter: int = 500, p_guess: Optional[torch.Tensor] = None,
    return_pressure: bool = False, backend: str = "auto",
):
    """Incompressible projection (reference: FluidSimulation.divergence_free,
    2d/phi/flow.py:317-327): pressure solve, subtract the masked grad p."""
    backend = resolve_backend(backend)
    v = v * masks.velocity_mask
    if backend == "xla":
        p = pressure_solve(masks, divergence(v), accuracy, max_iter, guess=p_guess)
    else:
        p = pressure_solve_kernel(
            masks, divergence(v), accuracy, max_iter, guess=p_guess,
            check_every=1 if backend == "pallas_v1" else 32)
    v = v - pressure_gradient(p) * masks.velocity_mask
    if return_pressure:
        return v, p
    return v


def at_centers(v: torch.Tensor) -> torch.Tensor:
    """Staggered (B, N, N, 2) -> cell-centered (B, CELLS, CELLS, 2) in
    (vy, vx) order."""
    vy, vx = v[..., 1], v[..., 0]
    cy = 0.5 * (vy[:, 1:, :-1] + vy[:, :-1, :-1])
    cx = 0.5 * (vx[:, :-1, 1:] + vx[:, :-1, :-1])
    return torch.stack([cy, cx], dim=-1)


def bilinear_sample(field: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear resampling of (B, H, W) at (B, H, W, 2) [y, x] coordinates with
    the reference's asymmetric boundary (2d/phi/math/scipy_backend.py:58-75):
    coordinates clamp to [0, dim] (not dim-1), and points past dim-1 read 0.
    The four corners are gathered explicitly (grid_sample has neither rule).
    A NaN coordinate reads 0, as in JAX: it is taken as dim, past dim-1."""
    b, h, w = field.shape
    cy = coords[..., 0].nan_to_num(nan=float(h)).clamp(0.0, float(h))
    cx = coords[..., 1].nan_to_num(nan=float(w)).clamp(0.0, float(w))
    valid = (cy <= h - 1) & (cx <= w - 1)
    cy = cy.clamp(max=h - 1.0)
    cx = cx.clamp(max=w - 1.0)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wy = cy - y0
    wx = cx - x0
    y0 = y0.long()
    x0 = x0.long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    flat = field.reshape(b, -1)

    def gather(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(b, -1)).reshape(yy.shape)

    out = (
        gather(y0, x0) * (1 - wy) * (1 - wx)
        + gather(y0, x1) * (1 - wy) * wx
        + gather(y1, x0) * wy * (1 - wx)
        + gather(y1, x1) * wy * wx
    )
    return out * valid


def advect_scalar(field: torch.Tensor, v: torch.Tensor, dt: float = 1.0) -> torch.Tensor:
    """Semi-Lagrangian advection of a cell-centered (B, CELLS, CELLS) field
    (reference: _advect_centered_field, 2d/phi/math/nd.py:425-431)."""
    c = at_centers(v)
    ys = torch.arange(CELLS, dtype=field.dtype, device=field.device)
    idx_y, idx_x = torch.meshgrid(ys, ys, indexing="ij")
    coords = torch.stack(
        [idx_y[None] - c[..., 0] * dt, idx_x[None] - c[..., 1] * dt], dim=-1
    )
    return bilinear_sample(field, coords)


# ---------------------------------------------------------------------------
# Control assembly + full rollout (reference: evaluate_solver.py:82-349)
# ---------------------------------------------------------------------------

def assemble_control(masks: SmokeMasks, prev_v: torch.Tensor,
                     control: torch.Tensor) -> torch.Tensor:
    """Write the control field into the border band; the interior
    [16:112]^2 keeps the previous velocity (get_envolve, :82-111)."""
    band = torch.ones((N, N, 1), dtype=prev_v.dtype, device=prev_v.device)
    band[16:112, 16:112, :] = 0.0
    return control * band + prev_v * (1.0 - band)


class RolloutRecord(NamedTuple):
    density: torch.Tensor  # (B, T, CELLS, CELLS) unabsorbed density
    zero_density: torch.Tensor  # (B, T, CELLS, CELLS) absorbed ("set-zero") field
    velocity: torch.Tensor  # (B, T, N, N, 2)
    smoke_rate: torch.Tensor  # (B, T) target-bucket absorption fraction
    smoke_safe_rate: torch.Tensor  # (B, T) safe-box absorption fraction
    mass: torch.Tensor  # (B, T) total mass: absorbed-by-buckets + in-domain


def _absorb(density, region_masks, concat, accum):
    """One absorption step: add region sums to accum, zero those cells
    (reference: evaluate_solver.py:268-275,304-311)."""
    sums = torch.einsum("byx,ryx->br", density, region_masks)
    return density * (1.0 - concat)[None], accum + sums


def smoke_rollout(
    masks: SmokeMasks,
    init_density: torch.Tensor,  # (B, CELLS, CELLS)
    init_velocity: torch.Tensor,  # (B, N, N, 2)
    controls: torch.Tensor,  # (B, T, N, N, 2) per-frame control fields
    accuracy: float = 1e-6,
    max_iter: int = 500,
    dt: float = 1.0,
    warm_start: bool = True,
    backend: str = "auto",
) -> RolloutRecord:
    """Full T+1-frame rollout (reference solver(), evaluate_solver.py:209-349).
    Frame 0 records the initial state after absorption; frames 1..T evolve
    with control frames 0..T-1. `warm_start` seeds each frame's CG with the
    previous frame's pressure."""
    b = init_density.shape[0]
    n_buckets = masks.bucket_masks.shape[0]
    n_safe = masks.safe_masks.shape[0]
    dtype, device = init_density.dtype, init_density.device

    dens = init_density
    zero_d, b_acc = _absorb(dens, masks.bucket_masks, masks.bucket_concat,
                            torch.zeros((b, n_buckets), dtype=dtype, device=device))
    safe_d, s_acc = _absorb(dens, masks.safe_masks, masks.safe_concat,
                            torch.zeros((b, n_safe), dtype=dtype, device=device))

    def rates(b_acc, s_acc, zero_d, safe_d):
        mass = b_acc.sum(-1) + zero_d.sum((-1, -2))
        smoke = b_acc[:, TARGET_BUCKET] / mass
        safe = s_acc[:, 0] / (s_acc.sum(-1) + safe_d.sum((-1, -2)))
        return smoke, safe, mass

    smoke, safe, mass = rates(b_acc, s_acc, zero_d, safe_d)
    ds, zs, vs, sm, sf, ms = [dens], [zero_d], [init_velocity], [smoke], [safe], [mass]
    vel = init_velocity
    p_prev = torch.zeros((b, CELLS, CELLS), dtype=dtype, device=device)
    for k in range(controls.shape[1]):
        vel = assemble_control(masks, vel, controls[:, k])
        vel, p_prev = divergence_free(
            masks, vel, accuracy, max_iter,
            p_guess=p_prev if warm_start else None, return_pressure=True,
            backend=backend,
        )
        vel = vel * masks.velocity_mask

        dens = advect_scalar(dens, vel, dt)
        zero_d = advect_scalar(zero_d, vel, dt)
        safe_d = advect_scalar(safe_d, vel, dt)

        zero_d, b_acc = _absorb(zero_d, masks.bucket_masks, masks.bucket_concat, b_acc)
        safe_d, s_acc = _absorb(safe_d, masks.safe_masks, masks.safe_concat, s_acc)
        smoke, safe, mass = rates(b_acc, s_acc, zero_d, safe_d)
        for acc, val in zip((ds, zs, vs, sm, sf, ms), (dens, zero_d, vel, smoke, safe, mass)):
            acc.append(val)

    return RolloutRecord(*(torch.stack(acc, dim=1) for acc in (ds, zs, vs, sm, sf, ms)))


def upsample_control(c: torch.Tensor, time_scale: int, space_scale: int) -> torch.Tensor:
    """(B, nt, nx, nx[, C]) low-res control -> (B, nt*ts, nx*ss, nx*ss[, C])
    nearest-neighbor tiling (reference: evaluate_solver.py:228-232)."""
    c = c.repeat_interleave(time_scale, dim=1)
    c = c.repeat_interleave(space_scale, dim=2)
    return c.repeat_interleave(space_scale, dim=3)


def evaluate_control(
    masks: SmokeMasks,
    init_density_64: torch.Tensor,  # (B, 64, 64)
    c1_32: torch.Tensor,  # (B, nt, 64, 64) x-control at record resolution
    c2_32: torch.Tensor,  # (B, nt, 64, 64) y-control
    accuracy: float = 1e-8,  # reference eval tolerance (evaluate_solver.py:108)
    max_iter: int = 500,
    time_scale: int = 8,
    space_scale: int = 2,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, RolloutRecord]:
    """The reference evaluation entry: upsample controls to
    (nt*time_scale, 128, 128), roll out, and return per-record-frame
    (smoke_rate, smoke_safe_rate) plus the full record
    (reference: evaluate_solver.py:209-349). The reference config is nt=32,
    time_scale=8, space_scale=2 -> 256 simulation frames."""
    b = init_density_64.shape[0]
    dens128 = init_density_64.repeat_interleave(space_scale, dim=1)
    dens128 = dens128.repeat_interleave(space_scale, dim=2)
    init_density = dens128[:, :CELLS, :CELLS]

    c = torch.stack([c1_32, c2_32], dim=-1)  # (B, nt, nx, nx, 2)
    controls = upsample_control(c, time_scale, space_scale)[:, :-1]

    init_velocity = torch.zeros((b, N, N, 2), dtype=init_density.dtype,
                                device=init_density.device)
    init_velocity[..., 1] = 0.8

    rec = smoke_rollout(masks, init_density, init_velocity, controls, accuracy,
                        max_iter, backend=backend)
    return rec.smoke_rate[:, ::time_scale], rec.smoke_safe_rate[:, ::time_scale], rec
