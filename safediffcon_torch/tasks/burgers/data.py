"""Burgers dataset: generation through the solver, and in-memory splits.

Port of `safediffcon_tpu/tasks/burgers/data.py` (reference generator:
1D/data/generate_burgers.py:302-418,421-559): random 2-Gaussian initial
states and sums of 8 separable space-time Gaussian forces, drawn with the
same numpy generator calls as in JAX, so a seed gives the same u0 and f bit
for bit; the rollout runs on the port's solver on `device`. Splits are small
(N x 11 x 128 float32) and live in host memory as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from safediffcon_torch.solvers.burgers import burgers_solve
from safediffcon_torch.tasks.burgers.task import NT, NX, PAD_SIZE, SCALER


def _two_gaussian_u0(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """Random initial condition: positive + negative Gaussian bump
    (reference: 1D/data/generate_burgers.py:361-372)."""
    dx = 1.0 / (s + 1)
    x = np.linspace(dx, 1.0 - dx, s)

    def bump(loc_lo, loc_hi, amp_lo, amp_hi):
        loc = rng.uniform(loc_lo, loc_hi, (n, 1))
        amp = rng.uniform(amp_lo, amp_hi, (n, 1))
        sig = rng.uniform(0.05, 0.15, (n, 1))
        return amp * np.exp(-0.5 * (x[None, :] - loc) ** 2 / sig**2)

    return bump(0.2, 0.4, 0.0, 2.0) + bump(0.6, 0.8, -2.0, 0.0)


def _varying_f(
    rng: np.random.Generator,
    n: int,
    s: int,
    t: int,
    amp_compensate: float = 2.0,
    tmax: float = 1.0,
    partial_control: Optional[str] = None,
    alpha: float = 1.0,
) -> np.ndarray:
    """Sum of 8 separable space-time Gaussian force terms
    (reference: make_data_varying_f, 1D/data/generate_burgers.py:338-418),
    with the partial-control spatial mask ('front_rear_quarter', :376-389)
    and the alpha distribution-shift scaling (:416-417)."""
    dx = 1.0 / (s + 1)
    x = np.linspace(dx, 1.0 - dx, s)
    dt = tmax / (t + 1)
    ts = np.linspace(dt, tmax - dt, t)

    if partial_control is None:
        f_space_mask = np.ones((1, 1, s))
    elif partial_control == "front_rear_quarter":
        f_space_mask = np.zeros((1, 1, s))
        f_space_mask[:, :, np.r_[0 : s // 4, 3 * s // 4 : s]] = 1.0
        amp_compensate = amp_compensate * 2
    else:
        raise ValueError(f"invalid partial control mode {partial_control!r}")

    def rand_f(is_rand_amp: bool) -> np.ndarray:
        if is_rand_amp:
            amp = rng.integers(0, 2, (n, 1, 1)) * rng.uniform(-1.5, 1.5, (n, 1, 1))
        else:
            amp = rng.uniform(-1.5, 1.5, (n, 1, 1))
        loc = rng.uniform(0, 1, (n, 1, 1))
        sig = rng.uniform(0.1, 0.4, (n, 1, 1)) * 0.5
        exp_space = np.exp(-0.5 * (x[None, None, :] - loc) ** 2 / sig**2)
        loc = rng.uniform(0, 1, (n, 1, 1))
        sig = rng.uniform(0.1, 0.4, (n, 1, 1)) * 0.5
        exp_time = amp_compensate * np.exp(-0.5 * (ts[None, :, None] - loc) ** 2 / sig**2)
        return amp * exp_space * exp_time

    f = rand_f(False)
    for _ in range(7):
        f = f + rand_f(True)
    f = f * f_space_mask
    if alpha != 1.0:
        f = np.clip(f * alpha, -10.0, 10.0)  # ddpm normalizer is 10
    return f


def generate_burgers_dataset(
    path: str,
    n_train: int = 40000,
    n_cal: int = 1000,
    n_test: int = 50,
    seed: int = 0,
    nx: int = NX,
    nt: int = NT,
    solve_batch: int = 4096,
    partial_control: Optional[str] = None,
    alpha: float = 1.0,
    device="cuda",
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Generate train/cal/test splits, roll them out on `device` in batches
    of `solve_batch`, and save them to one .npz file.

    Returns {split: (u (N, nt, nx), f (N, nt-1, nx))} in physical units.
    """
    rng = np.random.default_rng(seed)
    total = n_train + n_cal + n_test
    u0 = _two_gaussian_u0(rng, total, nx).astype(np.float32)
    f = _varying_f(rng, total, nx, nt - 1, partial_control=partial_control,
                   alpha=alpha).astype(np.float32)

    us = []
    for lo in range(0, total, solve_batch):
        hi = min(lo + solve_batch, total)
        traj = burgers_solve(
            torch.as_tensor(u0[lo:hi], device=device), torch.as_tensor(f[lo:hi], device=device),
            visc=0.01, T=1.0, dt=1e-4, num_t=nt - 1,
        )
        us.append(traj.cpu().numpy())
    u = np.concatenate(us, axis=0)

    perm = rng.permutation(total)
    u, f = u[perm], f[perm]
    splits = {
        "train": (u[:n_train], f[:n_train]),
        "cal": (u[n_train : n_train + n_cal], f[n_train : n_train + n_cal]),
        "test": (u[n_train + n_cal :], f[n_train + n_cal :]),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        **{f"{k}_{name}": arr for k, (uu, ff) in splits.items()
           for name, arr in (("u", uu), ("f", ff))},
    )
    return splits


def stack_and_pad(
    u: np.ndarray, f: np.ndarray, use_max_safety: bool = True, normalize: bool = True
) -> np.ndarray:
    """(u (N, nt, nx), f (N, nt-1, nx)) -> (N, PAD_SIZE, nx, 3) channels-last.

    Safety channel s = u^2, replaced by the per-sample max when
    use_max_safety; /SCALER normalization (reference: 1D/data/burgers.py:104-142).
    """
    n, nt, nx = u.shape
    s = u**2
    if use_max_safety:
        s = np.broadcast_to(s.max(axis=(1, 2))[:, None, None], s.shape).copy()
    out = np.zeros((n, PAD_SIZE, nx, 3), dtype=np.float32)
    out[:, :nt, :, 0] = u
    out[:, : nt - 1, :, 1] = f
    out[:, :nt, :, 2] = s
    if normalize:
        out /= SCALER
    return out


@dataclasses.dataclass
class BurgersDataset:
    """In-memory split of stacked/normalized trajectories.

    data: (N, 16, 128, 3) normalized; u_phys: (N, 11, 128) physical units
    (for evaluation targets, reference: 1D/utils/common.py:78-108).
    """

    data: np.ndarray
    u_phys: np.ndarray
    f_phys: np.ndarray

    @classmethod
    def load(
        cls,
        path: str,
        split: str,
        use_max_safety: bool = True,
        subset: Optional[int] = None,
    ) -> "BurgersDataset":
        with np.load(path) as z:
            u = z[f"{split}_u"]
            f = z[f"{split}_f"]
        if subset is not None:
            u, f = u[:subset], f[:subset]
        return cls(
            data=stack_and_pad(u, f, use_max_safety=use_max_safety),
            u_phys=u.astype(np.float32),
            f_phys=f.astype(np.float32),
        )

    @classmethod
    def load_h5(
        cls,
        path: str,
        split: str,
        nt: int = NT,
        nx: int = NX,
        use_max_safety: bool = True,
        subset: Optional[int] = None,
    ) -> "BurgersDataset":
        """Read the reference's on-disk HDF5 layout: each split in
        `burgers_{split}.h5` under a group named after the split, with
        datasets `pde_{nt}-{nx}` (state trajectories, (N, nt, nx)) and
        `pde_{nt}-{nx}_f` (forces, (N, nt-1, nx)), written as float64
        (reference: 1D/data/load_hdf5.py:6-57, generate_burgers.py:535-559).
        Needs h5py, imported here only."""
        import h5py

        with h5py.File(path, "r") as h5:
            grp = h5[split]
            sel = slice(None) if subset is None else slice(subset)
            u = np.asarray(grp[f"pde_{nt}-{nx}"][sel], dtype=np.float32)
            f = np.asarray(grp[f"pde_{nt}-{nx}_f"][sel], dtype=np.float32)
        return cls(
            data=stack_and_pad(u, f, use_max_safety=use_max_safety),
            u_phys=u,
            f_phys=f,
        )

    def __len__(self) -> int:
        return self.data.shape[0]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """Yield (indices, batch) numpy pairs covering the split once."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for lo in range(0, len(idx), batch_size):
            sel = idx[lo : lo + batch_size]
            yield sel, self.data[sel]
