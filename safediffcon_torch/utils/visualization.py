"""Visualization utilities (matplotlib-gated).

The port's own copy of `safediffcon_tpu/utils/visualization.py`, which
covers the reference's plotting and eyeballing tools:
  - tokamak state-trajectory plots with targets + the q95 safety threshold
    (reference flow: tokamak/visualization.py — sample, solve, dump, plot)
  - KSTAR plasma-boundary plot from the k2rz shape predictor
    (reference: tokamak/kstar_solver_vis.py k2rz usage + img overlay)
  - 1D Burgers space-time heatmaps (reference: 1D/data/test_dataset.ipynb)
  - 2D smoke frame grids (density/control eyeballing of the sim records)
  - vis-data dumps (the reference pickles inputs/outputs/controls under
    vis_data/sample_{i}/, kstar_solver_vis.py:465-467; we write one npz)

All functions save to a path and return it; matplotlib is imported lazily
with the Agg backend so headless use never needs a display. Where matplotlib
is not installed, each plotting call raises ImportError and `dump_vis_data`
(numpy only) still works.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed here; "
                          "dump_vis_data writes the arrays without it") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def dump_vis_data(out_dir: str, sample_id: int, **arrays) -> str:
    """Persist per-sample arrays for later plotting (reference writes
    pickles under vis_data/sample_{id}/, kstar_solver_vis.py:152-155,
    463-467; one npz here)."""
    d = os.path.join(out_dir, f"sample_{sample_id}")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "vis_data.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def plot_tokamak_trajectories(
    states_pred: np.ndarray,      # (T, 3) diffused (betap, q95, li)
    states_solver: Optional[np.ndarray] = None,  # (T, 3) solver rollout
    targets: Optional[Sequence[float]] = None,   # (3,) (betap*, q95*, li*)
    q95_threshold: float = 4.98,
    path: str = "tokamak_traj.png",
) -> str:
    """(βp, q95, li) time series with target lines and the q95 safety
    threshold (the quantity the tokamak task's safety bound constrains,
    reference: tokamak/utils/metrics.py:101-142)."""
    plt = _plt()
    names = [r"$\beta_p$", r"$q_{95}$", r"$l_i$"]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for i, ax in enumerate(axes):
        ax.plot(np.asarray(states_pred)[:, i], label="diffused", lw=1.5)
        if states_solver is not None:
            ax.plot(np.asarray(states_solver)[:, i], label="solver", lw=1.5,
                    ls="--")
        if targets is not None and targets[i] is not None:
            ax.axhline(targets[i], color="tab:green", lw=1, label="target")
        if i == 1:
            ax.axhline(q95_threshold, color="tab:red", lw=1, ls=":",
                       label="safety bound")
        ax.set_title(names[i])
        ax.set_xlabel("step")
    axes[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_kstar_boundary(
    kstar_params: Dict,
    ip: float = 0.5,
    bt: float = 1.8,
    betap: float = 1.5,
    rin: float = 1.34,
    rout: float = 2.22,
    k: float = 1.7,
    du: float = 0.3,
    dl: float = 0.75,
    path: str = "kstar_boundary.png",
) -> str:
    """Plasma boundary (R, Z) contour via the k2rz shape predictor
    (reference: kstar_solver_vis.py plasma view; model
    tokamak/common/model_structure.py:5-38); `kstar_params` as
    `solvers.kstar.load_kstar_params` gives them, on any device."""
    from safediffcon_torch.solvers.kstar import k2rz_forward

    plt = _plt()
    r, z = k2rz_forward(kstar_params, ip, bt, betap, rin, rout, k, du, dl)
    fig, ax = plt.subplots(figsize=(4, 5))
    ax.plot(np.r_[r, r[0]], np.r_[z, z[0]], lw=2, color="tab:blue")
    ax.set_xlabel("R [m]")
    ax.set_ylabel("Z [m]")
    ax.set_title("KSTAR plasma boundary (k2rz)")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_burgers_trajectory(
    u: np.ndarray,                 # (nt, nx) state
    f: Optional[np.ndarray] = None,  # (nt-1, nx) control force
    u_bound: Optional[float] = 0.8,
    path: str = "burgers_traj.png",
) -> str:
    """Space-time heatmaps of state and control with the |u| safety bound
    marked (the 1D dataset-eyeballing view, 1D/data/test_dataset.ipynb)."""
    plt = _plt()
    ncols = 2 if f is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 3.2), squeeze=False)
    im = axes[0, 0].imshow(np.asarray(u), aspect="auto", cmap="RdBu_r",
                           origin="lower")
    axes[0, 0].set_title("u(t, x)" + (
        f"  (|u| > {u_bound}: {(np.abs(u) > u_bound).mean():.1%} of points)"
        if u_bound else ""))
    axes[0, 0].set_xlabel("x")
    axes[0, 0].set_ylabel("t")
    fig.colorbar(im, ax=axes[0, 0])
    if f is not None:
        im = axes[0, 1].imshow(np.asarray(f), aspect="auto", cmap="PuOr",
                               origin="lower")
        axes[0, 1].set_title("control f(t, x)")
        axes[0, 1].set_xlabel("x")
        fig.colorbar(im, ax=axes[0, 1])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_smoke_frames(
    record: np.ndarray,            # (T, H, W, C>=1) smoke record
    frames: Sequence[int] = (0, 8, 16, 24, 31),
    path: str = "smoke_frames.png",
) -> str:
    """Density frame strip (+ control quiver when channels 3:5 exist) —
    eyeballing view of the (32, 64, 64, 7) smoke records."""
    plt = _plt()
    record = np.asarray(record)
    frames = [f for f in frames if f < record.shape[0]]
    fig, axes = plt.subplots(1, len(frames), figsize=(2.6 * len(frames), 2.8))
    if len(frames) == 1:
        axes = [axes]
    for ax, fr in zip(axes, frames):
        ax.imshow(record[fr, :, :, 0], cmap="inferno", origin="lower")
        if record.shape[-1] >= 5:
            h, w = record.shape[1:3]
            step = max(h // 8, 1)
            yy, xx = np.mgrid[0:h:step, 0:w:step]
            ax.quiver(xx, yy, record[fr, ::step, ::step, 3],
                      record[fr, ::step, ::step, 4], color="cyan", scale=30)
        ax.set_title(f"t={fr}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
