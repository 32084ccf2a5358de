"""Offline dataset statistics for the smoke task (numpy only).

Port of `safediffcon_tpu/tasks/smoke/stats.py`, the reference's small
analysis apps over the npz dataset format:
  - dataset_success_rate: mean final target-bucket absorption fraction
    (reference: 2d/apps/success_rate.py:5-38),
  - dataset_safe_stats: mean final safe-region fraction + unsafe count vs
    a bound (reference: 2d/apps/safe_score.py:5-57),
  - derive_rescaler: per-channel int(max|X|)+1 normalization constants
    (reference: 2d/generate_rescaler.py:16-27).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from safediffcon_torch.tasks.smoke.task import SAFE, SMOKE


def dataset_success_rate(raw: np.ndarray) -> float:
    """Mean final-frame target-bucket smoke fraction over (N, F, H, W, 7)
    physical-unit records."""
    return float(raw[:, -1, 0, 0, SMOKE].mean())


def dataset_safe_stats(raw: np.ndarray, c_bound: float = 0.1) -> Dict[str, float]:
    final = raw[:, -1, 0, 0, SAFE]
    return {
        "safe_rate_mean": float(final.mean()),
        "unsafe_count": int((final > c_bound).sum()),
        "unsafe_rate": float((final > c_bound).mean()),
    }


def derive_rescaler(raw: np.ndarray) -> np.ndarray:
    """Per-channel int(max|X|)+1 for the field channels, 1 for the rate
    channels (reference: 2d/generate_rescaler.py:16-27)."""
    out = np.ones(raw.shape[-1], np.float32)
    for c in range(min(5, raw.shape[-1])):
        out[c] = int(np.abs(raw[..., c]).max()) + 1
    return out
