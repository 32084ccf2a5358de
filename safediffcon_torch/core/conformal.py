"""Weighted conformal prediction: weight normalization and the quantile Q-hat.

Port of `safediffcon_tpu/core/conformal.py`, with both rank conventions of
the reference:
  - "alpha":           rank = min(ceil(alpha * (n+1)), n) - 1   (1D, tokamak)
  - "one_minus_alpha": rank = ceil((n+1) * (1-alpha)) - 1, clamped (2D smoke)

`conformal_quantile` is the whole step: normalize, weight, rank.
"""
from __future__ import annotations

import math

import torch


def normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """Replace infs with the max finite weight, then scale to sum = n, with
    the all-zero fallback to uniform weights (1D/posttrain/guidance.py:48-66)."""
    finite = torch.isfinite(weights)
    max_finite = torch.where(finite, weights, torch.full_like(weights, -math.inf)).max()
    w = torch.where(torch.isinf(weights), max_finite, weights)
    total = w.sum()
    n = w.shape[0]
    uniform = torch.ones_like(w)
    safe_total = torch.where(total == 0, torch.ones_like(total), total)
    return torch.where(total == 0, uniform, n * w / safe_total)


def quantile_rank(n: int, alpha: float, convention: str = "alpha") -> int:
    """Static rank index into the sorted weighted scores."""
    if convention == "alpha":
        # reference: 1D/posttrain/conformal.py:107
        return min(int(math.ceil(alpha * (n + 1))), n) - 1
    if convention == "one_minus_alpha":
        # reference: 2d/inference_2d.py:150-165
        return max(min(int(math.ceil((n + 1) * (1.0 - alpha))), n - 1) - 1, 0)
    raise ValueError(f"unknown quantile convention {convention!r}")


def weighted_quantile(
    scores: torch.Tensor, alpha: float, convention: str = "alpha"
) -> torch.Tensor:
    """Q-hat = sorted(scores)[rank]; scores are already weight-multiplied."""
    rank = quantile_rank(int(scores.shape[0]), alpha, convention)
    return torch.sort(scores).values[rank]


def conformal_quantile(
    scores: torch.Tensor,
    weights: torch.Tensor,
    alpha: float,
    convention: str = "alpha",
) -> torch.Tensor:
    """Full step 4-5: normalize weights, weight the scores, take the rank
    statistic. Returns a scalar Q-hat."""
    return weighted_quantile(normalize_weights(weights) * scores, alpha, convention)
