"""Conditioning protocol: writing known values into samples each step.

Port of `safediffcon_tpu/core/conditioning.py`. The sampler needs only
`apply(x)`, which returns x with the conditions written in, as a new tensor;
`loss_target`/`mask_output` come with the training slice.
"""
from __future__ import annotations


class IdentityConditioner:
    """No-op conditioner for unconditional models."""

    def apply(self, x):
        return x
