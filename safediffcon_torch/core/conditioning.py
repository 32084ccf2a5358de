"""Conditioning protocol: writing known values into samples each step.

Port of `safediffcon_tpu/core/conditioning.py`. A conditioner provides:

    apply(x)                 -> x with the conditions written in (a new tensor)
    loss_target(noise)       -> the regression target with conditioned cells zeroed
    mask_output(out, target) -> the model output with padded cells replaced by
                                the target (no loss on padding)

and may provide `apply_train(x, x_start)`, which the training loss uses
instead of `apply` to take the conditions from the clean sample.
"""
from __future__ import annotations


class IdentityConditioner:
    """No-op conditioner for unconditional models."""

    def apply(self, x):
        return x

    def loss_target(self, noise):
        return noise

    def mask_output(self, model_out, target):
        return model_out
