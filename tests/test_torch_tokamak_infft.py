"""Tokamak inference-time fine-tuning against the JAX package on the tiny
config, with JAX's draws replayed into the port: one epoch of
`run_inference(finetune_config())` (calibrate -> one InfFT step, sampling
with gradients through the final denoise step -> evaluate; plain Adam
(0.99, 0.999), no clip, no EMA)."""
import torch

from tokamak_replay import (  # noqa: F401  (data, flax_params: fixtures)
    check_epoch_against_jax, data, flax_params,
)

torch.set_num_threads(1)


def test_infft_epoch_matches_jax(data, flax_params):
    check_epoch_against_jax(data, flax_params, backward=True)


def test_infft_epochs_match_jax(data, flax_params):
    """Two epochs over the test split in two batches: the key chain across
    batches and epochs (`tokamak_replay.epoch_draws`, which
    `tools/tokamak_weight_swap.py` replays too); each value within
    tokamak_replay.LATER_RTOL."""
    check_epoch_against_jax(data, flax_params, backward=True, epochs=2, batches=2)
