"""Tokamak dataset: closed-loop generation (the port's surrogate + RL
policy) and in-memory splits.

Port of `safediffcon_tpu/tasks/tokamak/data.py`. The reference consumes a
50k-trajectory HF dataset generated offline by a ThreadPool of per-seed
subprocesses driving the Keras solver (reference:
tokamak/kstar_data_generator_random_target.py,
tokamak/data_parallel_generate.py:17-33). Here the closed loop runs batched
on `device`. Split sizes follow the reference: train 48950 / cal 1000 /
test 50 (tokamak/data/tokamak_dataset.py:11-16). `TokamakDataset.load_hf`
reads the reference's HF on-disk layout with the port's numpy Arrow reader
(`utils/arrow_ipc.py`), without `datasets` or `pyarrow`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from safediffcon_torch.solvers.kstar import closed_loop_batch, load_kstar_params
from safediffcon_torch.tasks.tokamak.task import N_ACTIONS, N_STATES, NT, PAD_SIZE, SCALER
from safediffcon_torch.utils import arrow_ipc


def generate_tokamak_dataset(
    path: str,
    n_train: int = 48950,
    n_cal: int = 1000,
    n_test: int = 50,
    seed: int = 0,
    gen_batch: int = 512,
    device="cuda",
    phase_seconds: Optional[Dict[str, float]] = None,
) -> None:
    """Generate all splits with the closed-loop rollout in batches of
    `gen_batch` on `device`, targets drawn from a generator seeded with
    `seed`, and save one npz.

    Stores physical-unit states (N, NT, 3) = (βp, q95, li) and actions
    (N, NT-1, 9), with the keys of the JAX function ({split}_states,
    {split}_actions), as the reference extracts them from its recorded npz
    files (outputs[:, [1, 4, 6]], tokamak/data/tokamak_dataset.py:36).
    `phase_seconds`, a dict, receives the seconds of the rollout and of the
    save."""
    t0 = time.perf_counter()
    params = load_kstar_params(device=device)
    total = n_train + n_cal + n_test
    gen = torch.Generator(device=device).manual_seed(seed)
    states, actions = [], []
    for lo in range(0, total, gen_batch):
        outs, acts, _ = closed_loop_batch(params, min(gen_batch, total - lo), gen)
        states.append(outs[:, :, [1, 4, 6]].cpu().numpy())
        actions.append(acts.cpu().numpy())
    states = np.concatenate(states)
    actions = np.concatenate(actions)
    t1 = time.perf_counter()
    save_tokamak_splits(path, states, actions, n_train, n_cal, n_test)
    if phase_seconds is not None:
        phase_seconds.update(rollout=t1 - t0, save=time.perf_counter() - t1)


def save_tokamak_splits(path: str, states: np.ndarray, actions: np.ndarray, n_train: int,
                        n_cal: int, n_test: int) -> None:
    """Save states (N, NT, 3) and actions (N, NT-1, 9) of N = n_train +
    n_cal + n_test sims as one npz, split in that order under the keys
    {split}_states, {split}_actions."""
    total = n_train + n_cal + n_test
    if len(states) != total or len(actions) != total:
        raise ValueError(f"{len(states)} states, {len(actions)} actions for {total} sims")
    splits = {
        "train": slice(0, n_train),
        "cal": slice(n_train, n_train + n_cal),
        "test": slice(n_train + n_cal, total),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        **{
            f"{k}_{name}": arr[sl]
            for k, sl in splits.items()
            for name, arr in (("states", states), ("actions", actions))
        },
    )


def stack_and_pad(states: np.ndarray, actions: np.ndarray, normalize=True) -> np.ndarray:
    """(states (N, NT, 3), actions (N, NT-1, 9)) -> (N, PAD_SIZE, 12)
    channels-last, zero padded, /SCALER (reference:
    tokamak/data/tokamak_dataset.py:34-47)."""
    n = states.shape[0]
    out = np.zeros((n, PAD_SIZE, N_STATES + N_ACTIONS), dtype=np.float32)
    out[:, :NT, :N_STATES] = states
    out[:, : NT - 1, N_STATES:] = actions
    if normalize:
        out /= SCALER
    return out


@dataclasses.dataclass
class TokamakDataset:
    """In-memory split: normalized arrays + physical-unit state targets.

    data: (N, 128, 12) normalized; state_phys: (N, 122, 3) physical units
    (the guidance/eval targets, reference: tokamak/utils/common.py:68-97;
    the target IS the recorded trajectory of the same sample).
    """

    data: np.ndarray
    state_phys: np.ndarray

    @classmethod
    def load(cls, path: str, split: str, subset: Optional[int] = None) -> "TokamakDataset":
        with np.load(path) as z:
            states = z[f"{split}_states"]
            actions = z[f"{split}_actions"]
        if subset is not None:
            states, actions = states[:subset], actions[:subset]
        return cls(data=stack_and_pad(states, actions), state_phys=states.astype(np.float32))

    @classmethod
    def load_hf(
        cls,
        path: str,
        split: str,
        n_train: int = 48950,
        n_cal: int = 1000,
        n_test: int = 50,
        subset: Optional[int] = None,
    ) -> "TokamakDataset":
        """Read the reference's HuggingFace-datasets on-disk layout.

        Rows carry `outputs` (122, 8) solver outputs and `actions` (121, 9);
        states are output columns [1, 4, 6] = (βp, q95, li). Splits are
        contiguous index ranges: train [0, 48950), cal [48950, 49950),
        test [49950, 50000) (reference: tokamak/data/tokamak_dataset.py:5-56).
        Range sizes are parameterized so smaller mirrors also load. A range
        past the last row raises IndexError, as `Dataset.select` does."""
        bounds = {
            "train": (0, n_train),
            "cal": (n_train, n_train + n_cal),
            "test": (n_train + n_cal, n_train + n_cal + n_test),
        }
        if split not in bounds:
            raise ValueError(f"split must be one of {sorted(bounds)}, got {split!r}")
        cols = arrow_ipc.load_from_disk(path, ("outputs", "actions"))
        lo, hi = bounds[split]
        if subset is not None:
            hi = min(hi, lo + subset)
        n = len(cols["outputs"])
        if hi > n:
            raise IndexError(f"rows [{lo}, {hi}) of a {n}-row dataset")
        # one rounding to float32, as the numpy format of `datasets` and the
        # JAX loader's cast do it
        actions = cols["actions"][lo:hi].astype(np.float32)
        states = cols["outputs"][lo:hi][:, :, [1, 4, 6]].astype(np.float32)
        return cls(data=stack_and_pad(states, actions), state_phys=states)

    def __len__(self) -> int:
        return self.data.shape[0]
