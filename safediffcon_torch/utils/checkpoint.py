"""Checkpoints of the training and fine-tuning state, in the port's own
format: one `torch.save` file per milestone or epoch, written atomically.

Port of `safediffcon_tpu/utils/checkpoint.py` (reference: torch.save
milestone dicts, 1D/model/trainer.py:111-148; the conformal quantile beside
the weights, 2d/inference_2d.py:381-382). The JAX package writes orbax
directories, which only JAX reads; the two formats do not interchange (the
weight bridge `models/convert.py` carries weights across).

  ckpt-<step>.pt   save_checkpoint: {"step", "params", "opt_state",
                   "ema_params"[, "Q"]}; save_phase_state: {"params",
                   "opt_state", "Q", "epoch"}; save_finetuned: {"params", "Q",
                   "step"}. "params" and "ema_params" are state_dicts,
                   "opt_state" an `AdamState.state_dict()`.
  history.json     save_phase_history: the epoch records and a config
                   fingerprint.

Under a process group only rank 0 writes, and every rank waits at a barrier
after each write, so a rank that reads next finds the file; every rank
reads.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional

import torch

from safediffcon_torch.parallel import mesh as pmesh


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"ckpt-{step}.pt")


def _save(path: str, payload) -> str:
    """Write `payload()` to `path` atomically, on rank 0 only."""
    if pmesh.is_writer():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload(), tmp)
        os.replace(tmp, path)
    pmesh.barrier()
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _cpu(tree):
    """A copy of a nest of dicts/lists/tuples of tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(directory: str, state, step: int, Q: Optional[Any] = None) -> str:
    """Save a `core.train.TrainState` (+ optional conformal quantile) at a
    milestone."""
    def payload():
        out = _cpu(state.state_dict())
        if Q is not None:
            out["Q"] = float(Q)
        return out

    return _save(_ckpt_path(directory, step), payload)


def load_checkpoint(directory: str, step: int) -> dict:
    """The payload of `save_checkpoint`, tensors on the CPU
    (`TrainState.load_state_dict` takes it)."""
    return _load(_ckpt_path(directory, step))


def load_phase_trainstate(directory: str, state, epoch: Optional[int] = None):
    """Restore the latest (or the given) epoch of a TrainState-based phase,
    saved by `save_checkpoint(directory, state, step=epoch, Q=Q)`, into
    `state` in place. Returns (state, Q, epoch), or None when the directory
    holds no state."""
    if epoch is None:
        epoch = latest_step(directory)
        if epoch is None:
            return None
    payload = load_checkpoint(directory, epoch)
    state.load_state_dict(payload)
    return state, payload["Q"], int(epoch)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("ckpt-") and name.endswith(".pt"):
            try:
                steps.append(int(name[len("ckpt-"):-len(".pt")]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_phase_state(directory: str, params, opt_state, Q, epoch: int) -> str:
    """Persist a fine-tuning epoch's state (weights, optimizer moments,
    Q-hat) so a posttrain/InfFT run resumes after a crash mid-phase.
    `params` is a state_dict, `opt_state` an `AdamState`."""
    return _save(_ckpt_path(directory, epoch), lambda: {
        "params": _cpu(dict(params)), "opt_state": _cpu(opt_state.state_dict()),
        "Q": float(Q), "epoch": int(epoch)})


def load_phase_state(directory: str, epoch: Optional[int] = None):
    """(params state_dict, opt_state dict, Q, epoch) of the latest (or the
    given) epoch, or None when the directory holds no state."""
    if epoch is None:
        epoch = latest_step(directory)
        if epoch is None:
            return None
    payload = _load(_ckpt_path(directory, epoch))
    return payload["params"], payload["opt_state"], payload["Q"], int(payload["epoch"])


def save_phase_history(directory: str, history, config_repr: Optional[str] = None) -> str:
    """Atomically persist the epoch-metrics history (and a config
    fingerprint) beside the phase state, so a resumed run returns the full
    metrics list and a config mismatch is detectable."""
    path = os.path.join(directory, "history.json")
    if pmesh.is_writer():
        os.makedirs(directory, exist_ok=True)
        payload = {"history": history}
        if config_repr is not None:
            payload["config"] = config_repr
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=float)
        os.replace(tmp, path)
    pmesh.barrier()
    return path


def load_phase_history(directory: str, max_epoch: Optional[int] = None,
                       config_repr: Optional[str] = None):
    """The history written by `save_phase_history` (empty when absent or
    unreadable); warns when it was written under another config."""
    path = os.path.join(directory, "history.json")
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            payload = json.load(f)
    except (json.JSONDecodeError, OSError):
        return []
    if config_repr is not None and payload.get("config") not in (None, config_repr):
        logging.getLogger(__name__).warning(
            "phase state in %s was written under a different config:\n"
            "  saved: %s\n  now:   %s", directory, payload.get("config"), config_repr)
    hist = payload.get("history", [])
    if max_epoch is not None:
        hist = [h for h in hist if h.get("epoch", 0) <= max_epoch]
    return hist


def save_finetuned(directory: str, params, Q, step: int = 0) -> str:
    """Save a fine-tuned model (state_dict + conformal quantile), the
    SafeDiffCon checkpoint convention (reference: 2d/inference_2d.py:381-382)."""
    return _save(_ckpt_path(directory, step), lambda: {
        "params": _cpu(dict(params)), "Q": float(Q), "step": int(step)})
