"""Device-fault handling for the fine-tuning phases on a CUDA card.

Port of `safediffcon_tpu/utils/faults.py`. The JAX module survives a lost
TPU worker inside the process: it drops the dead PJRT client, reconnects and
re-enters the phase with a fresh pipeline, which resumes from the epoch state
in its `state_dir`. CUDA errors fall into two classes, and only one of them
can be retried inside the process:

  - sticky: the error leaves the CUDA context unusable, and every later CUDA
    call of the process fails (an illegal address, an unspecified launch
    failure, an uncorrectable ECC or NVLink error, a device-side assert, a
    misaligned address, an illegal instruction or program counter, a
    hardware stack error, a launch that timed out, an unknown error). The
    context cannot be re-created in the process, so no retry can succeed:
    `retry_on_device_fault` re-raises at once, and its log line names the
    `state_dir` from which a new process resumes bit-identically (the
    command line's `--resume`).
  - recoverable: the call failed and the context is still usable (the
    device was busy or unavailable, the system was not yet initialised, a
    wait timed out). These are retried after a back-off with a fresh
    pipeline, which resumes from `state_dir`.

Out-of-memory is not a device fault, as in JAX: it propagates at once, like
every program error. Nothing falls back to the CPU.

Under a process group of more than one rank no fault is retried: the
faulting rank re-raises at once and exits non-zero, and its launcher
(torchrun, or the command line's own spawner) then stops every other rank,
which would otherwise wait for it in a collective. `--resume` restarts them
all from the last saved state.

`fault_kind` recognises torch's CUDA runtime errors: `torch.AcceleratorError`
where torch raises it (2.11 on), a RuntimeError whose message starts
"CUDA error: " (older torch), and the kernel wrappers' "CUDA error <code>"
(`ops/pressure_cg.py`, `ops/conv3d_mxu.py`) for the cudaError_t codes below.
"""
from __future__ import annotations

import logging
import re
import time
from typing import Callable, Optional, TypeVar

import torch

from safediffcon_torch.parallel import mesh as pmesh

log = logging.getLogger(__name__)

T = TypeVar("T")

# cudaGetErrorString texts and cudaError_t codes of each class
_STICKY_PHRASES = (
    "an illegal memory access",        # 700 cudaErrorIllegalAddress
    "the launch timed out",            # 702 cudaErrorLaunchTimeout
    "device-side assert triggered",    # 710 cudaErrorAssert
    "hardware stack error",            # 714
    "an illegal instruction",          # 715
    "misaligned address",              # 716
    "not supported on global/shared address space",  # 717
    "invalid program counter",         # 718
    "unspecified launch failure",      # 719 cudaErrorLaunchFailure
    "uncorrectable ECC error",         # 214 cudaErrorECCUncorrectable
    "uncorrectable NVLink error",      # 220 cudaErrorNvlinkUncorrectable
    "unknown error",                   # 999 cudaErrorUnknown
)
_STICKY_CODES = frozenset({214, 220, 700, 702, 710, 714, 715, 716, 717, 718, 719, 999})
_RECOVERABLE_PHRASES = (
    "busy or unavailable",             # 46 cudaErrorDevicesUnavailable
    "system not yet initialized",      # 802 cudaErrorSystemNotReady
    "wait operation timed out",        # 909 cudaErrorTimeout
)
_RECOVERABLE_CODES = frozenset({46, 802, 909})
_CODE_RE = re.compile(r"CUDA error (\d+)")


def fault_kind(exc: BaseException) -> Optional[str]:
    """"sticky", "recoverable", or None for anything that is not a CUDA
    device fault (out-of-memory, program errors, other exceptions)."""
    if not isinstance(exc, RuntimeError) or isinstance(exc, torch.OutOfMemoryError):
        return None
    msg = str(exc)
    if "out of memory" in msg:
        return None
    m = _CODE_RE.search(msg)
    code = int(m.group(1)) if m else None
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if not (code is not None or msg.startswith("CUDA error: ")
            or (accelerator_error is not None and isinstance(exc, accelerator_error))):
        return None
    if code in _STICKY_CODES or any(p in msg for p in _STICKY_PHRASES):
        return "sticky"
    if code in _RECOVERABLE_CODES or any(p in msg for p in _RECOVERABLE_PHRASES):
        return "recoverable"
    return None


def is_device_fault(exc: BaseException) -> bool:
    """True when `exc` is a CUDA device fault of either class."""
    return fault_kind(exc) is not None


def resilient_phase(
    make_pipeline,
    run: Callable,
    params,
    retries: int = 2,
    backoff_s: float = 30.0,
    describe: str = "phase",
    state_dir: Optional[str] = None,
):
    """Run a fine-tuning phase, `run(pipeline, params_host)`, with
    device-fault handling: the weights are copied to the host once, and each
    attempt builds a fresh pipeline from `make_pipeline()`. A phase with
    `state_dir` resumes from the last persisted epoch; one without replays
    from epoch 0. See `retry_on_device_fault` for what is retried."""
    from safediffcon_torch.utils.checkpoint import _cpu

    params_host = _cpu(params)
    return retry_on_device_fault(
        lambda: run(make_pipeline(), params_host),
        retries=retries, backoff_s=backoff_s, describe=describe, state_dir=state_dir)


def retry_on_device_fault(
    fn: Callable[[], T],
    retries: int = 2,
    backoff_s: float = 30.0,
    describe: str = "phase",
    state_dir: Optional[str] = None,
) -> T:
    """Run `fn()`; re-call it after a recoverable device fault, at most
    `retries` times, and re-raise the last one after that. A sticky fault is
    re-raised at once, with a log line that says where a new process resumes;
    any other exception propagates at once. Under a process group of more
    than one rank every device fault is re-raised at once."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered by fault_kind
            kind = fault_kind(e)
            if kind is None:
                raise
            first = str(e).splitlines()[0][:200]
            if pmesh.world_size() > 1:
                log.error("%s: %s CUDA fault on rank %d of %d (%s); no rank retries alone, so "
                          "every rank stops: run the command again with --resume%s", describe,
                          kind, pmesh.rank(), pmesh.world_size(), first,
                          f" to continue from {state_dir}" if state_dir else "")
                raise
            if kind == "sticky":
                where = (f"run it again with --resume to continue from {state_dir}"
                         if state_dir else "it has no state_dir, so a new run starts at epoch 0")
                log.error("%s: sticky CUDA fault, the context is lost for this process (%s); "
                          "%s", describe, first, where)
                raise
            if attempt == retries:
                raise
            log.warning("%s: recoverable CUDA fault (attempt %d/%d): %s — resuming with a "
                        "fresh pipeline from %s in %.0f s", describe, attempt + 1, retries,
                        first, state_dir or "epoch 0", backoff_s)
            time.sleep(backoff_s)
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
    raise AssertionError("unreachable")
