"""Tracing and step-timing utilities.

Port of `safediffcon_tpu/utils/profiling.py` (the reference has only ad-hoc
`time.time()` spans and tqdm bars, 1D/posttrain/post_train.py:451-468,
2d/inference_2d.py:287,384, tokamak/inference/pipeline.py:73-85): a
`torch.profiler` trace context that exports a Chrome trace (CPU and, where a
card is present, CUDA activity), a StepTimer for steps/sec accounting, and a
JSONL metrics logger (replacing the reference's tensorboardX scalars,
1D/model/trainer.py:152,175).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Record a torch.profiler trace of the block into
    `<trace_dir>/trace.json` (Chrome trace format) if trace_dir is set, else
    no-op."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("wrote profiler trace to %s", path)


class StepTimer:
    """Steps/sec + moving-average wall time per step."""

    def __init__(self, window: int = 100):
        self.window = window
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.count = 0
        self._recent = []

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.count += 1
        self._recent.append(dt)
        if len(self._recent) > self.window:
            self._recent.pop(0)
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self._recent:
            return 0.0
        return len(self._recent) / sum(self._recent)

    @property
    def total(self) -> float:
        return time.perf_counter() - self.t0


class MetricsLogger:
    """Append-only JSONL metric stream + stdlib logging mirror."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **{
            k: float(v) for k, v in metrics.items()
        }}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        log.info("step %d %s", step, " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                                              if k not in ("step", "time")))

    def close(self):
        if self._fh:
            self._fh.close()
