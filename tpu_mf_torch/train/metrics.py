"""Structured metrics and profiling (counterpart of ``tpu_mf/train/metrics.py``,
which cannot be imported without JAX).

The reference's per-epoch line ``iter#N <time> tRMSE=<x>`` (src/mf.h:35) is
printed by the training loop; this module adds JSONL metrics with update
throughput, and a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics with throughput accounting."""

    def __init__(self, path: str):
        self._fh = open(path, "a")
        self._t0 = time.perf_counter()
        self._updates = 0

    def count_updates(self, n: int) -> None:
        self._updates += int(n)

    @property
    def updates_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._updates / dt if dt > 0 else 0.0

    def log(self, **fields) -> None:
        fields.setdefault("t", round(time.perf_counter() - self._t0, 6))
        if self._updates:
            fields.setdefault("updates_per_sec", round(self.updates_per_sec))
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace into ``logdir/trace.json``
    (Chrome trace format) when logdir is set; CUDA activity is recorded
    when a GPU is present."""
    if not logdir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
