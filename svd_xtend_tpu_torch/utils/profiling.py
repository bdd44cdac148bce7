"""Tracing and per-step timing.

Port of ``svd_xtend_tpu/utils/profiling.py``: ``trace(logdir)`` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity) and
writes it as a Chrome trace into logdir; ``block_on(x)`` waits for the
device x lives on; ``StepTimer`` measures steps per second with a device
synchronisation every ``sync_every`` steps (one each step would serialise
the host's dispatch with the device).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block, written to
    ``logdir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def block_on(x) -> float:
    """Wait for the work that produces x (a tensor, or a number) and return
    the sum of its values as a float."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x.float().sum())
    return float(x)


class StepTimer:
    """Wall-clock steps per second, with the device synchronised every
    `sync_every` steps."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self._t0: Optional[float] = None
        self._steps = 0
        self.last_steps_per_sec = 0.0

    def update(self, sync_value=None) -> Dict[str, float]:
        self._steps += 1
        if self._steps % self.sync_every:
            return {}
        if sync_value is not None:
            block_on(sync_value)
        now = time.perf_counter()
        if self._t0 is not None:
            self.last_steps_per_sec = self.sync_every / (now - self._t0)
        self._t0 = now
        return {"steps_per_sec": self.last_steps_per_sec}
