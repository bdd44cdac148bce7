"""Tracing, and the port's spans.

Port of ``svd_xtend_tpu/utils/profiling.py``: ``trace(logdir)`` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity) and
writes it as a Chrome trace into logdir; ``block_on(x)`` waits for the
device x lives on.

The one place where the port records spans. ``span(name)`` is a
``torch.profiler.record_function`` range, so a profiler that traces the host
sees it by name. Inside ``recording()`` it also keeps the span in memory:
its name, thread, parent (the innermost open span on its thread), the
``train.step`` it belongs to, and its start and end on the host's
``perf_counter_ns`` clock, which the recording converts to the profiler's
clock (Unix nanoseconds, the base of kineto's ``start_ns()``). Recording is
off unless ``recording()`` is open; then a span costs one look at a module
global on top of its ``record_function``. ``read(name, t)`` is how the port
reads a device value: ``t.item()`` under ``span(name)``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch

STEP = "train.step"     # the span around one call of a train step


@dataclass(slots=True)
class Span:
    """One recorded span; times on the host's perf_counter_ns clock, the end
    -1 while it is open, `parent` and `step` -1 where there is none."""

    name: str
    thread: int
    parent: int
    step: int
    start_ns: int
    end_ns: int = -1


class Recording:
    """The spans kept while ``recording()`` is open, in the order they
    opened, and the offset from perf_counter_ns to the profiler's clock,
    taken once when the recording starts."""

    def __init__(self):
        self.spans: List[Span] = []
        self.offset_ns = _clock_offset_ns()
        self.steps = 0                   # train.step spans opened so far
        self._step = -1                  # the open train.step's ordinal
        self._open = {}                  # thread -> stack of open span indices
        self._lock = threading.Lock()

    def on_profiler_clock(self, s: Span) -> Tuple[int, int]:
        """(start, end) of `s` in the profiler's Unix nanoseconds."""
        return s.start_ns + self.offset_ns, s.end_ns + self.offset_ns

    def _enter(self, name: str) -> int:
        thread = threading.get_ident()
        with self._lock:
            stack = self._open.setdefault(thread, [])
            if name == STEP:
                self._step, self.steps = self.steps, self.steps + 1
            i = len(self.spans)
            self.spans.append(Span(name, thread, stack[-1] if stack else -1, self._step,
                                   time.perf_counter_ns()))
            stack.append(i)
        return i

    def _exit(self, i: int) -> None:
        s = self.spans[i]
        s.end_ns = time.perf_counter_ns()
        with self._lock:
            self._open[s.thread].pop()
            if s.name == STEP:
                self._step = -1


def _clock_offset_ns(pairs: int = 5) -> int:
    """time_ns() - perf_counter_ns(), from the tightest of a few readings
    (the profiler's clock is the wall clock in Unix nanoseconds)."""
    best = None
    for _ in range(pairs):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall - (p0 + (p1 - p0) // 2))
    return best[1]


_RECORDING: Optional[Recording] = None


class _Recorded:
    """A span while a recording is open: the record_function range, and the
    span kept inside it."""

    __slots__ = ("rec", "name", "rf", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self.i)
        return self.rf.__exit__(*exc)


def span(name: str):
    """A context manager: the ``record_function`` range `name`, and the
    span kept while a recording is open."""
    rec = _RECORDING
    return torch.profiler.record_function(name) if rec is None else _Recorded(rec, name)


def read(name: str, t: torch.Tensor):
    """``t.item()`` under ``span(name)``: a device value read by the host."""
    with span(name):
        return t.item()


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Keep every span opened inside the block; yields the Recording."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("a recording is already open")
    _RECORDING = Recording()
    try:
        yield _RECORDING
    finally:
        _RECORDING = None


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
