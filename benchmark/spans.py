"""The benchmark's own spans and the device trace of the traced run.

Spans are taken from the benchmark's files around the program's calls: a
module's forward pre- and post-hooks, or a module function of the program
replaced by a wrapper for the traced run. Each span records the host clock
(perf_counter) and, on the card, a CUDA event pair on the current stream,
read once the window has closed. Under ``torch.profiler`` each span is also a
``record_function`` range named after it, so the trace's idle gaps can be
told by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


class Spans:
    """Named spans: host milliseconds, device events, and per-call costs."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host_ms: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, list] = defaultdict(list)
        self.cost: Dict[str, List[tuple]] = defaultdict(list)   # (flops, bytes) per call
        self._undo: List[Callable] = []

    @contextlib.contextmanager
    def span(self, name: str, cost: Optional[tuple] = None):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        start = torch.cuda.Event(enable_timing=True) if self.cuda else None
        if start is not None:
            start.record()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host_ms[name].append(1e3 * (time.perf_counter() - t))
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._events[name].append((start, end))
            if cost is not None:
                self.cost[name].append(cost)
            rf.__exit__(None, None, None)

    def on_module(self, name: str, module: torch.nn.Module,
                  cost: Optional[Callable] = None) -> None:
        """A span around every call of `module`; `cost(args)` gives the call's
        (operations, bytes)."""
        state = {}

        def pre(_, args):
            cm = self.span(name, cost(args) if cost is not None else None)
            cm.__enter__()
            state.setdefault("open", []).append(cm)

        def post(*_):
            state["open"].pop().__exit__(None, None, None)

        handles = [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
        self._undo.append(lambda: [h.remove() for h in handles])

    def on_function(self, name: str, owner, attr: str,
                    cost: Optional[Callable] = None) -> None:
        """A span around every call of ``owner.attr`` (a module-level function
        of the program, looked up by name at each call)."""
        inner = getattr(owner, attr)

        def wrapped(*args, **kw):
            with self.span(name, cost(args) if cost is not None else None):
                return inner(*args, **kw)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, inner))

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def device_ms(self, name: str) -> List[float]:
        """Each call's device milliseconds (call after a synchronize)."""
        return [s.elapsed_time(e) for s, e in self._events.get(name, [])]


# -- the device trace --

def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


SMALL_GAP_US = 10.0


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_WORK = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def profiled(fn: Callable, label: str = "bench.profiled", host: bool = True) -> dict:
    """Run `fn` under ``torch.profiler`` (CUDA activity, and with `host` the
    host's too; events kept in memory, synchronised at both ends) and reduce
    its raw trace (``reduce_trace``). Without `host` the host runs at nearly
    its own speed, the span is the device's first operation to its last, and
    no idle gap is named."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(label):
            fn()
        torch.cuda.synchronize()
    return reduce_trace(raw_events(prof.profiler.kineto_results.events()), label,
                        host=host)


LABELS = ("bench.", "unet.", "train.", "vae.")


def raw_events(events) -> list:
    """(start_ns, end_ns, name, activity_type) of kineto's raw events. Where a
    torch's events carry no activity type: a device event that shares its
    name with a host event is the device-side copy of a ``record_function``
    range, as is one whose name carries one of LABELS, any other a kernel; a
    host event is a user annotation when a device event shares its name or
    its name carries one of LABELS."""
    from torch.autograd import DeviceType

    rows = []
    for e in events:
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        rows.append((start, end, e.name(), kind, e.device_type() == DeviceType.CPU))
    host = {name for _, _, name, _, cpu in rows if cpu}
    device = {name for _, _, name, _, cpu in rows if not cpu}
    out = []
    for start, end, name, kind, cpu in rows:
        if kind is None and cpu:
            kind = "user_annotation" if name in device or name.startswith(LABELS) else "cpu_op"
        elif kind is None:
            kind = "gpu_user_annotation" if name in host or name.startswith(LABELS) else "kernel"
        out.append((start, end, name, kind))
    return out


def reduce_trace(raw, label: str, host: bool = True) -> dict:
    """From (start_ns, end_ns, name, activity_type) events: busy_s (the union
    of the device's kernel, copy and memset intervals), window_s (from the
    start of the `label` range on the host to the end of its last device
    operation), device_ops (the 10 kernels by total device seconds) and
    idle_gaps (idle device seconds by what the host was doing: the innermost
    host operation over the gap, under its innermost labelled range; gaps
    under SMALL_GAP_US together). Empty when the trace holds no device work.
    Without `host` (a trace of the device alone) the window is the device's
    first operation to its last, and idle_gaps is empty."""
    if not host:
        dev = [(a, b) for a, b, _, kind in raw if kind in DEVICE_WORK]
        if not dev:
            return {}
        raw = [(min(a for a, _ in dev), max(b for _, b in dev), label, "user_annotation")] + [
            e for e in raw if e[3] in DEVICE_WORK]
    top = [e for e in raw if e[2] == label and e[3] == "user_annotation"]
    if not top:
        return {}
    w0, w1 = top[0][0], top[0][1]
    dev = [(a, b, name) for a, b, name, kind in raw if kind in DEVICE_WORK and b > w0]
    busy = _merge([(max(a, w0), b) for a, b, _ in dev])
    if not busy:
        return {}
    w1 = max(w1, busy[-1][1])
    by_kernel = defaultdict(float)
    for a, b, name in dev:
        by_kernel[name[:160]] += (b - a) / 1e9
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]

    host = sorted((a, b, name, kind == "user_annotation") for a, b, name, kind in raw
                  if kind in HOST_WORK and name != label and b > w0)
    ranges = [h for h in host if h[3]]
    starts, range_starts = [h[0] for h in host], [h[0] for h in ranges]

    def innermost(seq, seq_starts, t):
        best = None
        k = bisect.bisect_right(seq_starts, t)
        for h in reversed(seq[max(0, k - 400):k]):
            if h[1] >= t and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        return best

    gaps = defaultdict(float)
    small = f"(gaps under {SMALL_GAP_US:g} us)"
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SMALL_GAP_US * 1e3:
            gaps[small] += (b - a) / 1e9
            continue
        mid = (a + b) / 2
        op, rng = innermost(host, starts, mid), innermost(ranges, range_starts, mid)
        parts = [h[2] for h in (rng, op) if h is not None]
        if op is not None and op is rng:
            parts = parts[:1]
        gaps[(" > ".join(parts) or "(host idle)")[:160]] += (b - a) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10] if host else []
    return {"busy_s": sum(b - a for a, b in busy) / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
