"""The train step's stages on the device trace's clock, from the program's
own spans (``svd_xtend_tpu_torch/utils/profiling.py``).

The stage pass runs steps inside the program's ``recording()`` under
``torch.profiler`` with CUDA activity alone, as the first profiled pass of
``kinds/train.py`` does: the host is not traced and runs at its own speed.
Each span comes back on the profiler's clock, so every idle interval of the
device timeline (its first operation to its last) is charged to the
innermost ``train.*`` span open on the step's thread over it, split where a
span starts or ends; idle time inside no ``train.*`` span is charged to
BETWEEN. The pass also gives each step's host milliseconds by span.

``reading(metric, rec)`` reads one of READINGS from ``rec.stages`` (the
pass's result); None where the record has no pass. The cell does not run
the pass yet. To run the cell's set-up and the pass on a card:

  python3 -m benchmark.stages --seed <n>

which runs WARM steps, then PAIRS pairs of a plain device-only pass and a
stage pass (in turns, the plain one first in even pairs), and prints one
JSON line: each pair's device windows a step, the readings and the idle by
stage.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, List, Sequence, Tuple

import torch

from . import spans
from .spans import DEVICE_WORK, _merge

ROOT = Path(__file__).resolve().parents[1]
STEP = "train.step"
STAGE = "train."
SYNC = "sync."
OPTIMIZER = "train.optimizer"
BETWEEN = "(between steps)"
FWD = ("train.encode", "train.unet_loss")
BWD = ("train.backward",)
OPT = (OPTIMIZER,)
CELL = "img2vid-320p-train"
WARM = 20
PAIRS = 4

# (name, thread, parent, step, start_ns, end_ns): a span on the profiler's clock
SpanRow = Tuple[str, int, int, int, int, int]


def _stage_segments(rows: Sequence[SpanRow]) -> List[Tuple[int, int, str]]:
    """(start, end, innermost train.* span) over the step's thread (that of
    the first train.step), ordered, from the first such span's start to the
    last one's end; a segment inside none reads BETWEEN."""
    thread = next(r[1] for r in rows if r[0] == STEP)
    stages = [(r[4], r[5], r[0]) for r in rows if r[1] == thread and r[0].startswith(STAGE)]
    edges = sorted({t for a, b, _ in stages for t in (a, b)})
    out = []
    for a, b in zip(edges, edges[1:]):
        inner = [s for s in stages if s[0] <= a and b <= s[1]]
        # spans on one thread nest: the innermost is the shortest
        name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else BETWEEN
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def charge_idle(busy: Sequence[Sequence[int]], segments) -> dict:
    """Idle nanoseconds between the merged `busy` intervals (ordered), by the
    stage segment over them; parts outside every segment read BETWEEN."""
    out = {}
    k = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while a < b:
            while k < len(segments) and segments[k][1] <= a:
                k += 1
            if k == len(segments) or segments[k][0] >= b:
                name, end = BETWEEN, b
            elif segments[k][0] > a:
                name, end = BETWEEN, segments[k][0]
            else:
                name, end = segments[k][2], min(b, segments[k][1])
            out[name] = out.get(name, 0) + (end - a)
            a = end
    return out


def _work(raw, rows: Sequence[SpanRow]) -> list:
    """(start, end, name) of the device's operations; a span's device-side
    range is none, whatever kind the trace gave it (a torch whose events
    carry no kind names them by LABELS, which ``sync.*`` is not among)."""
    names = {r[0] for r in rows}
    return [(a, b, name) for a, b, name, kind in raw if kind in DEVICE_WORK and name not in names]


def reduce_stages(raw, rows: Sequence[SpanRow]) -> dict:
    """From the pass's raw device events ((start_ns, end_ns, name, kind), as
    ``spans.raw_events`` gives them) and its spans: steps, window_ms,
    busy_ms, idle_ms, idle_ms_by (stage -> ms; BETWEEN for none), and per
    step host_ms (span name -> summed ms), sync_ms (the step's sync.* spans)
    and opt_less_sync_ms (train.optimizer less its sync.* children). Empty
    where the trace holds no device work or the spans no train.step."""
    dev = [(a, b) for a, b, _ in _work(raw, rows)]
    steps = sorted({r[3] for r in rows if r[0] == STEP})
    if not dev or not steps:
        return {}
    busy = _merge(dev)
    busy_ns = sum(b - a for a, b in busy)
    idle = charge_idle(busy, _stage_segments(rows))
    host_ms, sync_ms, opt_ms = [], [], []
    for k in steps:
        mine = [r for r in rows if r[3] == k]
        ms = {}
        for r in mine:
            ms[r[0]] = ms.get(r[0], 0.0) + (r[5] - r[4]) / 1e6
        in_opt = sum((r[5] - r[4]) / 1e6 for r in mine
                     if r[0].startswith(SYNC) and r[2] >= 0 and rows[r[2]][0] == OPTIMIZER)
        host_ms.append(ms)
        sync_ms.append(sum(v for n, v in ms.items() if n.startswith(SYNC)))
        opt_ms.append(ms.get(OPTIMIZER, 0.0) - in_opt)
    return {"steps": len(steps), "window_ms": (busy[-1][1] - busy[0][0]) / 1e6,
            "busy_ms": busy_ns / 1e6, "idle_ms": sum(idle.values()) / 1e6,
            "idle_ms_by": {n: v / 1e6 for n, v in sorted(idle.items())},
            "host_ms": host_ms, "sync_ms": sync_ms, "opt_less_sync_ms": opt_ms}


def _idle(p: dict, names) -> float:
    return sum(p["idle_ms_by"].get(n, 0.0) for n in names) / p["steps"]


READINGS = {
    "bwd_host_ms.train": lambda p: statistics.median(h.get("train.backward", 0.0)
                                                     for h in p["host_ms"]),
    "opt_host_ms.train": lambda p: statistics.median(p["opt_less_sync_ms"]),
    "sync_wait_ms.train": lambda p: statistics.median(p["sync_ms"]),
    "idle_fwd_ms.train": lambda p: _idle(p, FWD),
    "idle_bwd_ms.train": lambda p: _idle(p, BWD),
    "idle_opt_ms.train": lambda p: _idle(p, OPT),
}


def reading(metric: str, rec):
    """READINGS[metric] of the record's stage pass; None without one."""
    p = getattr(rec, "stages", None)
    if rec.kind != "train" or not p:
        return None
    return READINGS[metric](p)


def stage_pass(fn: Callable) -> dict:
    """Run `fn` inside the program's ``recording()`` under ``torch.profiler``
    (CUDA activity alone; events in memory, synchronised at both ends) and
    reduce it (``reduce_stages``). Empty where the program records no
    spans."""
    from torch.profiler import ProfilerActivity, profile

    try:
        from svd_xtend_tpu_torch.utils.profiling import recording
    except ImportError:
        return {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as rec:
            fn()
            torch.cuda.synchronize()
    rows = [(s.name, s.thread, s.parent, s.step, *rec.on_profiler_clock(s))
            for s in rec.spans]
    raw = spans.raw_events(prof.profiler.kineto_results.events())
    out = reduce_stages(raw, rows)
    if out:
        # the clocks' agreement: no device work starts before the first step opens
        t0 = min(r[4] for r in rows if r[0] == STEP)
        a, _, name = min(_work(raw, rows))
        out["first_op_after_step_ms"], out["first_op"] = (a - t0) / 1e6, name[:80]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The train cell's set-up, then plain "
                                             "device-only passes and stage passes in turn.")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    from svd_xtend_tpu_torch.core.config import TrainConfig
    from svd_xtend_tpu_torch.diffusion import training as port_training

    from . import harness
    from .kinds import train as kind

    t_start = time.perf_counter()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next(c for c in spec["workloads"] if c["name"] == CELL)
    cfg = harness.load_json(harness.DATA_DIR / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.DATA_DIR / "traffic" / f"{cell['traffic']}.json")
    dev = torch.device("cuda")
    tc = TrainConfig(**traffic["train"])
    models, state, step = kind.program(cfg, tc, args.seed, dev)
    pool = kind.batches(args.seed, tc, cfg, traffic["pool"], dev)
    box, count = {"state": state}, [0]

    def steps(n):
        for _ in range(n):
            pixels, draws = pool[count[0] % len(pool)]
            box["state"], _ = step(box["state"], pixels,
                                   draws=port_training.TrainDraws(**draws))
            count[0] += 1

    steps(WARM)
    torch.cuda.synchronize()
    pairs = []
    for k in range(PAIRS):
        # the two passes in turns: the plain one first in even pairs
        if k % 2:
            staged = stage_pass(lambda: steps(kind.PROFILED))
        plain = spans.profiled(lambda: steps(kind.PROFILED), host=False)
        if not k % 2:
            staged = stage_pass(lambda: steps(kind.PROFILED))
        plain_ms = 1e3 * plain["window_s"] / kind.PROFILED
        staged_ms = staged["window_ms"] / staged["steps"]
        pairs.append({
            "plain_first": not k % 2, "plain_window_ms_a_step": plain_ms,
            "stage_window_ms_a_step": staged_ms,
            "on_cost_pct": 100.0 * (staged_ms / plain_ms - 1.0),
            "plain_idle_pct": 100.0 * (1.0 - plain["busy_s"] / plain["window_s"]),
            "readings": {m: f(staged) for m, f in READINGS.items()},
            "idle_ms_a_step": staged["idle_ms"] / staged["steps"],
            "idle_ms_by_a_step": {n: v / staged["steps"] for n, v in
                                  staged["idle_ms_by"].items()},
            "first_op_after_step_ms": staged["first_op_after_step_ms"],
            "first_op": staged["first_op"],
            "host_ms": staged["host_ms"]})
    device = torch.cuda.get_device_name(dev)
    print(json.dumps({"workload": CELL, "seed": args.seed, "device": device,
                      "seconds": time.perf_counter() - t_start, "pairs": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
