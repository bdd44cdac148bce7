"""The general harness: finds a cell's configuration, traffic mix, limits and
per-layer metric readers by name, runs the cell through the kind of work
its traffic names, and assembles the result line.

Data, one file each, under the benchmark's directory (`data_dir`):
  - ``configs/<config>.json``: the configuration as run (published groups
    ``unet``, ``vae``, ``image_encoder``, ``feature_extractor``,
    ``scheduler``, and ``dtype``);
  - ``traffic/<mix>.json``: ``kind`` (a module of ``benchmark/kinds/``) and
    its parameters;
  - ``limits/<cell>.json``: the limit of each number the correctness check
    compares;
  - ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record) ->
    float | None`` (None: nothing to read in this run, the metric is left
    out).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

DATA_DIR = Path(__file__).resolve().parent


@dataclass
class Record:
    """What a run measured, for the end-to-end metrics and the readers."""

    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                    # videos or steps completed in the window
    unit_flops: float = 0.0           # model operations of one unit
    peak_mem_bytes: int = 0           # max_memory_allocated over the window
    process_peak_bytes: int = 0       # the same from process start to the window's close
    spans: Optional[object] = None    # spans.Spans of the traced run
    span_units: int = 0               # units the spans covered (the window's and the profiled)
    profile: dict = field(default_factory=dict)


@dataclass
class Outcome:
    record: Record
    attempted: int
    failed: int
    checks: Dict[str, float]          # number compared -> its value


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                    # perf_counter at process start


def log(ctx: "Context", what: str) -> None:
    """A progress line on standard error: seconds since process start."""
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {what}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(data_dir: Path, metric: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", data_dir / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, group: str) -> List[dict]:
    return [m for m in spec[group] if cell in m.get("workloads", [cell])]


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, data_dir: Path = DATA_DIR) -> dict:
    """Run one cell once; returns the result line's object (with the checks
    last). Raises on a cell, file or metric it cannot find."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(data_dir / "configs" / f"{cell['config']}.json")
    if configs[cell["config"]]["file"].split("/")[-1] != f"{cell['config']}.json":
        raise SystemExit(f"configuration {cell['config']!r} names another file")
    traffic = load_json(data_dir / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(data_dir / "limits" / f"{cell_name}.json")
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx = Context(config, traffic, seed, seconds, trace, torch.device(device), t_start)
    out = kind.run(ctx)
    rec = out.record
    metrics = {}
    if trace:
        for m in cell_metrics(spec, cell_name, "per_layer"):
            value = load_reader(data_dir, m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        per_unit = rec.window_s / rec.units if rec.units else None
        e2e = {"setup_s": rec.setup_s, "peak_mem_gib": rec.peak_mem_bytes / 2 ** 30,
               "video_s": per_unit, "step_s": per_unit}
        for m in cell_metrics(spec, cell_name, "end_to_end"):
            if e2e.get(m["name"]) is None:
                raise SystemExit(f"end-to-end metric {m['name']!r} not measured")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    missing = sorted(set(out.checks) ^ set(limits))
    if missing:
        raise SystemExit(f"checks and limits differ: {missing}")
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in out.checks.items()}
    correct = out.failed == 0 and out.attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(rec.process_peak_bytes)}
    line = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if trace and rec.profile:
        device_info["busy_s"] = rec.profile["busy_s"]
        device_info["window_s"] = rec.profile["window_s"]
        line["breakdown"] = {"device_ops": rec.profile["device_ops"],
                             "idle_gaps": rec.profile["idle_gaps"]}
    line["checks"] = checks
    return line


def window(ctx: Context, one_unit, rec: Record) -> int:
    """The measured window: units back to back while under ctx.seconds, the
    last one finished; fills rec.setup_s, window_s, units and the peak.
    `one_unit(i)` runs unit i and returns once its result is in host hands."""
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: None)
    sync()
    setup_peak = 0
    if ctx.device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        one_unit(n)
        n += 1
    sync()
    rec.window_s = time.perf_counter() - t0
    rec.units = n
    if ctx.device.type == "cuda":
        rec.peak_mem_bytes = torch.cuda.max_memory_allocated(ctx.device)
    rec.process_peak_bytes = max(setup_peak, rec.peak_mem_bytes)
    return n
