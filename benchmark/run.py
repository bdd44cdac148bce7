"""Run one cell of the benchmark once, on the card this process is given.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number the correctness check compared beside its
limit; the checks are also the last lines of standard error.

Exits with another code than 0 and prints no result when there is no CUDA
card, fewer cards than the cell asks for, or when ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed. The
program's kernel library builds into its own ``_build/`` in the checkout
(the first run of a checkout compiles it); the profiler keeps its events
in memory.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter() at this process's start (Linux /proc), or now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "svd_xtend_tpu")
ROOT = Path(__file__).resolve().parents[1]


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (by default the loaded
    modules'), each compared whole: the part before the first dot."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
