"""Device and host time of the GroupNorm fold and of the temporal resnet block
around it, for this tree's kernels and, with ``--tree DIR`` (the root of a
checkout of another commit, e.g. a ``git archive`` of the parent unpacked
there), for that tree's, each tree's kernels in a process of their own, in
turns: this, other, other, this.

    python -m svd_xtend_tpu_torch.scripts.bench_fold [--tree DIR] [--json PATH]

Shapes: group_norm_fold at every shape of sites.FOLD_SITES (device ms per
call in a CUDA graph, the scripts' graph_ms, beside its bound: x read once
over 3.35 TB/s), whether its (sc, sh) are the same bits in every run of
both trees (seeded inputs; a digest of the outputs), and the sum of
launches x device ms per exact video; its
host ms per call (enqueue, no synchronise) at the L0 temporal x;
fold_from_partials at that x's partials; and temporal_resnet_block at the
UNet's four levels at generate's batch 2 x 14 frames, device ms in a graph
and host ms per call. Both trees take the same calls (the entry points'
signatures did not change).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BYTES = 3.35e12
L0 = (2, 14, 2560, 320)
BLOCKS = [(2, 14, 2560, 320), (2, 14, 640, 640), (2, 14, 160, 1280), (2, 14, 40, 1280)]


def host_ms(fn, calls: int = 50) -> float:
    """Host ms per call of `fn`, enqueue only (no synchronise inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def measure(fold_shapes) -> dict:
    """This process's svd_xtend_tpu_torch (whichever tree is on the path)."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.scripts import card, graph_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g).to(torch.bfloat16)
    out = {"card": card(), "fold": [], "block": []}
    for shape in fold_shapes:
        x = rn(*shape) * 2 + 0.5
        c = shape[-1]
        sc, bi = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
        run = lambda: gn.group_norm_fold(x, sc, bi, groups=32, eps=1e-5)
        digest = hashlib.sha1(torch.cat(run()).cpu().numpy().tobytes()).hexdigest()[:16]
        out["fold"].append([list(shape), graph_ms(run), digest])
        if tuple(shape) == L0:
            out["fold_host_ms"] = host_ms(run)
            rows = math.prod(shape[1:-1])
            psum, psq = gn.channel_stats_reference(x.reshape(-1, c), rows)
            out["from_partials_ms"] = graph_ms(
                lambda: gn.fold_from_partials(psum, psq, rows, sc, bi, 32, 1e-5))
        del x
    for b, f, s, c in BLOCKS:
        x, t = rn(b, f, s, c), rn(b, f, c) * 0.5
        k1, k2 = rn(3, c, c) * (3 * c) ** -0.5, rn(3, c, c) * (3 * c) ** -0.5
        b1, b2 = rn(c) * 0.1, rn(c) * 0.1
        sc, bi = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
        w = torch.tensor([0.37], device="cuda")
        block = lambda: tr.temporal_resnet_block(x, t, k1, b1, k2, b2, sc, bi, sc, bi, w,
                                                 groups=32, eps=1e-5)
        out["block"].append([[b, f, s, c], graph_ms(block), host_ms(block, 20)])
    return out


def run_tree(root: Path, fold_shapes) -> dict:
    """measure() in a process whose svd_xtend_tpu_torch is `root`'s."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, __file__, "--child", json.dumps(fold_shapes)],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default="", help="root of another checkout to time beside")
    parser.add_argument("--json", default="", help="write the results here")
    parser.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(measure([tuple(s) for s in json.loads(args.child)])))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("this script runs on a CUDA card only")
    from svd_xtend_tpu_torch.scripts.sites import FOLD_SITES

    here = Path(__file__).resolve().parents[2]
    shapes = [list(shape) for shape, _ in FOLD_SITES]
    order = [("this", here)]
    if args.tree:
        other = Path(args.tree).resolve()
        order = [("this", here), ("other", other), ("other", other), ("this", here)]
    runs = [(name, run_tree(root, shapes)) for name, root in order]
    print(runs[0][1]["card"])
    names = sorted({name for name, _ in runs}, reverse=True)
    by = lambda who, kind: [dict((tuple(r[0]), r[1:]) for r in res[kind])
                            for name, res in runs if name == who]
    fmt = lambda vals: ", ".join(f"{v:.4f}" for v in vals)
    totals = dict.fromkeys(names, 0.0)
    print("group_norm_fold (x's shape) x launches per exact video: device ms per call, "
          + " | ".join(names) + "; bound (bytes)")
    same_bits = True
    for shape, launches in FOLD_SITES:
        row = []
        for name in names:
            vals = [d[tuple(shape)][0] for d in by(name, "fold")]
            totals[name] += launches * sum(vals) / len(vals)
            row.append(fmt(vals))
        digests = {d[tuple(shape)][1] for name in names for d in by(name, "fold")}
        same_bits &= len(digests) == 1
        bound = math.prod(shape) * 2 / PEAK_BYTES * 1e3
        print(f"  {tuple(shape)} x {launches}: {' | '.join(row)}; bound {bound:.4f} ms; "
              f"(sc, sh) the same bits in every run: {len(digests) == 1}")
    for name in names:
        host = [res["fold_host_ms"] for n, res in runs if n == name]
        part = [res["from_partials_ms"] for n, res in runs if n == name]
        print(f"  Σ launches x device ms ({name}): {totals[name]:.3f} ms per exact video; host "
              f"ms a call at {L0}: {fmt(host)}; fold_from_partials there: {fmt(part)} ms")
    print(f"  (sc, sh) the same bits in every run of every tree at every shape: {same_bits}")
    print("temporal_resnet_block (B, F, S, C): device ms in a graph; host ms a call, "
          + " | ".join(names))
    for key in BLOCKS:
        row = [f"{fmt([d[key][0] for d in by(name, 'block')])}; "
               f"{fmt([d[key][1] for d in by(name, 'block')])}" for name in names]
        print(f"  {key}: {' | '.join(row)}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(runs, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
