"""Device time of the frame attention and of group_norm_silu at every shape
of the main paths, for this tree's kernels and, with ``--tree DIR`` (the root
of a checkout of another commit, e.g. a ``git archive`` of the parent
unpacked there), for that tree's, each tree's kernels in a process of their
own, in turns: this, other, other, this.

    python -m svd_xtend_tpu_torch.scripts.bench_frame_gn [--tree DIR] [--json PATH]

Shapes: the frame attention at the UNet's four levels, generate's CFG batch
2 x 14 frames and the train step's 1 x 14; group_norm_silu at every site of
sites.GN_SITES. Each is device ms per launch in a CUDA graph (the scripts'
graph_ms), beside its bound (bytes: inputs once, outputs once, over 3.35
TB/s). The sums of launches x device ms per exact video and per train step
take GN_SITES's launches, and for the frame attention those of the UNet's
transformer norms (one frame attention per transformer model).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES = 3.35e12
FRAMES = 14
# (batch, tokens S, heads) of the frame attention: generate's CFG pair, then
# the train step
FRAME_LEVELS = [(b, s, h) for b in (2, 1)
                for s, h in ((2560, 5), (640, 10), (160, 20), (40, 20))]


def measure(gn_sites) -> dict:
    """This process's svd_xtend_tpu_torch (whichever tree is on the path):
    device ms of both kernels at each shape."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.scripts import card, graph_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g).to(torch.bfloat16)
    out = {"card": card(), "frame": [], "gn": []}
    for b, s, h in FRAME_LEVELS:
        q, k, v = (rn(b, FRAMES, s, h * 64) for _ in range(3))
        out["frame"].append([b, s, h, graph_ms(
            lambda: ta.frame_attention(q, k, v, num_heads=h, scale=0.125))])
    for shape, silu, eps in gn_sites:
        x = rn(*shape) * 3 + 1
        c = shape[-1]
        sc, bi = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
        out["gn"].append([shape, silu, graph_ms(
            lambda: gn.group_norm_silu(x, sc, bi, groups=32, eps=eps, silu=silu))])
        del x
    return out


def run_tree(root: Path, gn_sites) -> dict:
    """measure() in a process whose svd_xtend_tpu_torch is `root`'s."""
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, __file__, "--child", json.dumps(gn_sites)],
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
        print(json.dumps(measure([(tuple(s), silu, eps)
                                  for s, silu, eps in json.loads(args.child)])))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("this script runs on a CUDA card only")
    from svd_xtend_tpu_torch.scripts.sites import GN_SITES

    here = Path(__file__).resolve().parents[2]
    gn_sites = sorted({st[:3] for st in GN_SITES})
    order = [("this", here)]
    if args.tree:
        other = Path(args.tree).resolve()
        order = [("this", here), ("other", other), ("other", other), ("this", here)]
    runs = [(name, run_tree(root, gn_sites)) for name, root in order]
    print(runs[0][1]["card"])

    def ms(kind, key, who):
        return [dict(((tuple(r[:-1]) if kind == "frame" else (tuple(r[0]), r[1])), r[-1])
                     for r in res[kind])[key] for name, res in runs if name == who]

    names = sorted({name for name, _ in runs}, reverse=True)
    fmt = lambda vals: ", ".join(f"{v:.4f}" for v in vals)
    totals = {(name, unit): 0.0 for name in names for unit in ("video", "step")}
    print("frame attention (B, F, S, H*64): device ms per launch, " + " | ".join(names))
    for b, s, h in FRAME_LEVELS:
        # the transformer norm at this level: (B*F, H, W, C), H*W = S, no SiLU
        site = next(st for st in GN_SITES if not st[1] and st[0][0] == b * FRAMES
                    and st[0][-1] == h * 64 and math.prod(st[0][1:-1]) == s)
        bound = 4 * b * FRAMES * s * h * 64 * 2 / PEAK_BYTES * 1e3
        row = [fmt(ms("frame", (b, s, h), name)) for name in names]
        for name in names:
            mean = sum(ms("frame", (b, s, h), name)) / len(ms("frame", (b, s, h), name))
            totals[(name, "video")] += site[3] * mean
            totals[(name, "step")] += site[4] * mean
        print(f"  {(b, FRAMES, s, h * 64)}: {' | '.join(row)}; bound {bound:.4f} ms; "
              f"launches per video / step {site[3]} / {site[4]}")
    for name in names:
        print(f"  Σ launches x device ms ({name}): {totals[(name, 'video')]:.3f} ms per exact "
              f"video, {totals[(name, 'step')]:.3f} ms per train step")
    totals = {(name, unit): 0.0 for name in names for unit in ("video", "step")}
    print("group_norm_silu (shape, silu): device ms per launch, " + " | ".join(names))
    for shape, silu, eps in gn_sites:
        video = sum(st[3] for st in GN_SITES if st[:2] == (shape, silu))
        step = sum(st[4] for st in GN_SITES if st[:2] == (shape, silu))
        bound = 2 * math.prod(shape) * 2 / PEAK_BYTES * 1e3
        row = [fmt(ms("gn", (tuple(shape), silu), name)) for name in names]
        for name in names:
            vals = ms("gn", (tuple(shape), silu), name)
            totals[(name, "video")] += video * sum(vals) / len(vals)
            totals[(name, "step")] += step * sum(vals) / len(vals)
        print(f"  {shape} silu={silu}: {' | '.join(row)}; bound {bound:.4f} ms; launches per "
              f"video / step {video} / {step}")
    for name in names:
        print(f"  Σ launches x device ms ({name}): {totals[(name, 'video')]:.3f} ms per exact "
              f"video, {totals[(name, 'step')]:.3f} ms per train step")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(runs, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
