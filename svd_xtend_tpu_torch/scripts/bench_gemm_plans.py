"""The launch plans of the shared GEMM mainloop against their alternatives, on
the card: device time per launch (a CUDA graph) of conv3x3 at the UNet's
sites (CFG batch 28), its dU at the train step's shapes (batch 14), and
GEGLU at its eight (T, C) shapes, each under the plan the wrapper picks
and under every other (tile width, K slices up to 4) the kernels take,
beside F.conv2d alone or the unfused module path; and the int8 GEMM
(ops/kernels/int8_gemm.py) at every int8 site (the UNet's Conv3x3 sites at
CFG batch 28, the VAE decoder's at a chunk of 8 frames, a CFG pass's
QLinear sites) under the model's plan, every plan of the wgmma kernels (K
tiles of 64 and 128 codes, tile widths, K slices) and the mma.sync kernel's,
the wgmma outputs checked against the model plan's bits. The model
constants of ops/kernels/gemm_plan.py were fitted to its JSON.

    python -m svd_xtend_tpu_torch.scripts.bench_gemm_plans [--quick] [--int8] [--json PATH]
    python -m svd_xtend_tpu_torch.scripts.bench_gemm_plans --quantise [--json PATH]
    python -m svd_xtend_tpu_torch.scripts.bench_gemm_plans --trees DIR [DIR ...]

--quick times the plan and F.conv2d only; --int8 times the int8 GEMM's
plans alone. Prints one line per shape: the plan's ms, the fastest
alternative's, the library's, and the model's rank of the fastest.
--trees times the int8 GEMM under its model's plan (--int8 --quick) in
this tree and in each other checkout named, each in a process of its own
(its svd_xtend_tpu_torch, its kernels), in the order this, A, B, ..., B,
A, this, and prints every int8 site's device ms per tree beside Σ launches
x device ms per int8_both video (25 CFG passes, 2 decode chunks of 8
frames) of each GEMM; then the same for the quantise at every site
(--quantise, this file's timing run against each tree's package: the
quantise as that tree calls it, with the module path's F.gelu and product
at the gate sites of a tree whose quantise does not take the gate).
"""

from __future__ import annotations

import argparse
import collections
import json

import torch
import torch.nn.functional as F

# absolute: --trees runs this file by its path inside another checkout, whose
# package these then name (its kernels, its tables)
from svd_xtend_tpu_torch.scripts import card, graph_ms
from svd_xtend_tpu_torch.scripts.sites import GEGLU_SHAPES, UNET_CONV_SITES, UNET_DGRAD_SITES


def _alternatives(plan, widths, sms, max_slices=4):
    from ..ops.kernels.gemm_plan import candidates
    return [p for p in candidates(plan.m, plan.n, plan.k_tiles, widths, sms, max_slices)
            if p.bn <= 2 * plan.n or p.bn == plan.bn]


def _rank(alts, best):
    from ..ops.kernels.gemm_plan import cost
    return sorted(alts, key=cost).index(best)


def _tag(p):
    return f"bn {p.bn} ks {p.k_slices}"


def conv_sites(quick, rows):
    from ..ops import video
    from ..ops.kernels import conv3x3 as cv
    from ..ops.kernels.gemm_plan import sm_count

    dev = torch.device("cuda")
    sms = sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    shapes = ([("fwd", 28, h, w, ci, co, epi) for h, w, ci, co, epi, _ in UNET_CONV_SITES]
              + [("dU", 14, h, w, co, ci, "none") for h, w, co, ci, _ in UNET_DGRAD_SITES])
    for kind, n, h, w, ci, co, epi in shapes:
        x = rn(n, h, w, ci)
        weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        bias = 0.1 * rn(co)
        sc = sh = post = res = None
        if epi.startswith("preS"):
            sc, sh = (1 + 0.2 * rn(n, ci)).float() / 2, 0.3 * rn(n, ci).float()
        if "post" in epi:
            post = 0.5 * rn(n, co).float()
        if "res" in epi:
            res = rn(n, h, w, co)
        args = (x, weight, bias, sc, sh, post, res, sc is not None)
        plan = cv.conv3x3_plan(n, h, w, ci, co, sms)
        lib = graph_ms(lambda: F.conv2d(video.nchw(x), weight, bias, padding=1))
        row = dict(kind=kind, shape=[n, h, w, ci, co], epi=epi, plan=_tag(plan),
                   plan_ms=graph_ms(lambda: cv._run(*args, plan=plan)), conv2d_ms=lib,
                   flops=2 * n * h * w * 9 * ci * co)
        if not quick and plan.mainloop == "tma":
            widths = tuple(b for b in cv.CONV_TILE_N if (b == 8) == (co <= 8))
            alts = _alternatives(plan, widths, sms)
            times = {_tag(a): graph_ms(lambda: cv._run(*args, plan=a)) for a in alts}
            best = min(alts, key=lambda a: times[_tag(a)])
            row.update(best=_tag(best), best_ms=times[_tag(best)], all_ms=times,
                       model_rank_of_best=_rank(alts, best))
        rows.append(row)
        print(f"  conv3x3 {kind} {tuple(row['shape'])} {epi}: plan ({row['plan']}) "
              f"{row['plan_ms']:.4f} ms, {row['flops'] / row['plan_ms'] / 1e9:.0f} TFLOP/s; "
              + (f"best ({row['best']}) {row['best_ms']:.4f}, model rank "
                 f"{row['model_rank_of_best']}; " if "best" in row else "")
              + f"F.conv2d {lib:.4f}", flush=True)
        del x, weight, res


def geglu_shapes(quick, rows):
    from ..ops.kernels import geglu as gg
    from ..ops.kernels.gemm_plan import sm_count

    dev = torch.device("cuda")
    sms = sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    for t, c in GEGLU_SHAPES:
        args = [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
                0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]
        x, ls, lb, w1, b1, w2, b2 = args
        first, second = gg.geglu_plan(t, c, sms)
        ln = torch.nn.LayerNorm(c, device=dev, dtype=torch.bfloat16)
        ln.weight.data.copy_(ls)
        ln.bias.data.copy_(lb)
        b1b, b2b = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

        def module_path():
            h, gate = F.linear(ln(x), w1, b1b).chunk(2, dim=-1)
            return x + F.linear(h * F.gelu(gate, approximate="tanh"), w2, b2b)

        row = dict(kind="geglu", shape=[t, c], plan=[_tag(first), _tag(second)],
                   plan_ms=graph_ms(lambda: gg._launch(*args, plans=(first, second))),
                   module_ms=graph_ms(module_path), flops=24 * c * c * t)
        if not quick:
            times = {}
            for alt in _alternatives(first, gg.GEGLU1_TILE_N, sms, max_slices=1):
                times["1: " + _tag(alt)] = graph_ms(lambda: gg._launch(*args, plans=(alt, second)))
            for alt in _alternatives(second, gg.GEGLU2_TILE_N, sms):
                times["2: " + _tag(alt)] = graph_ms(lambda: gg._launch(*args, plans=(first, alt)))
            row["all_ms"] = times
            row["best"] = min(times, key=times.get)
            row["best_ms"] = times[row["best"]]
        rows.append(row)
        print(f"  geglu T {t} C {c}: plan ({row['plan'][0]}; {row['plan'][1]}) "
              f"{row['plan_ms']:.4f} ms, {row['flops'] / row['plan_ms'] / 1e9:.0f} TFLOP/s; "
              + (f"best one-GEMM change ({row['best']}) {row['best_ms']:.4f}; "
                 if "best" in row else "")
              + f"module path {row['module_ms']:.4f}", flush=True)
        del args, x, w1, w2


def _int8_row(kind, shape, label, run, m, co, k_unit, taps, sms, quick):
    from ..ops.kernels import int8_gemm as ig
    plan = ig.int8_gemm_plan(m, co, k_unit, taps, sms)
    ref = run(plan)
    row = dict(kind=kind, shape=list(shape), epi=label, plan=_tag8(plan),
               plan_ms=graph_ms(lambda: run(plan)), flops=2 * m * taps * k_unit * co)
    old = ig.mma_plan(m, co, k_unit, taps)
    row["mma_ms"] = row["plan_ms"] if plan == old else graph_ms(lambda: run(old))
    if not quick and plan.mainloop == "tma":
        alts = ig.wgmma_plans(m, co, k_unit, taps, sms)
        times = {}
        for alt in alts:
            if not torch.equal(run(alt), ref):
                raise RuntimeError(f"int8 {kind} {shape}: plan {_tag8(alt)} differs from "
                                   f"{_tag8(plan)}")
            times[_tag8(alt)] = graph_ms(lambda: run(alt))
        fastest = min(alts, key=lambda a: times[_tag8(a)])
        row.update(best=_tag8(fastest), best_ms=times[_tag8(fastest)], all_ms=times,
                   model_rank_of_best=_rank(alts, fastest))
    print(f"  int8 {kind} {tuple(shape)} {label}: plan ({row['plan']}) {row['plan_ms']:.4f} ms, "
          f"{row['flops'] / row['plan_ms'] / 1e9:.0f} TOP/s; "
          + (f"best ({row['best']}) {row['best_ms']:.4f}, model rank "
             f"{row['model_rank_of_best']}; " if "best" in row else "")
          + f"mma.sync kernel {row['mma_ms']:.4f}", flush=True)
    return row


def _tag8(p):
    return (f"{p.mainloop} bn {p.bn} kb {p.k_bytes} ks {p.k_slices}" if p.mainloop == "tma"
            else f"mma bn {p.bn}")


def int8_sites(quick, rows):
    from ..ops.kernels import int8_gemm as ig
    from ..ops.kernels import int8_quant as iq
    from ..ops.kernels.gemm_plan import sm_count
    from .sites import INT8_CONV_SITES, INT8_DENSE_SITES, INT8_VAE_CONV_SITES

    dev = torch.device("cuda")
    sms = sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    convs = ([(28, *st[:5]) for st in INT8_CONV_SITES]
             + [(8, *st[:5]) for st in INT8_VAE_CONV_SITES])
    for n, h, w, ci, co, epi in convs:
        xq, stats = iq.quantize(rn(n, h, w, ci))
        wq, w_amax = ig.conv_codes(rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5))
        bias = 0.1 * rn(co)
        post = 0.5 * rn(n, co).float() if "post" in epi else None
        res = rn(n, h, w, co) if "res" in epi else None
        run = lambda plan: ig.int8_conv3x3(xq, stats, wq, w_amax, bias, post, res, plan=plan)
        rows.append(_int8_row("conv", (n, h, w, ci, co), epi, run, n * h * w, co, ci, 9, sms,
                              quick))
        del xq, res
    for m, k, co, _ in INT8_DENSE_SITES:
        xq, stats = iq.quantize(rn(m, k))
        wq, w_amax = ig.dense_codes(rn(co, k, sc=k ** -0.5))
        bias = 0.1 * rn(co)
        run = lambda plan: ig.int8_dense(xq, stats, wq, w_amax, bias, plan=plan)
        rows.append(_int8_row("dense", (m, k, co), "bias", run, m, co, k, 1, sms, quick))
        del xq


def _video_launches(kind, shape, epi):
    """Launches of an int8 site per int8_both video."""
    from .sites import INT8_CONV_SITES, INT8_DENSE_SITES, INT8_VAE_CONV_SITES
    if kind == "dense":
        return sum(25 * st[3] for st in INT8_DENSE_SITES if list(st[:3]) == shape)
    n = shape[0]
    table, per = (INT8_CONV_SITES, 25) if n == 28 else (INT8_VAE_CONV_SITES, 2)
    return sum(per * st[5] for st in table if list(st[:4]) == shape[1:] and st[4] == epi)


def quantise_sites(rows):
    """The int8 quantise at every site of an int8_both video, in whichever
    tree's package is imported, as that tree calls it: each Conv3x3 of a CFG
    pass (batch 28) and of a decode chunk (8 frames), with the GN-fold + SiLU
    prologue and the up blocks' two sources; each QLinear input of a pass.
    A tree whose quantise takes the gate (``quantize(..., gate=True)``)
    quantises by INT8_QUANTISE_SITES (a self-attention's x once; net.2's
    input as net.0.proj's output); an older tree once a QLinear call, net.2's
    after F.gelu and the product (the module path), timed with them. Rows:
    kind, shape, launches per int8_both video, device ms."""
    import inspect

    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
    from svd_xtend_tpu_torch.scripts import sites

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: (torch.randn(*s, device=dev, generator=g) * 2).to(torch.bfloat16)
    split = {(h, w, c1 + c2, co): (c1, c2) for h, w, c1, c2, co in sites.UP_SPLIT_SITES}
    per_conv = {}
    for n, table, per in ((28, sites.INT8_CONV_SITES, 25), (8, sites.INT8_VAE_CONV_SITES, 2)):
        for h, w, ci, co, epi, launches in table:
            sp = split.get((h, w, ci, co)) if "post" in epi else None
            key = (n, h, w) + (sp or (ci,)) + (epi.startswith("pre"),)
            per_conv[key] = per_conv.get(key, 0) + per * launches
    for key, per in per_conv.items():
        n, h, w, *widths, pre_on = key
        x = rn(n, h, w, widths[0])
        x2 = rn(n, h, w, widths[1]) if len(widths) > 1 else None
        c = sum(widths)
        pre = ((1 + 0.1 * rn(n, c)).float() / 2, 0.1 * rn(n, c).float(), True) if pre_on else None
        _quantise_row(rows, "conv", list(key), per, lambda: iq.quantize(x, pre, x2))
        del x, x2
    if "gate" in inspect.signature(iq.quantize).parameters:
        for m, k_in, k, launches in sites.INT8_QUANTISE_SITES:
            y = rn(m, k_in)
            gate = k_in == 2 * k
            _quantise_row(rows, "gate" if gate else "dense", [m, k_in, k], 25 * launches,
                          lambda: iq.quantize(y, gate=gate))
            del y
    else:
        for m, k, n, launches in sites.INT8_DENSE_SITES:
            if k == 4 * n:      # net.2: the module path's F.gelu and product, then the quantise
                y = rn(m, 2 * k)
                h, gate = y.chunk(2, dim=-1)
                _quantise_row(rows, "gate", [m, 2 * k, k], 25 * launches,
                              lambda: iq.quantize(h * F.gelu(gate, approximate="tanh")))
            else:
                y = rn(m, k)
                _quantise_row(rows, "dense", [m, k, k], 25 * launches, lambda: iq.quantize(y))
            del y


def _quantise_row(rows, kind, shape, per, fn):
    rows.append(dict(kind=kind, shape=shape, per_video=per, ms=graph_ms(fn)))
    print(f"  int8 quantise {kind} {tuple(shape)} x{per}: {rows[-1]['ms']:.4f} ms", flush=True)


def _run_trees(order, argv, path=None):
    """Each tree of `order` in a process of its own: this module (or the file
    at `path`, run against that tree's package) with `argv` and --json."""
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(order):
            out = Path(tmp, f"{i}.json")
            target = [str(path)] if path else ["-m", "svd_xtend_tpu_torch.scripts.bench_gemm_plans"]
            proc = subprocess.run([sys.executable, *target, *argv, "--json", str(out)], cwd=root,
                                  env=dict(os.environ, PYTHONPATH=str(root)),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
            runs.append((root, json.loads(out.read_text())))
    return runs


def compare_trees(trees):
    """--trees: the int8 GEMM's sites under each tree's model plan, then the
    quantise at every site as each tree calls it, in a process a run."""
    from pathlib import Path

    here = Path(__file__).resolve().parents[2]
    others = [Path(t).resolve() for t in trees]
    order = [here, *others, *reversed(others), here]
    runs = _run_trees(order, ["--int8", "--quick"])
    names = {here: "this"} | {t: f"tree {i + 1}" for i, t in enumerate(others)}
    print(runs[0][1]["card"], "; trees: " + ", ".join(f"{names[t]} = {t}" for t in [here, *others]))
    totals = {}
    for j, row in enumerate(runs[0][1]["rows"]):
        per = _video_launches(row["kind"], row["shape"], row["epi"])
        cells = []
        for t in [here, *others]:
            vals = [res["rows"][j]["plan_ms"] for root, res in runs if root == t]
            key = (names[t], row["kind"])
            totals[key] = totals.get(key, 0.0) + per * sum(vals) / len(vals)
            cells.append(f"{names[t]} " + ", ".join(f"{v:.4f}" for v in vals))
        print(f"  int8 {row['kind']} {tuple(row['shape'])} {row['epi']} x{per}: "
              + " | ".join(cells), flush=True)
    for (name, kind), v in sorted(totals.items()):
        print(f"  Σ launches x device ms per int8_both video, {kind} GEMM ({name}): {v:.1f} ms")
    # the quantise as each tree calls it, this file's timing in each tree's process
    runs = _run_trees(order, ["--quantise"], path=Path(__file__).resolve())
    sums = {}
    for root, res in runs:
        for row in res["rows"]:
            k = (names[root], row["kind"])
            sums.setdefault(k, []).append(row["per_video"] * row["ms"])
    by_site = {}
    for root, res in runs:
        for row in res["rows"]:
            by_site.setdefault((row["kind"], tuple(row["shape"]), row["per_video"]), {}) \
                .setdefault(names[root], []).append(row["ms"])
    for (kind, shape, per), cells in by_site.items():
        print(f"  int8 quantise {kind} {shape} x{per}: "
              + " | ".join(f"{t} " + ", ".join(f"{v:.4f}" for v in vals)
                           for t, vals in cells.items()), flush=True)
    runs_of = collections.Counter(names[root] for root, _ in runs)
    for name in dict.fromkeys(names[root] for root, _ in runs):
        parts = {kind: sum(v) / runs_of[name] for (n, kind), v in sums.items() if n == name}
        print(f"  Σ launches x device ms per int8_both video, int8_quantize ({name}; at the "
              f"gate sites with the module path's F.gelu and product where the tree runs them): "
              f"{sum(parts.values()):.1f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in
                                                           sorted(parts.items())) + ")")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--int8", action="store_true", help="the int8 GEMM's plans alone")
    parser.add_argument("--trees", nargs="*", default=None,
                        help="other checkouts whose int8 GEMM to time beside this tree's")
    parser.add_argument("--quantise", action="store_true",
                        help="the int8 quantise at every site of an int8_both video alone")
    parser.add_argument("--json", default="")
    args = parser.parse_args(argv)
    if args.trees:
        compare_trees(args.trees)
        return
    print(card(), flush=True)
    if args.quantise:
        rows = []
        quantise_sites(rows)
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"card": card(), "rows": rows}, fh, indent=1)
        return
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    if not args.int8:
        conv_sites(args.quick, rows)
        geglu_shapes(args.quick, rows)
    int8_sites(args.quick, rows)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card(), "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
