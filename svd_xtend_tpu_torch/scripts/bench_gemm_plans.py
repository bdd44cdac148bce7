"""The launch plans of the shared GEMM mainloop against their alternatives, on
the card: device time per launch (a CUDA graph) of conv3x3 at the UNet's
sites (CFG batch 28), its dU at the train step's shapes (batch 14), and
GEGLU at its eight (T, C) shapes, each under the plan the wrapper picks
and under every other (tile width, K slices up to 4) the kernels take,
beside F.conv2d alone or the unfused module path. The model constants of
ops/kernels/gemm_plan.py were fitted to its JSON.

    python -m svd_xtend_tpu_torch.scripts.bench_gemm_plans [--quick] [--json PATH]

--quick times the plan and F.conv2d only. Prints one line per shape: the
plan's ms, the fastest alternative's, the library's, and the model's rank
of the fastest.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from . import card, graph_ms
from .sites import GEGLU_SHAPES, UNET_CONV_SITES, UNET_DGRAD_SITES


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--json", default="")
    args = parser.parse_args(argv)
    print(card(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    conv_sites(args.quick, rows)
    geglu_shapes(args.quick, rows)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card(), "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
