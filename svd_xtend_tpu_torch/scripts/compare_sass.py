"""The SASS of kernel sources built from this tree against another tree's,
on a machine with the CUDA toolkit: each source compiled alone with the
build's flags (ops/kernels/_build.py), disassembled by cuobjdump, and the two
listings compared after the one name that differs between any two builds
of a file is made the same (nvcc's hash in the anonymous namespace's
mangled name). By default the sources built on the shared GEMM mainloop
(csrc/sm90_gemm.cuh): conv3x3, geglu, temporal_resnet, upsample_conv.

    python -m svd_xtend_tpu_torch.scripts.compare_sass --tree OTHER_CHECKOUT [--out DIR]
    python -m svd_xtend_tpu_torch.scripts.compare_sass --loops SOURCE [--match TEXT]

Prints, per source, whether the listings are the same and how many lines
differ; exits 1 if any differs or fails to build. --loops prints this
tree's loop bodies in SOURCE's kernels (the instructions between a backward
branch and its target, the largest first; --match keeps the kernels whose
mangled name holds TEXT), to count a hot loop's instructions.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import difflib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops.kernels import _build

SOURCES = ("conv3x3", "geglu", "temporal_resnet", "upsample_conv")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")


def listing(tree: Path, name: str, work: Path) -> str:
    """cuobjdump -sass of csrc/<name>.cu of the checkout at `tree`."""
    src = tree / "svd_xtend_tpu_torch" / "csrc" / f"{name}.cu"
    obj = work / f"{name}.o"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *_build.PTXAS_FLAGS, "-c", "-o",
                    str(obj), str(src)], check=True, capture_output=True, text=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(obj)], check=True, capture_output=True,
                         text=True).stdout
    return _ANON.sub("_GLOBAL__N__#_", out)


_FUNCTION = re.compile(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)", re.S)
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(.*?)\s*;")


def loops(text: str, match: str = "", top: int = 6):
    """(kernel, [(instructions, MUFU instructions, loop start address)]) of
    each kernel whose name holds `match`: its innermost loops (a backward
    branch and its target, holding no other), the largest first."""
    out = []
    for name, body in _FUNCTION.findall(text):
        if match not in name:
            continue
        code = [(int(a, 16), ins) for a, ins in _INSTRUCTION.findall(body)]
        spans = []
        for addr, ins in code:
            target = re.search(r"BRA (?:\S+ )?0x([0-9a-f]+)", ins)
            if target and int(target.group(1), 16) < addr:
                spans.append((int(target.group(1), 16), addr))
        inner = [(a, b) for a, b in spans
                 if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in spans)]
        found = [(sum(1 for x, _ in code if a <= x <= b),
                  sum(1 for x, i in code if a <= x <= b and i.startswith("MUFU")), hex(a))
                 for a, b in inner]
        out.append((name, sorted(found, reverse=True)[:top]))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--loops", default="", help="this tree's loop bodies in this source")
    parser.add_argument("--match", default="")
    parser.add_argument("--tree", help="the other checkout's root")
    parser.add_argument("--sources", nargs="*", default=list(SOURCES))
    parser.add_argument("--out", default="", help="write both listings here")
    args = parser.parse_args(argv)
    if args.loops:
        with tempfile.TemporaryDirectory() as tmp:
            text = listing(_build.PACKAGE_ROOT.parent, args.loops, Path(tmp))
        for name, found in loops(text, args.match):
            print(f"{name}: innermost loops (instructions, MUFU, start) {found}", flush=True)
        return 0
    if not args.tree:
        parser.error("--tree or --loops")
    trees = {"this": _build.PACKAGE_ROOT.parent, "other": Path(args.tree).resolve()}
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(
            os.cpu_count() or 4) as pool:
        jobs = {}
        for tag, tree in trees.items():
            work = Path(tmp) / tag
            work.mkdir()
            for name in args.sources:
                jobs[(tag, name)] = pool.submit(listing, tree, name, work)
        bad = 0
        for name in args.sources:
            try:
                mine, theirs = jobs[("this", name)].result(), jobs[("other", name)].result()
            except subprocess.CalledProcessError as e:
                print(f"{name}: build failed: {e.stderr[-2000:]}", flush=True)
                bad += 1
                continue
            diff = [ln for ln in difflib.unified_diff(theirs.splitlines(), mine.splitlines(),
                                                      lineterm="", n=0)
                    if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
            same = not diff
            bad += not same
            print(f"{name}: SASS {'the same' if same else 'DIFFERS'} ({len(mine.splitlines())} "
                  f"lines here, {len(theirs.splitlines())} there, {len(diff)} differing)",
                  flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                Path(args.out, f"{name}.this.sass").write_text(mine)
                Path(args.out, f"{name}.other.sass").write_text(theirs)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
