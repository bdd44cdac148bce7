"""Ablate the flash forward's softmax organisation at the SVD spatial shapes
(L0 512x320: s=2560; L1 op-B: s=2304; L0 op-B: s=9216), head-major
(B*H, S, 64) bf16.

Counterpart of ``scripts/microbench_flash_variants.py`` (modes in
``ops/kernels/flash_variants.py``): base, major, major_exp2, nosoftmax. Per
shape and mode: ms and TFLOP/s, then max|mode - base| of the two major
forms. ``--sass`` also counts the MUFU.EX2 and FFMA instructions of each
mode's kernel in the built library (cuobjdump).

    python -m svd_xtend_tpu_torch.scripts.microbench_flash_variants [--sass]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

import torch

from svd_xtend_tpu_torch.ops.kernels import _build
from svd_xtend_tpu_torch.ops.kernels.flash_variants import MODES, flash_variants
from svd_xtend_tpu_torch.scripts import card, cuda_ms, require_card

SHAPES = [("L0 512x320 (bh=140, s=2560)", 140, 2560),
          ("L1 opB (bh=280, s=2304)", 280, 2304),
          ("L0 opB (bh=250, s=9216)", 250, 9216)]
D = 64


def inputs(bh: int, s: int, seed: int = 0):
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(bh, s, D, device=dev, generator=g).to(torch.bfloat16)
                 for _ in range(3))


def run(bh: int, s: int, seed: int = 0, iters: int = 10) -> dict:
    """{mode: ms} and {mode: max|mode - base|} at one shape."""
    q, k, v = inputs(bh, s, seed)
    call = lambda mode: flash_variants(q, k, v, scale=D ** -0.5, mode=mode)
    ms = {mode: cuda_ms(lambda: call(mode), iters) for mode in MODES}
    base = call("base").float()
    diff = {mode: (call(mode).float() - base).abs().max().item()
            for mode in ("major", "major_exp2")}
    return ms, diff


def sass_counts() -> dict:
    """{mode: Counter of MUFU.EX2 and FFMA} of each mode's kernel in the
    built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    _build.library()
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    counts, mode = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_variant_kernelILi(\d)E", line)
            mode = MODES[int(m.group(1))] if m else None
        elif mode is not None:
            for op in ("MUFU.EX2", "FFMA"):
                if op in line:
                    counts[mode][op] += 1
    return dict(counts)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sass", action="store_true",
                        help="count MUFU.EX2 and FFMA per mode's kernel")
    args = parser.parse_args(argv)
    print(card())
    for label, bh, s in SHAPES:
        print(f"\n=== {label} ===")
        flops = 4 * bh * s * s * D
        ms, diff = run(bh, s)
        for mode in MODES:
            print(f"{mode:44s} {ms[mode]:8.3f} ms  {flops / ms[mode] / 1e9:6.1f} TFLOP/s",
                  flush=True)
        for mode, d in diff.items():
            print(f"  max|{mode}-base| = {d:.2e}")
    if args.sass:
        for mode, c in sass_counts().items():
            print(f"sass {mode}: MUFU.EX2 {c['MUFU.EX2']}, FFMA {c['FFMA']}")


if __name__ == "__main__":
    main()
