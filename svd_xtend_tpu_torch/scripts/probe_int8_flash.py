"""Probe: would int8 QKᵀ / PV products speed up the flash kernel on an H100?

Counterpart of ``scripts/probe_int8_flash.py``: it times the flash
forward's dependent product chain (scores = Q(bq, 64)·Kᵀ(64, bkm), then
out = P(bq, bkm)·V(bkm, 64), each step's Q the last step's output) at the
TPU probe's tiles, 60 steps a launch:

  bf16    — the flash kernel's arithmetic (bf16 products, f32 sums);
  int8_qd — Kᵀ/V quantised beforehand, Q and P quantised per step with
            their maxima over the whole tensor (what a flash integration
            must pay), int32 sums, f32 dequantise.

The TPU probe's decision rule, stated before its measurement: unless
int8_qd ≥ ~1.5× bf16 on the chain, int8 inside flash is not worth it. The
kernels are ``ops/kernels/flash_chain.py``.

    python -m svd_xtend_tpu_torch.scripts.probe_int8_flash
"""

from __future__ import annotations

import torch

from svd_xtend_tpu_torch.ops.kernels.flash_chain import chain_bf16, chain_int8_qd
from svd_xtend_tpu_torch.scripts import card, cuda_ms, require_card

N_INNER = 60
D = 64
# flash forward tile shapes at the SVD bench shapes (bq, bkm), as on the TPU
TILES = [(640, 640), (1280, 1280), (1024, 1536)]
DECISION_RATIO = 1.5


def inputs(bq: int, bkm: int, seed: int = 0):
    """q, kᵀ, v normal bf16; int8 kᵀ and v = clip(round(20·x), ±127)."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bq, D, device=dev, generator=g).to(torch.bfloat16)
    kT = torch.randn(D, bkm, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(bkm, D, device=dev, generator=g).to(torch.bfloat16)
    to8 = lambda a: torch.clamp(torch.round(a.float() * 20), -127, 127).to(torch.int8)
    return q, kT, v, to8(kT), to8(v)


def run(bq: int, bkm: int, n_inner: int = N_INNER, iters: int = 10) -> dict:
    """µs per chain step of each form at one tile."""
    q, kT, v, kTi, vi = inputs(bq, bkm)
    per_step = lambda fn: cuda_ms(fn, iters) * 1e3 / n_inner
    return {"bf16": per_step(lambda: chain_bf16(q, kT, v, n_inner)),
            "int8_qd": per_step(lambda: chain_int8_qd(q, kTi, vi, n_inner))}


def main() -> None:
    print(card())
    for bq, bkm in TILES:
        us = run(bq, bkm)
        mops = (2 * bq * D * bkm + 2 * bq * bkm * D) / 1e6   # per step
        print(f"chain QK+PV bq={bq} bkm={bkm}: bf16 {us['bf16']:7.2f}us "
              f"({mops / us['bf16']:.1f} TF/s)  int8_qd {us['int8_qd']:7.2f}us "
              f"({mops / us['int8_qd']:.1f} TOP/s)  speedup "
              f"{us['bf16'] / us['int8_qd']:.2f}x (decision rule: >= {DECISION_RATIO}x)",
              flush=True)


if __name__ == "__main__":
    main()
