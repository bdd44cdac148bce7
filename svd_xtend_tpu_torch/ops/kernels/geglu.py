"""Fused residual GEGLU feed-forward: y = x + W2·geglu(LN(x)·W1) over (..., C).

Port of ``svd_xtend_tpu/ops/pallas/geglu.py``: ``ln_geglu_residual`` (its
kernel ``_kernel``) and the plain ``_reference`` as
``ln_geglu_residual_reference``. The CUDA kernels are ``csrc/geglu.cu``: a
LayerNorm pass, then two GEMMs on the shared TMA + wgmma mainloop of
``csrc/sm90_gemm.cuh``, the first with the value/gate pairing and the
tanh-GELU product in its epilogue, the second with the bias and the
residual in its epilogue. Unlike the TPU kernel, the LayerNorm'd tokens and
the 4C-wide gate activation go through device memory (the wrapper
allocates them): the source says why. The first GEMM reads W1 in
``pack_w1``'s order, packed once per weight version (``packed_w1``);
``geglu_plan``, a pure function of (T, C), picks both GEMMs' tiles, K
slices and grids.

Weights are in their ``nn.Linear`` layouts: ``w1`` (2·inner, C) with the
value half in rows [:inner] and the gate half in [inner:] (the diffusers
GEGLU order, as ``proj(x).chunk(2, -1)`` splits it), ``w2`` (C, inner).

On a CPU tensor the wrapper runs the reference; on a CUDA tensor it
launches the kernel or raises. The backward recomputes the reference and
differentiates it (``jax.vjp(_reference)``, geglu.py:217-219 in the JAX
package). The TPU dispatch gate (``c <= 320 and t >= 16384``,
geglu.py:116) is a v5e measurement; on CUDA the kernel takes every site
``supports`` admits.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._autograd import differentiable
from ._build import check, library
from ._weights import per_version
from .gemm_plan import K_TILE, SM_COUNT, plan_gemm, sm_count

LN_EPS = 1e-5
CHANNEL_MULTIPLE = 64    # K tiles of 64 in both GEMMs
PAIR_ROWS = 64           # W1's value rows per packed block, then as many gate rows
# the tile widths csrc/geglu.cu instantiates (SVDX_GEGLU1_TILE_N, SVDX_GEGLU2_TILE_N)
GEGLU1_TILE_N = (256,)
GEGLU2_TILE_N = (128, 160)


def ln_geglu_residual_reference(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                                w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                                b2: torch.Tensor) -> torch.Tensor:
    """Plain version: LN statistics in f32 and its output rounded to x's
    dtype; both products on x-dtype operands accumulated in f32; the gate
    product rounded to x's dtype before the second product; tanh GELU."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    xn = ((xc * torch.rsqrt(var + LN_EPS)) * ls.float() + lb.float()).to(dt)
    hg = F.linear(xn.float(), w1.to(dt).float(), b1.float())
    h, g = hg.chunk(2, dim=-1)
    u = (h * F.gelu(g, approximate="tanh")).to(dt)
    y = F.linear(u.float(), w2.to(dt).float(), b2.float())
    return x + y.to(dt)


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """W1 (2·inner, C) -> the first GEMM's order: block b of 128 rows is value
    rows [64b, 64b + 64) then gate rows inner + [64b, 64b + 64)."""
    two_inner, c = w1.shape
    blocks = two_inner // (2 * PAIR_ROWS)
    return w1.reshape(2, blocks, PAIR_ROWS, c).transpose(0, 1).reshape(two_inner, c)


def unpack_w1(w1p: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_w1``."""
    two_inner, c = w1p.shape
    blocks = two_inner // (2 * PAIR_ROWS)
    return w1p.reshape(blocks, 2, PAIR_ROWS, c).transpose(0, 1).reshape(two_inner, c)


# pack_w1 of W1 in bf16, made once per weight version (an optimizer step
# bumps it), so a call does not copy W1
packed_w1 = per_version(lambda w1: pack_w1(w1.to(torch.bfloat16)).contiguous())


@functools.cache
def geglu_plan(t: int, c: int, sms: int = SM_COUNT) -> tuple:
    """(first GEMM's plan, second's) for T tokens of width C on a card of
    `sms` SMs: xn (T, C) · W1pᵀ (N = 8C, K = C, no split: its K is short)
    and u (T, 4C) · W2ᵀ (N = C, K = 4C). Memoized: a launch's host time is
    on the path (the two plans cost ~0.25 ms to choose)."""
    first = plan_gemm(t, 8 * c, c // K_TILE, GEGLU1_TILE_N, sms, max_slices=1)
    second = plan_gemm(t, c, 4 * c // K_TILE, GEGLU2_TILE_N, sms)
    return first, second


def supports(x: torch.Tensor, inner: int) -> bool:
    """Structural dispatch predicate: a CUDA bf16 (..., C) with C a multiple
    of 64 and inner = 4C."""
    c = x.shape[-1]
    return (x.is_cuda and x.dtype == torch.bfloat16 and c % CHANNEL_MULTIPLE == 0
            and inner == 4 * c)


def _launch(x, ls, lb, w1, b1, w2, b2, plans=None) -> torch.Tensor:
    c = x.shape[-1]
    inner = w2.shape[1]
    if not supports(x, inner):
        raise ValueError(f"ln_geglu_residual kernel needs a CUDA bf16 (..., C) with "
                         f"C % {CHANNEL_MULTIPLE} == 0 and inner 4C; got "
                         f"{tuple(x.shape)} {x.dtype}, inner {inner}")
    if w1.shape != (2 * inner, c) or w2.shape != (c, inner):
        raise ValueError(f"ln_geglu_residual: w1 must be {(2 * inner, c)} and w2 "
                         f"{(c, inner)}; got {tuple(w1.shape)}, {tuple(w2.shape)}")
    for name, a, n in (("ls", ls, c), ("lb", lb, c), ("b1", b1, 2 * inner), ("b2", b2, c)):
        if a.shape != (n,):
            raise ValueError(f"ln_geglu_residual: {name} must be ({n},)")
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous():
        raise ValueError("ln_geglu_residual: x must be contiguous")
    t = x2.shape[0]
    out, xn = torch.empty_like(x2), torch.empty_like(x2)
    u = torch.empty((t, inner), device=x.device, dtype=torch.bfloat16)
    f32 = lambda a: a.float().contiguous()
    w1p, w2b = packed_w1(w1), w2.to(torch.bfloat16).contiguous()
    lsf, lbf, b1f, b2f = f32(ls), f32(lb), f32(b1), f32(b2)
    first, second = plans if plans is not None else geglu_plan(t, c, sm_count(x.device))
    ws = (torch.empty(second.workspace_elems, device=x.device, dtype=torch.float32)
          if second.workspace_elems else None)
    err = library().svdx_ln_geglu_residual(
        x2.data_ptr(), lsf.data_ptr(), lbf.data_ptr(), w1p.data_ptr(), b1f.data_ptr(),
        w2b.data_ptr(), b2f.data_ptr(), xn.data_ptr(), u.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), t, c, first.bn, first.grid,
        second.bn, second.k_slices, second.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ln_geglu_residual")
    ln_geglu_residual.launches += 1
    return out.reshape(x.shape)


def ln_geglu_residual(x: torch.Tensor, ls: torch.Tensor, lb: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, *, kernel=None) -> torch.Tensor:
    """y = x + w2-projection of geglu(w1-projection of LayerNorm(x)).
    ``kernel`` replaces the CUDA launch (the CPU tests pass the reference to
    run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return ln_geglu_residual_reference(x, ls, lb, w1, b1, w2, b2)
        kernel = _launch
    return differentiable(kernel, ln_geglu_residual_reference, x, ls, lb, w1, b1, w2, b2)


ln_geglu_residual.launches = 0
