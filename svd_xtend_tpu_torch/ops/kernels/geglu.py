"""Fused residual GEGLU feed-forward: y = x + W2·geglu(LN(x)·W1) over (..., C).

Port of ``svd_xtend_tpu/ops/pallas/geglu.py``: ``ln_geglu_residual`` (its
kernel ``_kernel``) and the plain ``_reference`` as
``ln_geglu_residual_reference``. The CUDA kernels are ``csrc/geglu.cu``: a
LayerNorm pass, then two tensor-core GEMMs, the first with the value/gate
pairing and the tanh-GELU product in its epilogue, the second with the bias
and the residual in its epilogue. Unlike the TPU kernel, the LayerNorm'd
tokens and the 4C-wide gate activation go through device memory (the
wrapper allocates them): the source says why.

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

import torch
import torch.nn.functional as F

from ._autograd import differentiable
from ._build import check, library

LN_EPS = 1e-5
CHANNEL_MULTIPLE = 64    # the GEMMs' column tiles


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


def supports(x: torch.Tensor, inner: int) -> bool:
    """Structural dispatch predicate: a CUDA bf16 (..., C) with C a multiple
    of 64 and inner = 4C."""
    c = x.shape[-1]
    return (x.is_cuda and x.dtype == torch.bfloat16 and c % CHANNEL_MULTIPLE == 0
            and inner == 4 * c)


def _launch(x, ls, lb, w1, b1, w2, b2) -> torch.Tensor:
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
    out, xn = torch.empty_like(x2), torch.empty_like(x2)
    u = torch.empty((x2.shape[0], inner), device=x.device, dtype=torch.bfloat16)
    bf = lambda a: a.to(torch.bfloat16).contiguous()
    f32 = lambda a: a.float().contiguous()
    w1b, w2b = bf(w1), bf(w2)
    lsf, lbf, b1f, b2f = f32(ls), f32(lb), f32(b1), f32(b2)
    err = library().svdx_ln_geglu_residual(
        x2.data_ptr(), lsf.data_ptr(), lbf.data_ptr(), w1b.data_ptr(), b1f.data_ptr(),
        w2b.data_ptr(), b2f.data_ptr(), xn.data_ptr(), u.data_ptr(), out.data_ptr(),
        x2.shape[0], c,
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
