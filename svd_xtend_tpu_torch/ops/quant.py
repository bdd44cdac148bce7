"""Opt-in int8 (W8A8) inference: the spatial 3x3 convs and the transformer
projections. Port of ``svd_xtend_tpu/ops/quant.py``.

Scheme (the JAX package's, the standard diffusion W8A8 recipe):
  - weights: symmetric per-output-channel int8, s_w[co] = amax|w| / 127,
    from the weights in the activation dtype; the codes are made once per
    parameter version (``ops/kernels/int8_gemm.py``), before the sampler's
    loop, where the JAX package quantises at trace time and XLA hoists it
    out of the scan;
  - activations: symmetric per-tensor dynamic int8, the scale from the live
    amax of the whole tensor of each call (both halves and every frame of a
    CFG pair; the cond half alone in a cond-only pass);
  - the products accumulated exactly in int32, dequantised by s_x * s_w[co]
    into the epilogue: + bias in f32, one cast to the activation dtype, then
    + the time-embedding shift and + the residual in that dtype (JAX's
    order, quant.py:252-255, 271-278).

Arithmetic as XLA compiles JAX's functions under jit, which is how
``generate`` runs them: the scale is ``max(amax, 1e-12) * f32(1/127)`` (XLA's
form of ``amax / 127.0``), so the codes are the jitted function's bit for
bit (the eager one divides and may differ by one code); and XLA's
simplifier gathers the two constants of the dequantising product s_x · s_w
into one, f32(f32(1/127)²), computing ``amax_w[co] · (max(amax_x, 1e-12) ·
f32(1/127)²)`` with amax_w the clamped weight amax. The epilogue takes that
form (``dequant_scale``), and the outputs are the jitted function's bit for
bit as well.

Which sites: the JAX package takes a site only where two tables measured
on a TPU say int8 wins there by a margin (quant.py:125-138, 213-228), or
every site under ``SVDX_INT8_FORCE=1``. The port's dispatch is structural
(the TPU tuner, ``autotune.py`` and its tables, is not ported), so its int8
mode takes every site JAX's int8 branch can take, as JAX does under
``SVDX_INT8_FORCE=1``: every ``Conv3x3`` and every ``QLinear`` that runs
inside ``quantized("int8")``. ``generate`` scopes ``unet_quant`` around its
UNet calls and ``vae_quant`` around the VAE decode. The port reads no table
and no environment variable; the tables' writers (``save_table``,
``save_dense_table``, ``record_dense_shape``, the TPU tuner's) are not
ported.

This module holds the mode gate and the plain versions, which are the
contract: ``quantize_dynamic``, the weight quantisers, the exact int32
accumulations (float64 products of the codes, exact below 2^53; an f32 sum
would be exact only below 2^24), the epilogue, and ``int8_conv3x3_reference``
/ ``int8_dense_reference`` (JAX's ``int8_conv3x3`` / ``int8_dense``). The
card's kernels are ``ops/kernels/int8_quant.py`` and
``ops/kernels/int8_gemm.py``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from . import video

MODES = (None, "int8")
QMAX = 127
# f32(1/127): XLA's constant for `/ 127.0` under jit, and its f32 square,
# the constant of the dequantising product
INV_QMAX = torch.tensor(1.0 / QMAX, dtype=torch.float32).item()
INV_QMAX2 = (torch.tensor(INV_QMAX, dtype=torch.float32) ** 2).item()
AMAX_FLOOR = 1e-12

_mode: Optional[str] = None
_group = None


def set_mode(mode: Optional[str]) -> None:
    """The ambient quantisation mode that Conv3x3 and QLinear read at each
    call; an unknown mode raises."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    _mode = mode


def get_mode() -> Optional[str]:
    return _mode


@contextmanager
def quantized(mode: Optional[str], group=None):
    """The mode inside the block, the previous one after it. With a process
    `group` (``parallel.World.amax_groups``), each activation's amax is the
    largest over the group (``amax_group``): its ranks hold the parts of
    one global tensor (the data rows, the frames, a row-parallel product's
    inputs) or copies of it, and the global tensor's amax is what the
    one-rank codes take, as GSPMD's global max in the JAX package."""
    global _group
    prev = _mode, _group
    set_mode(mode)
    _group = group
    try:
        yield
    finally:
        set_mode(prev[0])
        _group = prev[1]


def amax_group():
    """The process group an activation's amax is reduced over, or None."""
    return _group


def clamped(amax: torch.Tensor) -> torch.Tensor:
    return amax.float().clamp_min(AMAX_FLOOR)


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) · f32(1/127), in f32."""
    return clamped(amax) * INV_QMAX


def dequant_scale(x_amax: torch.Tensor, w_amax: torch.Tensor) -> torch.Tensor:
    """s_x · s_w[co] in XLA's jitted form: w_amax[co] · (max(x_amax, 1e-12) ·
    f32(1/127)²), w_amax the clamped weight amaxes."""
    return w_amax.float() * (clamped(x_amax) * INV_QMAX2)


def codes(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 codes of f32 `v` at `scale`."""
    return torch.round(v / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def quantize_dynamic(x: torch.Tensor):
    """Symmetric per-tensor dynamic int8: (codes of x's shape, f32 scale, a
    0-dim tensor on x's device)."""
    xf = x.float()
    scale = scale_of(xf.abs().amax())
    return codes(xf, scale), scale


def _per_row(w2d: torch.Tensor):
    """Per-row int8 of (rows, K): (codes, clamped amaxes (rows,))."""
    wf = w2d.float()
    amax = clamped(wf.abs().amax(dim=1))
    return codes(wf, (amax * INV_QMAX)[:, None]), amax


def weight_codes_per_co(weight: torch.Tensor):
    """Per-output-channel int8 of an OIHW (Co, Ci, 3, 3) conv weight: (codes
    (Co, 3, 3, Ci), K-major as the GEMM reads them, clamped amaxes (Co,),
    which the epilogue reads)."""
    codes, amax = _per_row(weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1))
    return codes.reshape(weight.shape[0], 3, 3, weight.shape[1]), amax


def weight_codes_per_cout(weight: torch.Tensor):
    """Per-output-row int8 of an nn.Linear (Cout, Cin) weight: (codes
    (Cout, Cin), clamped amaxes (Cout,)); JAX's per-column quantisation of
    its (Cin, Cout) kernel."""
    return _per_row(weight)


def quantize_weight_per_co(weight: torch.Tensor):
    """JAX's ``quantize_weight_per_co`` of an OIHW weight: (codes (Co, 3, 3,
    Ci), f32 scales (Co,))."""
    codes, amax = weight_codes_per_co(weight)
    return codes, amax * INV_QMAX


def quantize_weight_per_cout(weight: torch.Tensor):
    """JAX's ``quantize_weight_per_cout`` of an nn.Linear weight: (codes
    (Cout, Cin), f32 scales (Cout,))."""
    codes, amax = weight_codes_per_cout(weight)
    return codes, amax * INV_QMAX


def conv_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of the 3x3 SAME conv of NHWC codes xq (N, H, W,
    Ci) with K-major codes wq (Co, 3, 3, Ci): (N, H, W, Co) int32, by
    float64 products (im2col and a matrix product, no transform that
    rounds), a sample at a time (the f64 columns of one sample)."""
    n, h, w, ci = xq.shape
    wk = wq.permute(0, 3, 1, 2).reshape(wq.shape[0], ci * 9).double()
    out = torch.empty((n, h, w, wq.shape[0]), dtype=torch.int32, device=xq.device)
    for i in range(n):
        cols = F.unfold(video.nchw(xq[i:i + 1]).double(), 3, padding=1)   # (1, Ci·9, HW)
        out[i] = torch.matmul(wk, cols[0]).t().reshape(h, w, -1).to(torch.int32)
    return out


def dense_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of codes xq (..., K) times wq (N, K)ᵀ."""
    return torch.matmul(xq.double(), wq.double().t()).to(torch.int32)


def dequantize(acc: torch.Tensor, x_amax: torch.Tensor, w_amax: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype,
               post_shift: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 epilogue in JAX's order: f32(acc) · (s_x · s_w)
    (``dequant_scale``), + bias in f32, cast to `dtype`, + post_shift (N, Co)
    cast to `dtype` (NHWC acc), + residual."""
    y = acc.float() * dequant_scale(x_amax, w_amax)
    if bias is not None:
        y = y + bias.to(dtype).float()
    y = y.to(dtype)
    if post_shift is not None:
        y = y + post_shift.to(dtype)[:, None, None, :]
    if residual is not None:
        y = y + residual
    return y


def int8_conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           post_shift: Optional[torch.Tensor] = None,
                           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's ``int8_conv3x3``: the W8A8 3x3 SAME conv of NHWC x (any prologue
    already applied) with the OIHW weight, in x's dtype."""
    xq, _ = quantize_dynamic(x)
    wq, w_amax = weight_codes_per_co(weight.to(x.dtype))
    return dequantize(conv_accumulate(xq, wq), x.float().abs().amax(), w_amax, bias, x.dtype,
                      post_shift, residual)


def int8_dense_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's ``int8_dense``: x (..., K) @ weightᵀ (+ bias) on the W8A8 path,
    weight the nn.Linear (N, K)."""
    xq, _ = quantize_dynamic(x)
    wq, w_amax = weight_codes_per_cout(weight.to(x.dtype))
    return dequantize(dense_accumulate(xq, wq), x.float().abs().amax(), w_amax, bias, x.dtype)
