"""int8 x int8 -> int32 GEMM with the W8A8 dequantising epilogue on a hand
kernel, the second half of the int8 path (``ops/quant.py``), and the two
int8 sites the models call.

The functions are ``svd_xtend_tpu/ops/quant.py::int8_conv3x3`` and
``::int8_dense`` after their activation quantisation (XLA code in the JAX
package, no Pallas kernel). The kernels are ``csrc/int8_gemm.cu``: the 3x3
SAME implicit GEMM over NHWC int8 codes or a dense (M, K) product, with the
weight codes K-major, int32 accumulators and JAX's epilogue (the scale
product, + bias in f32, one cast, + shift, + residual in the activation
type; the dequantising scale in XLA's jitted form, ``quant.dequant_scale``),
bit for bit the plain versions ``conv_reference`` / ``dense_reference``.
``int8_gemm_plan``, a pure function of the shape, picks the kernel: the
persistent TMA + wgmma mainloop of ``csrc/sm90_gemm.cuh`` on int8 operands
(its tile width, K slices and grid by ``gemm_plan``'s cost model; K in
tiles of 128 codes, a conv's per tap), or, for the shapes TMA cannot take (a conv's Ci or a dense K not a
multiple of 16, an output not a multiple of 8 wide) and the thin outputs
(Co <= 32), the first mma.sync kernel. The wrappers take an explicit
``plan=`` (chip_smoke.py times the mma.sync kernel beside the new one at
every site).

``int8_conv3x3`` and ``int8_dense`` take codes and ``stats`` (the (amax,
scale) tensor of ``int8_quant.quantize``); on a CPU tensor they run the
plain version, on a CUDA tensor they launch the kernel or raise. The sites,
``conv3x3_site`` (``models/blocks.py::Conv3x3`` in int8 mode) and
``linear_site`` (``models/transformer.py::QLinear``), quantise the
activation and run the GEMM, through the kernels unless
``dispatch.plain_versions()`` is on. The weight codes are made once per
parameter version (``_weights.per_version``): ``generate`` makes them all
before its loop (``prepare``), and they stay on the device while the
parameters do (≈ 1.5 GB for the UNet).

Under tensor parallelism (``parallel/tensor.py``) a row-parallel dense
holds its columns of every output channel: ``row_dense_codes`` takes each
channel's weight amax as the largest over the model group (the whole
channel's, which the one-rank codes take), and ``linear_site(...,
group=)`` runs the kernel's raw form (``dense_sums``: the exact int32
sums, no epilogue), sums them over the group exactly and dequantises the
sum once: the one-rank product bit for bit. A rank whose part is empty (no
head, no feed-forward columns) adds zero sums and launches no GEMM.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ...parallel.frames import all_reduce_max_
from ...parallel.tensor import all_reduce_sum_
from .. import quant
from . import int8_quant as iq
from ._build import check, library
from ._weights import per_version
from .dispatch import kernels_enabled
from .gemm_plan import SM_COUNT, GemmPlan, best, candidates, sm_count

THIN = 32    # outputs at most this wide take the mma.sync kernel's 32-wide tile
# the tile widths csrc/int8_gemm.cu's wgmma kernels instantiate and the codes
# of K a stage holds (SVDX_INT8_TILE_N, SVDX_INT8_K_BYTES)
INT8_TILE_N = (128, 160, 256)
INT8_K_TILE = 128
MMA_K_TILE = 64        # the mma.sync kernel's K tile (bytes)


def takes_wgmma(co: int, k_unit: int) -> bool:
    """Whether the wgmma kernels take an output width `co` whose K comes in
    runs of `k_unit` codes (a conv's Ci, a dense's K): TMA's 16-byte global
    strides (the codes' rows, the bf16 output's rows) and a width above the
    thin outputs'."""
    return co > THIN and co % 8 == 0 and k_unit % 16 == 0


def mma_plan(m: int, co: int, k_unit: int, taps: int = 1) -> GemmPlan:
    """The mma.sync kernel's plan: 128 x bn tiles (bn 32 for the thin
    outputs), one block each, K in 64-byte tiles."""
    plan = GemmPlan(m, co, -(-taps * k_unit // MMA_K_TILE), THIN if co <= THIN else 128, 1, 1,
                    mainloop="mma", k_bytes=MMA_K_TILE, elem_bytes=1)
    return dataclasses.replace(plan, grid=plan.n_items)


def wgmma_plans(m: int, co: int, k_unit: int, taps: int = 1, sms: int = SM_COUNT) -> list:
    """Every plan the wgmma kernels take: tile widths x K slices. A K tile
    is 128 codes of one tap (a conv's tap ends in a tile that TMA zero-fills
    past Ci)."""
    return candidates(m, co, taps * -(-k_unit // INT8_K_TILE), INT8_TILE_N, sms,
                      k_bytes=INT8_K_TILE, elem_bytes=1)


@functools.lru_cache(maxsize=None)
def int8_gemm_plan(m: int, co: int, k_unit: int, taps: int = 1, sms: int = SM_COUNT) -> GemmPlan:
    """The launch plan of an (m, taps·k_unit) x (co, taps·k_unit) int8 GEMM on
    a card of `sms` SMs (a conv: taps 9, k_unit Ci; a dense: taps 1, k_unit
    K): the wgmma kernels' cheapest plan under gemm_plan's model where
    ``takes_wgmma``, else the mma.sync kernel's. Memoized: no plan is
    computed per launch."""
    if m < 1 or co < 1 or k_unit < 1:
        raise ValueError(f"int8 GEMM plan: no plan for M {m}, N {co}, K {taps} x {k_unit}")
    if not takes_wgmma(co, k_unit):
        return mma_plan(m, co, k_unit, taps)
    return best(wgmma_plans(m, co, k_unit, taps, sms), sms)


def _check_plan(plan: GemmPlan, m: int, co: int, k_unit: int, taps: int) -> None:
    want = (wgmma_plans(m, co, k_unit, taps)[0] if plan.mainloop == "tma"
            else mma_plan(m, co, k_unit, taps))
    if (plan.m, plan.n, plan.k_tiles, plan.k_bytes, plan.elem_bytes) != (
            want.m, want.n, want.k_tiles, want.k_bytes, want.elem_bytes):
        raise ValueError(f"int8 GEMM: plan {plan} is not one of M {m}, N {co}, K {taps} x "
                         f"{k_unit}")


# (codes, clamped amaxes (Co,)): (Co, 3, 3, Ci) for a conv, (Co, K) for a dense
conv_codes = per_version(quant.weight_codes_per_co)
dense_codes = per_version(quant.weight_codes_per_cout)


def _reduced_codes(weight: torch.Tensor, group):
    wf = weight.float()
    amax = wf.abs().amax(dim=1) if wf.shape[1] else wf.new_zeros(wf.shape[0])
    amax = quant.clamped(all_reduce_max_(amax, group))
    return quant.codes(wf, (amax * quant.INV_QMAX)[:, None]), amax


@functools.lru_cache(maxsize=None)
def _reduced_cache(group):
    return per_version(lambda w: _reduced_codes(w, group))


def row_dense_codes(weight: torch.Tensor, group):
    """(codes (Cout, K_r), clamped amaxes (Cout,)) of this rank's columns of
    a row-parallel nn.Linear weight, each row's amax the largest over the
    model `group` (made once per parameter version; every rank of the
    group makes them together)."""
    return _reduced_cache(group)(weight)


def conv_reference(xq, stats, wq, w_amax, bias=None, post_shift=None, residual=None,
                   dtype=torch.bfloat16):
    """Plain version of the conv GEMM: NHWC codes xq (N, H, W, Ci), wq (Co,
    3, 3, Ci) with its clamped amaxes, stats (amax, scale) of xq -> (N, H, W,
    Co) in `dtype`."""
    return quant.dequantize(quant.conv_accumulate(xq, wq), stats[0], w_amax, bias, dtype,
                            post_shift, residual)


def dense_reference(xq, stats, wq, w_amax, bias=None, dtype=torch.bfloat16):
    """Plain version of the dense GEMM: xq (M, K), wq (N, K) -> (M, N)."""
    return quant.dequantize(quant.dense_accumulate(xq, wq), stats[0], w_amax, bias, dtype)


def _ok(a, shape, dtype, dev):
    return (a is None or (tuple(a.shape) == tuple(shape) and a.dtype == dtype
                          and a.device == dev and a.is_contiguous() and a.data_ptr() % 16 == 0))


def supports_conv(xq, wq, residual=None) -> bool:
    """CUDA contiguous int8 NHWC codes (N, H, W, Ci), Ci % 4 == 0, with K-major
    codes (Co, 3, 3, Ci) and a bf16 (N, H, W, Co) residual or none."""
    if not (xq.is_cuda and xq.dim() == 4 and wq.dim() == 4):
        return False
    n, h, w, ci = xq.shape
    co = wq.shape[0]
    return (ci % 4 == 0 and _ok(xq, (n, h, w, ci), torch.int8, xq.device)
            and _ok(wq, (co, 3, 3, ci), torch.int8, xq.device)
            and _ok(residual, (n, h, w, co), torch.bfloat16, xq.device))


def supports_dense(xq, wq) -> bool:
    """CUDA contiguous int8 (M, K) codes, K % 16 == 0, with (N, K) codes."""
    return (xq.is_cuda and xq.dim() == 2 and wq.dim() == 2 and xq.shape[1] % 16 == 0
            and _ok(xq, xq.shape, torch.int8, xq.device)
            and _ok(wq, (wq.shape[0], xq.shape[1]), torch.int8, xq.device))


def _vectors(dev, co, w_amax, bias, stats):
    f32 = lambda a: None if a is None else a.to(torch.bfloat16).float().contiguous()
    w_amax = w_amax.float().contiguous()
    bias = f32(bias)
    for name, a in (("weight amaxes", w_amax), ("bias", bias)):
        if a is not None and (tuple(a.shape) != (co,) or a.device != dev):
            raise ValueError(f"int8 GEMM: {name} must be ({co},) on the codes' device")
    if tuple(stats.shape) != (2,) or stats.dtype != torch.float32 or stats.device != dev:
        raise ValueError("int8 GEMM: stats must be the (2,) f32 (amax, scale) on the device")
    return w_amax, bias


def _gemm(xq, wq, stats, w_amax, bias, post, residual, out, plan, conv_hwc=None):
    """One launch of csrc/int8_gemm.cu under `plan` (its split's int32
    workspace allocated here); conv_hwc: the conv's (h, w, ci)."""
    co = out.shape[-1]
    m = out.numel() // co
    h, w, ci = conv_hwc or (0, 0, 0)
    ws = (torch.empty(plan.workspace_elems, device=xq.device, dtype=torch.int32)
          if plan.workspace_elems else None)
    ptr = lambda a: None if a is None else a.data_ptr()
    return library().svdx_int8_gemm(
        xq.data_ptr(), wq.data_ptr(), ptr(stats), ptr(w_amax), ptr(bias), ptr(post),
        ptr(residual), out.data_ptr(), ptr(ws), m, co, 9 * ci if conv_hwc else xq.shape[1],
        int(conv_hwc is not None), h, w, ci, int(plan.mainloop == "tma"), plan.bn,
        plan.k_slices, plan.grid,
        torch.cuda.current_stream(xq.device).cuda_stream)


def _conv_launch(xq, stats, wq, w_amax, bias, post_shift, residual, plan=None):
    if not supports_conv(xq, wq, residual):
        raise ValueError(
            f"int8 conv kernel needs CUDA contiguous int8 NHWC codes with Ci % 4 == 0, "
            f"(Co, 3, 3, Ci) int8 codes and a contiguous bf16 residual of the output's shape; "
            f"got {tuple(xq.shape)} {xq.dtype}, {tuple(wq.shape)} {wq.dtype}, residual "
            f"{None if residual is None else (tuple(residual.shape), residual.dtype)}")
    n, h, w, ci = xq.shape
    co = wq.shape[0]
    w_amax, bias = _vectors(xq.device, co, w_amax, bias, stats)
    post = None
    if post_shift is not None:
        post = post_shift.float().contiguous()
        if tuple(post.shape) != (n, co) or post.device != xq.device:
            raise ValueError(f"int8 conv: post_shift must be {(n, co)} on the device")
    out = torch.empty((n, h, w, co), device=xq.device, dtype=torch.bfloat16)
    if plan is None:
        plan = int8_gemm_plan(n * h * w, co, ci, 9, sm_count(xq.device))
    else:
        _check_plan(plan, n * h * w, co, ci, 9)
    check(_gemm(xq, wq, stats, w_amax, bias, post, residual, out, plan, (h, w, ci)),
          "int8_conv3x3")
    int8_conv3x3.launches += 1
    return out


def _dense_launch(xq, stats, wq, w_amax, bias, plan=None):
    if not supports_dense(xq, wq):
        raise ValueError(
            f"int8 dense kernel needs CUDA contiguous int8 (M, K) and (N, K) codes with "
            f"K % 16 == 0; got {tuple(xq.shape)} {xq.dtype}, {tuple(wq.shape)} {wq.dtype}")
    m, k = xq.shape
    co = wq.shape[0]
    w_amax, bias = _vectors(xq.device, co, w_amax, bias, stats)
    out = torch.empty((m, co), device=xq.device, dtype=torch.bfloat16)
    if plan is None:
        plan = int8_gemm_plan(m, co, k, 1, sm_count(xq.device))
    else:
        _check_plan(plan, m, co, k, 1)
    check(_gemm(xq, wq, stats, w_amax, bias, None, None, out, plan), "int8_dense")
    int8_dense.launches += 1
    return out


def int8_conv3x3(xq: torch.Tensor, stats: torch.Tensor, wq: torch.Tensor, w_amax: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 post_shift: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.bfloat16, plan: Optional[GemmPlan] = None
                 ) -> torch.Tensor:
    """The W8A8 3x3 SAME conv of NHWC codes: (N, H, W, Co) in `dtype` (bf16
    on the card); `plan` in place of int8_gemm_plan's."""
    if xq.device.type == "cpu":
        return conv_reference(xq, stats, wq, w_amax, bias, post_shift, residual, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"int8 conv kernel writes bf16, not {dtype}")
    return _conv_launch(xq, stats, wq, w_amax, bias, post_shift, residual, plan)


def int8_dense(xq: torch.Tensor, stats: torch.Tensor, wq: torch.Tensor, w_amax: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16, plan: Optional[GemmPlan] = None
               ) -> torch.Tensor:
    """The W8A8 dense product of codes xq (M, K) with wq (N, K): (M, N);
    `plan` in place of int8_gemm_plan's."""
    if xq.device.type == "cpu":
        return dense_reference(xq, stats, wq, w_amax, bias, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"int8 dense kernel writes bf16, not {dtype}")
    return _dense_launch(xq, stats, wq, w_amax, bias, plan)


def dense_sums(xq: torch.Tensor, wq: torch.Tensor, plan: Optional[GemmPlan] = None
               ) -> torch.Tensor:
    """The exact int32 sums of codes xq (M, K) with wq (N, K): (M, N) int32,
    through the kernels' raw form on a CUDA tensor (counted with
    ``int8_dense``); `plan` in place of int8_gemm_plan's."""
    if xq.device.type == "cpu":
        return quant.dense_accumulate(xq, wq)
    if not supports_dense(xq, wq):
        raise ValueError(
            f"int8 dense kernel needs CUDA contiguous int8 (M, K) and (N, K) codes with "
            f"K % 16 == 0; got {tuple(xq.shape)} {xq.dtype}, {tuple(wq.shape)} {wq.dtype}")
    m, k = xq.shape
    co = wq.shape[0]
    out = torch.empty((m, co), device=xq.device, dtype=torch.int32)
    if plan is None:
        plan = int8_gemm_plan(m, co, k, 1, sm_count(xq.device))
    else:
        _check_plan(plan, m, co, k, 1)
    check(_gemm(xq, wq, None, None, None, None, None, out, plan), "int8_dense_sums")
    int8_dense.launches += 1
    return out


int8_conv3x3.launches = 0
int8_dense.launches = 0


def _in_dtype(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # the weights quantise in the activation dtype, as JAX's promote_dtype
    return weight if weight.dtype == dtype else weight.to(dtype)


def conv3x3_site(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 pre=None, post_shift: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A Conv3x3 in int8 mode (JAX blocks.py:274-304): quantise
    [silu](x·sc + sh) over [x, x2], then the int8 conv with the bias, the
    shift and the residual; weight OIHW over the full C1 + C2 width."""
    wq, w_amax = conv_codes(_in_dtype(weight, x.dtype))
    if kernels_enabled():
        xq, stats = iq.quantize(x, pre, x2)
        return int8_conv3x3(xq, stats, wq, w_amax, bias, post_shift, residual, x.dtype)
    xq, stats = iq.quantize_reference(x, pre, x2)
    return conv_reference(xq, stats, wq, w_amax, bias, post_shift, residual, x.dtype)


def linear_codes(x: torch.Tensor, gate: bool = False):
    """(codes (rows, K), stats) of a QLinear's input x (..., K), through the
    quantise kernel unless ``dispatch.plain_versions()`` is on; with `gate`,
    of h·gelu_tanh(g) of x = [h, g] (..., 2K). The self-attentions' to_q,
    to_k and to_v read one such pair (``linear_site(..., codes=)``)."""
    x2d = x.reshape(x.shape[:-1].numel(), x.shape[-1]).contiguous()
    if kernels_enabled():
        return iq.quantize(x2d, gate=gate)
    return iq.quantize_reference(x2d, gate=gate)


def linear_site(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, group=None, *, codes=None,
                gate: bool = False) -> torch.Tensor:
    """A QLinear in int8 mode (JAX transformer.py:64-66): x (..., K) with the
    nn.Linear weight (N, K) -> (..., N) in x's dtype. `codes`: x's (codes,
    stats) from ``linear_codes``, made once for the projections that share
    x. `gate`: x is net.0.proj's output [h, g] (..., 2K) and the product's
    input h·gelu_tanh(g), which the quantise kernel computes as it reads.
    With a model `group`, a row-parallel product: x and the weight are this
    rank's K columns, the int32 sums are summed over the group and
    dequantised once (with the bias); every rank of the group gets the
    whole output."""
    lead = x.shape[:-1]
    rows = lead.numel()
    w = _in_dtype(weight, x.dtype)
    wq, w_amax = dense_codes(w) if group is None else row_dense_codes(w, group)
    kernels = kernels_enabled()
    xq, stats = linear_codes(x, gate) if codes is None else codes
    k = xq.shape[-1]
    empty = rows == 0 or k == 0 or wq.shape[0] == 0
    if group is not None:
        sums = (torch.zeros((rows, wq.shape[0]), dtype=torch.int32, device=x.device)
                if empty else dense_sums(xq, wq) if kernels
                else quant.dense_accumulate(xq, wq))
        y = quant.dequantize(all_reduce_sum_(sums, group), stats[0], w_amax, bias, x.dtype)
    elif empty:
        y = quant.dequantize(torch.zeros((rows, wq.shape[0]), dtype=torch.int32,
                                         device=x.device), stats[0], w_amax, bias, x.dtype)
    elif kernels:
        y = int8_dense(xq, stats, wq, w_amax, bias, x.dtype)
    else:
        y = dense_reference(xq, stats, wq, w_amax, bias, x.dtype)
    return y.reshape(*lead, y.shape[-1])
