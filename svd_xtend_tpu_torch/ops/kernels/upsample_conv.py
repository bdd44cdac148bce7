"""Nearest 2x upsample + 3x3 SAME conv on NHWC bf16, by the parity
decomposition, on a hand kernel.

The function is ``svd_xtend_tpu/ops/upsample.py::upsample2x_conv3x3``, which
the JAX package's Upsample2D runs by default and computes in XLA (it is not
a Pallas kernel); its plain version is ``ops/upsample.py``'s
``upsample2x_conv3x3_reference``. The CUDA kernel is ``csrc/upsample_conv.cu``:
the four parity convs at the input resolution in one launch on the shared
TMA + wgmma mainloop (``csrc/sm90_gemm.cuh``), A tiles from the 3x3 im2col
map at each parity's 4 of the 9 tap offsets, B the tap-summed weights, and
an epilogue that stores each parity's rows straight into the interleaved
output. ``upsample_plan``, a pure function of the shape, picks the tile
width, the K slices and the grid.

The tap-summed weights (4, Co, 2, 2, Ci) are made once per parameter
version (``_weights.per_version``): ≤ 52 MB at 1280 channels.

On a CPU tensor ``upsample_conv`` runs the plain version; on a CUDA tensor
it launches the kernel or raises. Inside autograd (the temporal scope needs
dX through the frozen upsamplers) the backward is explicit, as conv3x3's:
the form is conv3x3 of the nearest-upsampled x, so dX is the 2x2 sum of
dU = conv3x3_input_grad(dy) (conv3x3's dU kernel), dW the 3x3 conv's weight
gradient over the upsampled x (``aten.convolution_backward``), db the sum of
dy. The plain version's VJP gave other bits from run to run on the card
(cuDNN's backward-data for the 2x2 parity convs at the UNet's 5x8 and 10x16
levels; H100 80GB HBM3), which a bit-equal resume cannot have.
"""

from __future__ import annotations

import functools

import torch

from .. import video
from ..upsample import tap_sums, upsample2x_conv3x3_reference
from . import conv3x3 as cvk
from ._build import check, library
from ._weights import per_version
from .gemm_plan import BM, K_TILE, SM_COUNT, GemmPlan, plan_gemm, sm_count

# the tile widths csrc/upsample_conv.cu instantiates (SVDX_UPSAMPLE_TILE_N)
UPSAMPLE_TILE_N = (128, 160, 256)
ROWS_A_WARPGROUP = 64    # the rows a consumer warpgroup's epilogue stores


def supports(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Structural dispatch predicate: a CUDA bf16 contiguous 16-byte aligned
    (N, H, W, Ci) with an OIHW (Co, Ci, 3, 3) weight, Ci a multiple of 64
    (a K tile is 64 channels of one tap) and Co of 8. Any H and W."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()
            and x.data_ptr() % 16 == 0 and weight.dim() == 4
            and tuple(weight.shape[1:]) == (x.shape[-1], 3, 3)):
        return False
    return x.shape[3] % K_TILE == 0 and weight.shape[0] % 8 == 0


def store_run(w: int) -> int:
    """The output pixels one TMA store of the epilogue writes (the .cu's
    store_run): W where W divides 64 (64/W whole image rows a store), else
    gcd(W, 64), so that no store crosses an image row."""
    return w if ROWS_A_WARPGROUP % w == 0 else min(w & -w, ROWS_A_WARPGROUP)


def tile_widths(w: int) -> tuple:
    """The tile widths the kernel takes at image width W: where a
    warpgroup's rows go out in several stores (W neither divides 64 nor is
    a multiple of it), each store's first row must be 128-byte aligned in
    shared memory: run x tile width x 2 bytes a multiple of 128."""
    run = store_run(w)
    several = run < w and run < ROWS_A_WARPGROUP
    return tuple(b for b in UPSAMPLE_TILE_N if not several or run * b * 2 % 128 == 0)


def padded_rows(n: int, h: int, w: int) -> int:
    """Rows of one parity's GEMM: N·H·W up to whole 128-row tiles, so that
    no tile spans two parities."""
    return -(-n * h * w // BM) * BM


@functools.cache
def upsample_plan(n: int, h: int, w: int, ci: int, co: int, sms: int = SM_COUNT) -> GemmPlan:
    """The launch plan of an (n, h, w, ci) -> (n, 2h, 2w, co) upsample on a
    card of `sms` SMs: the four parities' rows one after the other (M = 4 ·
    padded_rows), N = co, K = 4·ci, a tile width that W takes
    (``tile_widths``). Memoized, as conv3x3_plan."""
    return plan_gemm(4 * padded_rows(n, h, w), co, 4 * ci // K_TILE, tile_widths(w), sms)


# the kernel's B: the bf16 tap sums, made once per weight version
_tap_summed = per_version(lambda wt: tap_sums(wt, torch.bfloat16).contiguous())


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            plan: GemmPlan = None) -> torch.Tensor:
    if not supports(x, weight):
        raise ValueError(
            f"upsample_conv kernel needs a CUDA bf16 contiguous (N, H, W, Ci) and a (Co, Ci, 3, "
            f"3) weight with Ci % {K_TILE} == 0 and Co % 8 == 0; got {tuple(x.shape)} "
            f"{x.dtype} contiguous="
            f"{x.is_contiguous()}, weight {tuple(weight.shape)}")
    n, h, w, ci = x.shape
    co = weight.shape[0]
    if tuple(bias.shape) != (co,) or bias.device != x.device:
        raise ValueError(f"upsample_conv: bias must be ({co},) on x's device")
    wt = _tap_summed(weight)
    b = bias.to(torch.bfloat16).float().contiguous()
    out = torch.empty((n, 2 * h, 2 * w, co), device=x.device, dtype=torch.bfloat16)
    if plan is None:
        plan = upsample_plan(n, h, w, ci, co, sm_count(x.device))
    ws = (torch.empty(plan.workspace_elems, device=x.device, dtype=torch.float32)
          if plan.workspace_elems else None)
    check(library().svdx_upsample_conv(
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), n, h, w, ci, co, plan.bn, plan.k_slices,
        plan.grid, torch.cuda.current_stream(x.device).cuda_stream), "upsample_conv")
    upsample_conv.launches += 1
    return out


class _UpsampleFunction(torch.autograd.Function):
    """Forward through `kernel`; the explicit backward (the module
    docstring), its dU through `input_grad_kernel`."""

    @staticmethod
    def forward(ctx, x, weight, bias, kernel, input_grad_kernel):
        ctx.save_for_backward(x, weight)
        ctx.input_grad_kernel = input_grad_kernel
        return kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous()
        dx = dw = db = None
        if need_x:
            n, h, w, c = x.shape
            du = cvk.conv3x3_input_grad(dy, weight, kernel=ctx.input_grad_kernel)
            dx = du.float().view(n, h, 2, w, 2, c).sum((2, 4)).to(x.dtype)
        if need_w:
            up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            dw = torch.ops.aten.convolution_backward(
                video.nchw(dy), video.nchw(up), weight, None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], 1, [False, True, False])[1]
        if need_b:
            db = dy.float().sum((0, 1, 2)).to(dy.dtype)
        return dx, dw, db, None, None


def upsample_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                  kernel=None) -> torch.Tensor:
    """conv3x3(nearest_upsample_2x(x)) + bias: (N, H, W, Ci) -> (N, 2H, 2W,
    Co), OIHW weight. ``kernel`` replaces the CUDA launch, and conv3x3's
    plain version then replaces its dU launch in the backward (the CPU tests
    pass the plain version to run the explicit backward without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return upsample2x_conv3x3_reference(x, weight, bias)
        kernel, input_grad_kernel = _launch, cvk._launch_input_grad
    else:
        input_grad_kernel = cvk.conv3x3_fused_reference
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, weight, bias)):
        return _UpsampleFunction.apply(x, weight, bias, kernel, input_grad_kernel)
    return kernel(x, weight, bias)


upsample_conv.launches = 0
