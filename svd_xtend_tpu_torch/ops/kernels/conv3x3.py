"""3x3 stride-1 SAME conv on NHWC activations with the GN-fold epilogues.

Port of ``svd_xtend_tpu/ops/pallas/conv3x3.py``: ``conv3x3_pallas`` (its
kernel ``_kernel`` through ``_conv3x3_fwd_impl``), its custom VJP
(``_conv3x3_vjp_bwd``) and the plain ``conv3x3_fused_reference``, which is
the contract:

    y = conv3x3([silu](x·sc + sh)) + bias [+ post_shift[n, co]] [+ residual]

with the per-(sample, input channel) f32 affine (the folded GroupNorm) and
SiLU rounded to x's dtype before the conv, f32 accumulation, the bias, the
(N, Co) f32 shift and the residual added in f32, one cast. The CUDA kernels
are ``csrc/conv3x3.cu``: an elementwise prologue pass writing the
transformed input u (bf16, the wrapper allocates it), then an implicit GEMM
on the shared TMA + wgmma mainloop of ``csrc/sm90_gemm.cuh``, whose A tiles
come by TMA's im2col mode (the SAME padding read as zeros) and whose
epilogue adds the bias, shift and residual. ``conv3x3_plan``, a pure
function of the shape, picks the mainloop (the first, mma.sync kernel where
Ci % 64 != 0: the UNet's conv_in), the tile width, the K slices and the
grid; the wrapper passes it to the launcher. The source says why the
prologue is a pass of its own and not part of the conv's loads.

Weights are the ``nn.Conv2d`` OIHW parameter. The kernel reads them as
(Co, 3, 3, Ci), which is the OIHW tensor's permute when it is stored in
``torch.channels_last`` (the ``Conv3x3`` module does so): then no copy is
made per call.

The backward (``_Conv3x3Function``) is JAX's ``_conv3x3_vjp_bwd``: it saves
x, the weight, sc and sh (not the transformed input u, which it
recomputes), takes dU with the same forward kernel on dy and the flipped,
in/out-swapped weight (``conv3x3_input_grad``, rounded to dy's dtype as JAX
does), and dW as a weight-gradient conv of u and dy, which JAX leaves to
``lax.conv`` and the port to ``aten.convolution_backward`` (cuDNN on the
card). db, dpost, dres, dx, dsc and dsh follow JAX's formulas.

On a CPU tensor ``conv3x3`` runs the plain version, differentiated by
autograd; on a CUDA tensor it launches the kernel or raises. The TPU
dispatch gates (an autotune table and margins measured on a v5e) do not
carry over: on CUDA the models take the kernel wherever ``supports`` admits
the call (``models/blocks.py::Conv3x3``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import video
from ._build import check, library
from .gemm_plan import K_TILE, SM_COUNT, GemmPlan, mma_plan, plan_gemm, sm_count

CHANNEL_MULTIPLE = 8     # one 16-byte load is 8 channels of one tap
# the tile widths csrc/conv3x3.cu instantiates (SVDX_CONV_TILE_N)
CONV_TILE_N = (8, 128, 160, 256)


def apply_pre_affine(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                     silu: bool) -> torch.Tensor:
    """[silu](x·sc + sh) in f32 with a per-(N, C) affine, rounded to x's
    dtype (a folded GroupNorm normalise; JAX's ``_apply_pre_affine``)."""
    xv = x.float() * sc.float()[:, None, None, :] + sh.float()[:, None, None, :]
    if silu:
        xv = xv * torch.sigmoid(xv)
    return xv.to(x.dtype)


def conv3x3_fused_reference(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            pre_scale: Optional[torch.Tensor] = None,
                            pre_shift: Optional[torch.Tensor] = None,
                            post_shift: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            pre_silu: bool = False) -> torch.Tensor:
    """Plain version: (N, H, W, Ci) x OIHW (Co, Ci, 3, 3) -> (N, H, W, Co).
    pre_scale/pre_shift: (N, Ci) f32; post_shift: (N, Co) f32; residual
    (N, H, W, Co). The f32 conv of x-dtype values stands for the f32
    accumulation of x-dtype products."""
    dt = x.dtype
    if pre_scale is not None:
        x = apply_pre_affine(x, pre_scale, pre_shift, pre_silu)
    y = video.nhwc(F.conv2d(video.nchw(x).float(), weight.to(dt).float(), padding=1))
    if bias is not None:
        y = y + bias.to(dt).float()
    if post_shift is not None:
        y = y + post_shift.float()[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(dt)


def flipped_weight(weight: torch.Tensor) -> torch.Tensor:
    """The OIHW weight of dU = conv3x3(dy): spatially flipped, in and out
    channels swapped (JAX's ``flip(kernel, (0, 1)).swapaxes(2, 3)``)."""
    return weight.flip(2, 3).transpose(0, 1)


def conv3x3_input_grad_reference(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain dU: the plain forward on dy with the flipped weight, no bias,
    in dy's dtype."""
    return conv3x3_fused_reference(dy, flipped_weight(weight), None)


def supports(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Structural dispatch predicate: a CUDA bf16 contiguous (N, H, W, Ci)
    with a (Co, Ci, 3, 3) weight, Ci and Co multiples of 8."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
            and x.is_contiguous() and weight.dim() == 4
            and tuple(weight.shape[1:]) == (x.shape[-1], 3, 3)
            and x.shape[-1] % CHANNEL_MULTIPLE == 0
            and weight.shape[0] % CHANNEL_MULTIPLE == 0)


@functools.cache
def conv3x3_plan(n: int, h: int, w: int, ci: int, co: int, sms: int = SM_COUNT) -> GemmPlan:
    """The launch plan of an (n, h, w, ci) -> co conv on a card of `sms` SMs:
    the implicit GEMM M = n·h·w, N = co, K = 9·ci. Where ci % 64 == 0 the TMA
    mainloop (a K tile is 64 channels of one tap; 8-wide tiles only for
    co <= 8), else the mma.sync mainloop. Memoized: a launch's host time
    is on the path, and choosing a plan costs ~0.2 ms."""
    m = n * h * w
    if ci % K_TILE:
        return mma_plan(m, co, -(-9 * ci // 32))
    widths = tuple(b for b in CONV_TILE_N if (b == 8) == (co <= 8))
    return plan_gemm(m, co, 9 * ci // K_TILE, widths, sms)


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _run(x, weight, bias, pre_scale, pre_shift, post_shift, residual, pre_silu,
         plan=None):
    if not supports(x, weight):
        raise ValueError(
            f"conv3x3 kernel needs a CUDA bf16 contiguous (N, H, W, Ci) and a "
            f"(Co, Ci, 3, 3) weight with Ci, Co multiples of {CHANNEL_MULTIPLE}; got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}, weight "
            f"{tuple(weight.shape)}")
    n, h, w, ci = x.shape
    co = weight.shape[0]
    f32 =lambda a: None if a is None else a.float().contiguous()
    wk = weight.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    bias, sc, sh, post = f32(bias), f32(pre_scale), f32(pre_shift), f32(post_shift)
    for name, a, shape in (("bias", bias, (co,)), ("pre_scale", sc, (n, ci)),
                           ("pre_shift", sh, (n, ci)), ("post_shift", post, (n, co))):
        if a is not None and (tuple(a.shape) != shape or a.device != x.device):
            raise ValueError(f"conv3x3: {name} must be {shape} on x's device, got "
                             f"{tuple(a.shape)}")
    if residual is not None and (tuple(residual.shape) != (n, h, w, co)
                                 or residual.dtype != torch.bfloat16
                                 or not residual.is_contiguous()
                                 or residual.device != x.device):
        raise ValueError(f"conv3x3: residual must be a contiguous bf16 {(n, h, w, co)}")
    out = torch.empty((n, h, w, co), device=x.device, dtype=torch.bfloat16)
    u = torch.empty_like(x) if sc is not None else None   # the prologue's output
    for a in (x, wk, bias, sc, sh, post, residual):
        if a is not None and a.data_ptr() % 16:
            raise ValueError("conv3x3: every operand must be 16-byte aligned")
    if plan is None:
        plan = conv3x3_plan(n, h, w, ci, co, sm_count(x.device))
    ws = (torch.empty(plan.workspace_elems, device=x.device, dtype=torch.float32)
          if plan.workspace_elems else None)
    err = library().svdx_conv3x3(
        x.data_ptr(), wk.data_ptr(), _ptr(bias), _ptr(sc), _ptr(sh), _ptr(u), _ptr(post),
        _ptr(residual), out.data_ptr(), _ptr(ws), n, h, w, ci, co, int(bool(pre_silu)),
        int(plan.mainloop == "tma"), plan.bn, plan.k_slices, plan.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "conv3x3")
    return out


def _launch(x, weight, bias, pre_scale=None, pre_shift=None, post_shift=None,
            residual=None, pre_silu=False) -> torch.Tensor:
    out = _run(x, weight, bias, pre_scale, pre_shift, post_shift, residual, pre_silu)
    conv3x3.launches += 1
    return out


def _launch_input_grad(dy, weight, bias=None, pre_scale=None, pre_shift=None,
                       post_shift=None, residual=None, pre_silu=False) -> torch.Tensor:
    out = _run(dy, weight, bias, pre_scale, pre_shift, post_shift, residual, pre_silu)
    conv3x3_input_grad.launches += 1
    return out


def conv3x3_input_grad(dy: torch.Tensor, weight: torch.Tensor, *, kernel=None) -> torch.Tensor:
    """dU of conv3x3 with respect to its (transformed) input: the forward
    kernel on dy (N, H, W, Co) with ``flipped_weight(weight)`` and no
    epilogue, in dy's dtype. ``kernel`` replaces the CUDA launch."""
    if kernel is None:
        kernel = conv3x3_fused_reference if dy.device.type == "cpu" else _launch_input_grad
    return kernel(dy.contiguous(), flipped_weight(weight), None)


class _Conv3x3Function(torch.autograd.Function):
    """Forward through `kernel`; the explicit backward of JAX's
    ``_conv3x3_vjp_bwd``, its dU through `input_grad_kernel`."""

    @staticmethod
    def forward(ctx, x, weight, bias, pre_scale, pre_shift, post_shift, residual,
                pre_silu, kernel, input_grad_kernel):
        ctx.save_for_backward(x, weight, pre_scale, pre_shift)
        ctx.pre_silu, ctx.input_grad_kernel = pre_silu, input_grad_kernel
        return kernel(x, weight, bias, pre_scale, pre_shift, post_shift, residual, pre_silu)

    @staticmethod
    def backward(ctx, dy):
        x, weight, sc, sh = ctx.saved_tensors
        need_x, need_w, need_b, need_sc, need_sh, need_post, need_res = ctx.needs_input_grad[:7]
        dy = dy.contiguous()
        dyf = dy.float()
        db = dyf.sum((0, 1, 2)).to(dy.dtype) if need_b else None
        dpost = dyf.sum((1, 2)) if need_post else None
        dres = dy if need_res else None
        u = x
        if sc is not None:
            v = x.float() * sc[:, None, None, :] + sh[:, None, None, :]
            if ctx.pre_silu:
                sig = torch.sigmoid(v)
                u = (v * sig).to(x.dtype)
            else:
                u = v.to(x.dtype)
        dx = dw = dsc = dsh = None
        if need_x or need_sc or need_sh:
            du = conv3x3_input_grad(dy, weight, kernel=ctx.input_grad_kernel).float()
            if sc is not None:
                dv = du * (sig * (1.0 + v * (1.0 - sig))) if ctx.pre_silu else du
                dx = (dv * sc[:, None, None, :]).to(x.dtype) if need_x else None
                dsc = (dv * x.float()).sum((1, 2)) if need_sc else None
                dsh = dv.sum((1, 2)) if need_sh else None
            else:
                dx = du.to(x.dtype)
        if need_w:
            dw = torch.ops.aten.convolution_backward(
                video.nchw(dy), video.nchw(u), weight, None, [1, 1], [1, 1], [1, 1],
                False, [0, 0], 1, [False, True, False])[1]
        return dx, dw, db, dsc, dsh, dpost, dres, None, None, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
            pre_scale: Optional[torch.Tensor] = None,
            pre_shift: Optional[torch.Tensor] = None, pre_silu: bool = False,
            post_shift: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None, kernel=None) -> torch.Tensor:
    """y = conv3x3([silu](x·sc + sh)) + bias [+ post_shift] [+ residual]
    on (N, H, W, Ci) with the OIHW weight. ``kernel`` replaces the CUDA
    launch, for the forward and for dU (the CPU tests pass the plain version
    to run the explicit backward without a card)."""
    if (pre_scale is None) != (pre_shift is None):
        raise ValueError("conv3x3: pre_scale and pre_shift must be given together")
    if kernel is None:
        if x.device.type == "cpu":
            return conv3x3_fused_reference(x, weight, bias, pre_scale, pre_shift,
                                           post_shift, residual, pre_silu)
        kernel, input_grad_kernel = _launch, _launch_input_grad
    else:
        input_grad_kernel = kernel
    tensors = (x, weight, bias, pre_scale, pre_shift, post_shift, residual)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in tensors):
        return _Conv3x3Function.apply(*tensors, bool(pre_silu), kernel, input_grad_kernel)
    return kernel(*tensors, bool(pre_silu))


conv3x3.launches = 0             # forward launches
conv3x3_input_grad.launches = 0  # dU launches in the backward
