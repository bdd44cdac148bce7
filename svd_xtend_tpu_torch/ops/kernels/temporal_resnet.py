"""Fused temporal resnet + collapsed blend on (B, F, S, C).

Port of ``svd_xtend_tpu/ops/pallas/temporal_resnet.py``:
``temporal_resnet_block`` (its kernels ``_kernel_a`` and ``_kernel_b``, with
the plain versions ``conv_a_reference`` and ``conv_b_reference``), the plain
``temporal_resnet_reference`` and ``_fold_from_channel_sums``.

    out = x + w·conv2(gn2silu(conv1(gn1silu(x)) + b1 + temb))

The CUDA kernels are ``csrc/temporal_resnet.cu``: each (3, 1) frame conv is
the GroupNorm normalise + SiLU of its input as a pass of its own, then an
implicit GEMM with K = 3·C on the shared Hopper mainloop of
``csrc/sm90_gemm.cuh``, its A tiles by TMA's im2col mode over (B, F, S, C)
(the out-of-frame taps read as zeros). Kernel A adds b1 and the per-frame
temb, writes norm2's statistics of its stored bf16 output as
per-(sample, 64-row chunk) partials (``groupnorm.stats_slots``) and, after
its last tile, meets every block at a grid barrier (a cooperative launch of
its persistent grid) and folds them into norm2's (sc2, sh2) on its
consumers, in the order of the fold launch this replaces
(``groupnorm.fold_order_reference``); kernel B adds the residual,
out = x + w·(conv2 + b2), with the blend weight w an f32 scalar on the
device (the JAX package folds w into conv2's weights; here the weights are
packed once per parameter version, ``packed``). The launch plan is
``gemm_plan.tresnet_plan``, a pure function of the shape. norm1's fold is
one launch of the fold's kernel (``group_norm_fold``), so a block is three
launches: the fold, A and B.

On a CPU tensor ``temporal_resnet_block`` runs the reference; on a CUDA
tensor it launches the kernels or raises. The backward recomputes the
reference and differentiates it, the blend weight ``w`` included
(temporal_resnet.py:318 in the JAX package). Weights are taps (3, C, C):
``out[f] = x[f-1] @ k[0] + x[f] @ k[1] + x[f+1] @ k[2] + b``.
"""

from __future__ import annotations

import torch

from ._autograd import differentiable
from ._build import check, library
from ._weights import per_version
from .gemm_plan import sm_count, tresnet_plan
from .groupnorm import (check_fold_shape, fold_affine, fold_barrier, fold_from_channel_sums,
                        fold_scratch, group_norm_fold, group_norm_silu_reference, stream_of)

CHANNEL_MULTIPLE = 64    # K tiles of 64 channels of one frame tap


def temporal_conv_reference(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The TemporalConv math: three frame-shifted channel matmuls."""
    zero = torch.zeros_like(x[:, :1])
    prev = torch.cat([zero, x[:, :-1]], dim=1)
    nxt = torch.cat([x[:, 1:], zero], dim=1)
    return prev @ k[0] + x @ k[1] + nxt @ k[2] + b


def temporal_resnet_reference(x, t, k1, b1, k2, b2, scale1, bias1, scale2,
                              bias2, w, groups: int, eps: float) -> torch.Tensor:
    """Plain oracle: x + w·conv2(gn2silu(conv1(gn1silu(x)) + b1 + t)).
    x: (B, F, S, C); t: (B, F, C); k1/k2: (3, C, C); w: scalar tensor."""
    h = group_norm_silu_reference(x, scale1, bias1, groups, eps)
    h = temporal_conv_reference(h, k1, b1) + t[:, :, None, :].to(x.dtype)
    h2 = group_norm_silu_reference(h, scale2, bias2, groups, eps)
    h2 = temporal_conv_reference(h2, k2, b2)
    return (x.float() + w.float() * h2.float()).to(x.dtype)


def supports(x: torch.Tensor) -> bool:
    """Structural dispatch predicate: a CUDA bf16 (B, F, S, C) the kernels
    take (C a multiple of the 64-channel K tile)."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
            and x.shape[-1] % CHANNEL_MULTIPLE == 0)


def pack_taps(k: torch.Tensor) -> torch.Tensor:
    """Taps (3, C, Co) -> the kernel's (Co, 3C) bf16 with k = tap·C + ci."""
    return k.permute(2, 0, 1).reshape(k.shape[2], -1).to(torch.bfloat16).contiguous()


# (packed taps, f32 bias) of a conv, made once per parameter version
packed = per_version(lambda k, b: (pack_taps(k), b.float().contiguous()))


def _activate(x, sc, sh):
    """silu(x·sc + sh) per (sample, channel), rounded to x's dtype."""
    a = x.float() * sc[:, None, None, :] + sh[:, None, None, :]
    return (a * torch.sigmoid(a)).to(x.dtype)


def conv_a_f32_reference(x, k, bias, sc, sh, t):
    """Plain kernel A's h in f32, before its rounding to x's dtype."""
    return (temporal_conv_reference(_activate(x, sc, sh).float(), k.float(), bias.float())
            + t.float()[:, :, None, :])


def conv_a_reference(x, k, bias, sc, sh, t):
    """Plain kernel A on taps k (3, C, C): (h, per-sample channel sum, sum of
    squares of the stored h), the sums (B, C) over all F·S positions."""
    h = conv_a_f32_reference(x, k, bias, sc, sh, t).to(x.dtype)
    hf = h.float().flatten(1, 2)
    return h, hf.sum(1), (hf * hf).sum(1)


# Kernel A's channel sums against conv_a_reference's, as the largest
# difference over the largest sum. The two h round f32 sums of the same
# products taken in another order, so they differ by 1 bf16 ulp here and
# there, with either sign: over a sample of n rows that moves a sum by about
# sqrt(n) such ulps, a relative ~1/sqrt(n). A biased rounding of h (truncation)
# moves every row the same way, ~2^-8 of the sums at any n.
SUMS_TOLERANCE_SCALE = 8e-3


def sums_tolerance(rows_per_sample: int) -> float:
    """The bound on kernel A's channel sums against conv_a_reference's."""
    return SUMS_TOLERANCE_SCALE / rows_per_sample ** 0.5


def norm2_fold_reference(h, scale2, bias2, groups: int, eps: float):
    """Plain kernel A's fold of norm2: (sc2, sh2) from the channel sums of
    the stored h (B, F, S, C)."""
    hf = h.float().flatten(1, 2)
    return fold_from_channel_sums(hf.sum(1), (hf * hf).sum(1), hf.shape[1], scale2, bias2,
                                  groups, eps)


def conv_b_reference(h, k, bias, sc, sh, res, w):
    """Plain kernel B on taps k (3, C, C): res + w·(conv(silu(h·sc + sh)) +
    bias), w the blend weight."""
    acc = temporal_conv_reference(_activate(h, sc, sh).float(), k.float(), bias.float())
    return (res.float() + w.float() * acc).to(h.dtype)


def _launch(x, wt, bias, sc, sh, extra, w, out, first: bool, norm2=None, plan=None) -> None:
    """One kernel on the shape's plan (tests pass others); kernel A with
    norm2 = (scratch, scale2, bias2, groups, eps), its statistics partials
    and (sc2, sh2) in the scratch (``fold_scratch``)."""
    b, f, s, c = x.shape
    if plan is None:
        plan = tresnet_plan(b, f, s, c, sm_count(x.device))
    for a in (x, wt, bias, sc, sh, extra, w, out):
        if a is not None and (not a.is_contiguous() or a.data_ptr() % 16 or a.device != x.device):
            raise ValueError("temporal_resnet: every operand must be contiguous, 16-byte "
                             "aligned and on x's device")
    u = torch.empty_like(x)     # the prologue's output
    ws = (torch.empty(plan.workspace_elems, device=x.device, dtype=torch.float32)
          if plan.workspace_elems else None)
    ptr = lambda a: None if a is None else a.data_ptr()
    stream = stream_of(x.device)
    psum = psq = scf = bif = sc2 = sh2 = bar = None
    groups, bf16, eps = 0, 0, 0.0
    if first:
        (psum, psq, sc2, sh2), scale2, bias2, groups, eps = norm2
        check_fold_shape(b, f * s, c, groups)
        scf, bif, bf16 = fold_affine(scale2, bias2)
        if scf.shape != (c,) or bif.shape != (c,):
            raise ValueError(f"temporal_resnet: norm2's scale and bias must be ({c},)")
        bar = fold_barrier(x.device, stream)
    err = library().svdx_temporal_resnet_conv(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), sc.data_ptr(), sh.data_ptr(),
        u.data_ptr(), extra.data_ptr(), ptr(w), out.data_ptr(), ptr(psum), ptr(psq), ptr(ws),
        ptr(scf), ptr(bif), ptr(sc2), ptr(sh2), ptr(bar), b, f, s, c, int(first),
        plan.bn, plan.k_slices, plan.grid, groups, bf16, float(eps), stream)
    check(err, "temporal_resnet_conv_a" if first else "temporal_resnet_conv_b")


def conv_a(x, wt, bias, sc, sh, t, scale2, bias2, groups: int, eps: float, plan=None):
    """Kernel A: h = conv(silu(x·sc + sh)) + bias + t[b, f] on the packed
    taps wt (C, 3C) and the f32 bias, norm2's statistics of the stored h and
    their fold with norm2's affine (scale2, bias2): (h, psum, psq, sc2, sh2),
    the partials (B, stats_slots(F·S), C) f32, (sc2, sh2) (B, C) f32 (all
    but h views of one allocation). ``plan`` replaces the shape's launch
    plan (tests and chip_smoke compare plans)."""
    b, f, s, c = x.shape
    h = torch.empty_like(x)
    scratch = fold_scratch(b, f * s, c, x.device)
    _launch(x, wt, bias, sc, sh, t, None, h, True, (scratch, scale2, bias2, groups, eps), plan)
    conv_a.launches += 1
    return h, scratch.psum, scratch.psq, scratch.sc, scratch.sh


def conv_b(h, wt, bias, sc, sh, res, w):
    """Kernel B: res + w·(conv(silu(h·sc + sh)) + bias), w one f32 on the
    device."""
    out = torch.empty_like(h)
    _launch(h, wt, bias, sc, sh, res, w, out, False)
    conv_b.launches += 1
    return out


conv_a.launches = 0
conv_b.launches = 0


def affine_silu(x, sc, sh):
    """The kernels' prologue pass alone, u = bf16(silu(x·sc + sh)) on (B, F,
    S, C), as ``_activate``: for timing it apart from the GEMM."""
    b, f, s, c = x.shape
    u = torch.empty_like(x)
    check(library().svdx_affine_silu(x.data_ptr(), sc.data_ptr(), sh.data_ptr(), u.data_ptr(),
                                     b * f * s, c, f * s,
                                     torch.cuda.current_stream(x.device).cuda_stream),
          "affine_silu")
    return u


def _validate(x, t, k1, k2):
    if not supports(x):
        raise ValueError(
            "temporal_resnet kernels need a CUDA bf16 (B, F, S, C) with "
            f"C % {CHANNEL_MULTIPLE} == 0; got {tuple(x.shape)} {x.dtype}")
    b, f, _, c = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("temporal_resnet: x must be contiguous, 16-byte aligned")
    if t.shape != (b, f, c):
        raise ValueError(f"temporal_resnet: temb must be {(b, f, c)}, got {tuple(t.shape)}")
    for name, k in (("k1", k1), ("k2", k2)):
        if k.shape != (3, c, c):
            raise ValueError(f"temporal_resnet: {name} must be {(3, c, c)}")


def temporal_resnet_block(x, t, k1, b1, k2, b2, scale1, bias1, scale2, bias2,
                          w, *, groups: int = 32, eps: float = 1e-5, kernel=None):
    """Fused temporal resnet + blend; semantics of temporal_resnet_reference.
    ``kernel`` replaces the CUDA launches (the CPU tests pass the reference
    to run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return temporal_resnet_reference(x, t, k1, b1, k2, b2, scale1, bias1,
                                             scale2, bias2, w, groups, eps)
        kernel = _launch_block
    return differentiable(kernel, temporal_resnet_reference, x, t, k1, b1, k2, b2,
                          scale1, bias1, scale2, bias2, w, groups=groups, eps=eps)


def _launch_block(x, t, k1, b1, k2, b2, scale1, bias1, scale2, bias2, w, *,
                  groups: int, eps: float):
    """Three launches: norm1's fold, kernel A (which folds norm2) and kernel B
    on A's (sc2, sh2)."""
    _validate(x, t, k1, k2)
    sc1, sh1 = group_norm_fold(x, scale1, bias1, groups=groups, eps=eps)
    wt1, b1f = packed(k1, b1)
    wt2, b2f = packed(k2, b2)
    h, _, _, sc2, sh2 = conv_a(x, wt1, b1f, sc1, sh1, t.to(x.dtype).contiguous(), scale2,
                               bias2, groups, eps)
    return conv_b(h, wt2, b2f, sc2, sh2, x, w.float().reshape(1))
