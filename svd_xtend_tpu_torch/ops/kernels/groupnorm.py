"""GroupNorm(+SiLU) over channels-last (N, ..., C) tensors, and the GN fold.

Port of ``svd_xtend_tpu/ops/pallas/groupnorm.py``: ``group_norm_silu`` (its
kernels ``_gn_silu_kernel``, ``_stats_kernel`` and ``_norm_kernel``), the plain
``group_norm_silu_reference``, and the plain-torch ``group_norm_fold`` (XLA
code in the JAX package, so plain torch here too).

The kernels are Triton, written in two passes:
  stats - grid (group, split, sample): each program sums x and x² in f32 over
          a slice of the sequence for one (sample, group), into a
          (N, G, splits) buffer (deterministic: no atomics);
  norm  - grid (sequence block, channel block, sample): each program sums its
          channels' group partials, forms mean and 1/sqrt(var + eps) with the
          variance clamped at 0 (groupnorm.py:63-64), and writes
          (x - mean)·inv·scale + bias (+ SiLU) in the input dtype.
GroupNorm has no matrix product: it reads x twice and writes it once, so it
is bound by device-memory bytes. The split over the sequence puts enough
programs in flight to fill the card when N·G is small, and consecutive
programs of the stats grid read neighbouring groups of the same rows, so
their narrow column slices share L2 lines.

On a CPU tensor ``group_norm_silu`` runs the reference; on a CUDA tensor it
launches the kernels or raises. The backward recomputes the reference and
differentiates it (groupnorm.py:265 in the JAX package).
"""

from __future__ import annotations

import functools
import os

import torch

from ._autograd import differentiable
from ._build import BUILD_DIR

_FLOAT_TYPES = (torch.bfloat16, torch.float16, torch.float32)


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, groups: int, eps: float,
                              silu: bool = True) -> torch.Tensor:
    """GN over all non-batch axes, affine, optional SiLU; x: (N, ..., C)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = out * scale.float() + bias.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def fold_from_channel_sums(sum_c: torch.Tensor, sq_c: torch.Tensor,
                           count: int, scale: torch.Tensor, bias: torch.Tensor,
                           groups: int, eps: float):
    """(sc, sh) f32 with GN(h)·scale + bias == h·sc + sh, from per-channel
    sums and sums of squares (N, C) over `count` positions."""
    n, c = sum_c.shape
    gs = c // groups
    denom = float(count * gs)
    mean = sum_c.reshape(n, groups, gs).sum(2) / denom
    var = torch.clamp(sq_c.reshape(n, groups, gs).sum(2) / denom - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(gs, dim=1)
    inv_c = inv.repeat_interleave(gs, dim=1)
    sc = inv_c * scale.float()[None, :]
    sh = bias.float()[None, :] - mean_c * sc
    return sc, sh


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm stats + affine folded into a per-(sample, channel) f32
    affine (sc, sh): GN(x)·scale + bias == x·sc + sh (before any SiLU)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c).float()
    return fold_from_channel_sums(xf.sum(1), (xf * xf).sum(1), xf.shape[1],
                                  scale, bias, groups, eps)


@functools.cache
def _triton_kernels():
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, psum_ptr, psq_ptr, S, C, GS, ROWS,
                     BLOCK_S: tl.constexpr, BLOCK_G: tl.constexpr):
        g = tl.program_id(0)
        split = tl.program_id(1)
        n = tl.program_id(2)
        n_split = tl.num_programs(1)
        offs_g = tl.arange(0, BLOCK_G)
        cols = g * GS + offs_g
        cmask = offs_g < GS
        base = x_ptr + n.to(tl.int64) * S * C
        start = split * ROWS
        end = tl.minimum(start + ROWS, S)
        acc = tl.zeros((BLOCK_S, BLOCK_G), tl.float32)
        acc2 = tl.zeros((BLOCK_S, BLOCK_G), tl.float32)
        for r0 in range(start, end, BLOCK_S):
            rows = r0 + tl.arange(0, BLOCK_S)
            m = (rows < end)[:, None] & cmask[None, :]
            xv = tl.load(base + rows[:, None].to(tl.int64) * C + cols[None, :],
                         mask=m, other=0.0).to(tl.float32)
            acc += xv
            acc2 += xv * xv
        out = (n * tl.num_programs(0) + g) * n_split + split
        tl.store(psum_ptr + out, tl.sum(tl.sum(acc, axis=1), axis=0))
        tl.store(psq_ptr + out, tl.sum(tl.sum(acc2, axis=1), axis=0))

    @triton.jit
    def norm_kernel(x_ptr, y_ptr, w_ptr, b_ptr, psum_ptr, psq_ptr, S, C, GS,
                    G, n_split, inv_count, eps, SILU: tl.constexpr,
                    BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                    BLOCK_SPLIT: tl.constexpr):
        sb = tl.program_id(0)
        cb = tl.program_id(1)
        n = tl.program_id(2)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cm = cols < C
        grp = cols // GS
        sp = tl.arange(0, BLOCK_SPLIT)
        pidx = (n * G + grp)[:, None] * n_split + sp[None, :]
        pm = cm[:, None] & (sp < n_split)[None, :]
        tot = tl.sum(tl.load(psum_ptr + pidx, mask=pm, other=0.0), axis=1)
        tot2 = tl.sum(tl.load(psq_ptr + pidx, mask=pm, other=0.0), axis=1)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        a = tl.rsqrt(var + eps) * tl.load(w_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        bb = tl.load(b_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        rows = sb * BLOCK_S + tl.arange(0, BLOCK_S)
        m = (rows < S)[:, None] & cm[None, :]
        off = n.to(tl.int64) * S * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        xv = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        y = (xv - mean[None, :]) * a[None, :] + bb[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=m)

    return triton, stats_kernel, norm_kernel


def _pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def supports(x: torch.Tensor, groups: int) -> bool:
    """Structural dispatch predicate: a CUDA call the kernels take."""
    return (x.is_cuda and x.dtype in _FLOAT_TYPES and x.dim() >= 2
            and x.shape[-1] % groups == 0)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, groups: int = 32, eps: float = 1e-5,
                    silu: bool = True, kernel=None) -> torch.Tensor:
    """GroupNorm (stats over all non-batch dims) + affine (+ SiLU).
    ``kernel`` replaces the Triton launch (the CPU tests pass the reference
    to run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
        kernel = _launch
    return differentiable(kernel, group_norm_silu_reference, x, scale, bias,
                          groups=groups, eps=eps, silu=silu)


def _launch(x, scale, bias, *, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if not supports(x, groups):
        raise ValueError(f"group_norm_silu kernel needs a CUDA float tensor "
                         f"with C % {groups} == 0; got {tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,) or not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous and scale/bias "
                         f"of shape ({c},)")
    triton, stats_kernel, norm_kernel = _triton_kernels()
    n = x.shape[0]
    s = x.numel() // (n * c)
    gs = c // groups
    block_g = _pow2(gs)
    block_s = max(16, 4096 // block_g)
    # enough (sample, group, split) programs to fill the card
    n_split = max(1, min(triton.cdiv(s, block_s), triton.cdiv(2048, n * groups), 64))
    rows = triton.cdiv(s, n_split)
    n_split = triton.cdiv(s, rows)
    psum = torch.empty((n, groups, n_split), device=x.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    stats_kernel[(groups, n_split, n)](x, psum, psq, s, c, gs, rows,
                                       BLOCK_S=block_s, BLOCK_G=block_g,
                                       num_warps=4)
    y = torch.empty_like(x)
    block_c = min(128, _pow2(c))
    norm_block_s = 32
    grid = (triton.cdiv(s, norm_block_s), triton.cdiv(c, block_c), n)
    norm_kernel[grid](x, y, scale, bias, psum, psq, s, c, gs, groups, n_split,
                      1.0 / float(s * gs), float(eps), SILU=bool(silu),
                      BLOCK_S=norm_block_s, BLOCK_C=block_c,
                      BLOCK_SPLIT=_pow2(n_split), num_warps=4)
    group_norm_silu.launches += 1
    return y


group_norm_silu.launches = 0
