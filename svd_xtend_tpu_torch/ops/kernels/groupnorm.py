"""GroupNorm(+SiLU) over channels-last (N, ..., C) tensors, and the GN fold.

Port of ``svd_xtend_tpu/ops/pallas/groupnorm.py``: ``group_norm_silu`` (its
kernels ``_gn_silu_kernel``, ``_stats_kernel`` and ``_norm_kernel``), the plain
``group_norm_silu_reference``, and ``group_norm_fold`` (XLA code in the JAX
package: per-channel sums in one pass, then the fold on the (N, C) sums).
On the card ``group_norm_fold`` and ``fold_from_partials`` (JAX's
``_fold_from_channel_sums``) are the kernels of ``csrc/gn_fold.cu``: a
statistics pass that reads x once into per-(sample, 64-row chunk) f32
partials (no f32 copy of x; the plain version makes two), and a fold of the
partials into (sc, sh) in one launch. Kernel A of the temporal resnet writes
the same partials for norm2; their plain version is
``channel_stats_reference``.

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
from ._build import BUILD_DIR, check, library
from ._weights import per_version

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


def group_norm_fold_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              *, groups: int = 32, eps: float = 1e-5):
    """GroupNorm stats + affine folded into a per-(sample, channel) f32
    affine (sc, sh): GN(x)·scale + bias == x·sc + sh (before any SiLU).
    JAX's ``group_norm_fold`` formula, on an f32 copy of x."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c).float()
    return fold_from_channel_sums(xf.sum(1), (xf * xf).sum(1), xf.shape[1],
                                  scale, bias, groups, eps)


# The per-channel statistics of a (samples of rows_per_sample rows, C)
# matrix, as csrc/gn_stats.cuh writes them (kernel A of the temporal resnet,
# the fold's statistics kernel): f32 partial sums and sums of squares (B,
# slots, C), slot j of sample b holding its rows of the 64-row chunk
# b·rows_per_sample // 64 + j (a chunk straddles samples wherever
# rows_per_sample % 64 != 0), zero past the sample's last chunk. Summing the
# slots gives the (B, C) channel sums.
STATS_ROWS = 64


def stats_slots(rows_per_sample: int) -> int:
    return -(-rows_per_sample // STATS_ROWS) + 1


def channel_stats_reference(x: torch.Tensor, rows_per_sample: int):
    """Plain version of the statistics kernel on x (M, C): (psum, psq)."""
    m, c = x.shape
    b, slots = m // rows_per_sample, stats_slots(rows_per_sample)
    rows = torch.arange(m, device=x.device)
    sample = rows // rows_per_sample
    slot = sample * slots + rows // STATS_ROWS - sample * rows_per_sample // STATS_ROWS
    xf = x.float()
    out = [torch.zeros(b * slots, c, device=x.device).index_add_(0, slot, v).view(b, slots, c)
           for v in (xf, xf * xf)]
    return out[0], out[1]


def stats_supports(x: torch.Tensor) -> bool:
    """Structural dispatch predicate of the fold's statistics kernel: a CUDA
    bf16 contiguous (N, ..., C), C even, 16-byte aligned."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() >= 2 and x.is_contiguous()
            and x.shape[-1] % 2 == 0 and x.data_ptr() % 16 == 0)


# the GroupNorm affine as the fold kernel reads it, made once per version
_affine_f32 = per_version(lambda s, b: (s.float().contiguous(), b.float().contiguous()))


def _fold_launch(x, psum, psq, rows: int, scale, bias, groups: int, eps: float):
    """csrc/gn_fold.cu: (sc, sh) (B, C) f32 from the partials psum / psq (B,
    stats_slots(rows), C) f32, which it first fills from x where x is given."""
    b, slots, c = psum.shape
    if slots != stats_slots(rows) or c % groups or psq.shape != psum.shape:
        raise ValueError(f"group_norm_fold: partials {tuple(psum.shape)} do not fit {rows} "
                         f"rows a sample and {groups} groups")
    scf, bif = _affine_f32(scale, bias)
    sc = torch.empty((b, c), device=psum.device, dtype=torch.float32)
    sh = torch.empty_like(sc)
    check(library().svdx_group_norm_fold(
        None if x is None else x.data_ptr(), psum.data_ptr(), psq.data_ptr(), scf.data_ptr(),
        bif.data_ptr(), sc.data_ptr(), sh.data_ptr(), b, rows, c, groups, float(eps),
        torch.cuda.current_stream(psum.device).cuda_stream), "group_norm_fold")
    return sc, sh


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, groups: int = 32, eps: float = 1e-5, kernel=None):
    """``group_norm_fold_reference`` by the kernels of csrc/gn_fold.cu on a
    CUDA tensor, which they take or it raises (x read once, no f32 copy); on
    a CPU tensor the reference. The backward recomputes the reference and
    differentiates it. ``kernel`` replaces the CUDA launch (the CPU tests
    pass the reference to run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return group_norm_fold_reference(x, scale, bias, groups=groups, eps=eps)
        kernel = _fold
    return differentiable(kernel, group_norm_fold_reference, x, scale, bias,
                          groups=groups, eps=eps)


def _fold(x, scale, bias, *, groups: int, eps: float):
    if not stats_supports(x):
        raise ValueError("group_norm_fold kernel needs a CUDA bf16 contiguous 16-byte aligned "
                         f"(N, ..., C) with C even; got {tuple(x.shape)} {x.dtype}")
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    psum = torch.empty((n, stats_slots(rows), c), device=x.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    out = _fold_launch(x, psum, psq, rows, scale, bias, groups, eps)
    group_norm_fold.launches += 1
    return out


def fold_from_partials(psum: torch.Tensor, psq: torch.Tensor, count: int,
                       scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float):
    """JAX's ``_fold_from_channel_sums``: (sc, sh) from the statistics
    partials (B, stats_slots(count), C) over `count` rows a sample. On a CUDA
    tensor the fold kernel, on a CPU tensor ``fold_from_channel_sums`` of
    their slot sums."""
    if psum.device.type == "cpu":
        return fold_from_channel_sums(psum.sum(1), psq.sum(1), count, scale, bias, groups, eps)
    out = _fold_launch(None, psum, psq, count, scale, bias, groups, eps)
    fold_from_partials.launches += 1
    return out


group_norm_fold.launches = 0
fold_from_partials.launches = 0


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
