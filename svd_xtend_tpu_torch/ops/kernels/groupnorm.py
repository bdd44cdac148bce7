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

``group_norm_silu``'s kernels are ``csrc/group_norm.cu``, two paths that
``group_norm_plan`` chooses from the shape alone:
  cluster  - the counterpart of ``_gn_silu_kernel``: a cluster of 8 CTAs per
             sample holds the sample in shared memory, reads x once, reduces
             the group statistics through distributed shared memory and
             writes y once (every UNet site);
  two_pass - for samples the cluster does not hold (the VAE decoder's): the
             per-channel statistics partials above, their fold into (sc,
             sh), and one elementwise pass x·sc + sh (+ SiLU).
Both take the variance as max(E[x²] − mean², 0) (groupnorm.py:63-64).
GroupNorm has no matrix product, so it is bound by device-memory bytes.

On a CPU tensor ``group_norm_silu`` runs the reference; on a CUDA tensor it
launches the kernels or raises. The backward recomputes the reference and
differentiates it (groupnorm.py:265 in the JAX package).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._autograd import differentiable
from ._build import check, library
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


# group_norm_silu's launch geometry (csrc/group_norm.cu; the constants are
# its gn_cluster namespace's): a cluster of CLUSTER_CTAS CTAs of GN_THREADS
# threads per sample holds the sample in shared memory where it fits
CLUSTER_CTAS = 8
GN_THREADS = 256
GN_PIECES = 4
GN_MAX_GROUPS = 64
SMEM_LIMIT = 232_448
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


class GroupNormPlan(NamedTuple):
    """The path group_norm_silu takes: "cluster" (the sample-resident
    kernel, ``rows_per_cta`` rows of a sample in each CTA's ``smem`` bytes
    of shared memory) or "two_pass" (statistics, fold, elementwise pass)."""
    path: str
    rows_per_cta: int
    smem: int


def cluster_smem(rows_per_cta: int, c: int, elem: int) -> int:
    """A cluster CTA's shared memory (csrc/group_norm.cu's Layout): its rows
    (to 16 bytes), f32 sums and sums of squares per (row phase, channel),
    two f32 arrays of GN_MAX_GROUPS for its group partials and two for the
    sample's statistics, and GN_PIECES mbarriers."""
    phases = GN_THREADS // (c // (16 // elem))
    data = -(-rows_per_cta * c * elem // 16) * 16
    return data + 8 * phases * c + 16 * GN_MAX_GROUPS + 8 * GN_PIECES


def group_norm_plan(shape, dtype: torch.dtype, groups: int) -> GroupNormPlan:
    """The structural path choice of group_norm_silu for x of `shape` (N,
    ..., C): the cluster kernel where a sample's rows, cut into CLUSTER_CTAS
    CTAs, fit a CTA's shared memory (and C, in 16-byte vectors, one CTA's
    threads), else the two-pass path. A shape the kernels take at all is
    ``supports``'s."""
    n, c = shape[0], shape[-1]
    rows = math.prod(shape[1:-1])
    elem = dtype.itemsize
    rows_per_cta = -(-rows // CLUSTER_CTAS)
    vectors = c // (16 // elem)
    if vectors <= GN_THREADS and groups <= GN_MAX_GROUPS:
        smem = cluster_smem(rows_per_cta, c, elem)
        if smem <= SMEM_LIMIT:
            return GroupNormPlan("cluster", rows_per_cta, smem)
    return GroupNormPlan("two_pass", 0, 0)


def supports(x: torch.Tensor, groups: int) -> bool:
    """Structural dispatch predicate: a CUDA call the kernels take (a float
    type, C a whole number of groups and of 16-byte vectors)."""
    return (x.is_cuda and x.dtype in _FLOAT_TYPES and x.dim() >= 2
            and x.shape[-1] % groups == 0 and x.shape[-1] % (16 // x.element_size()) == 0)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, groups: int = 32, eps: float = 1e-5,
                    silu: bool = True, kernel=None) -> torch.Tensor:
    """GroupNorm (stats over all non-batch dims) + affine (+ SiLU).
    ``kernel`` replaces the CUDA launch (the CPU tests pass the reference
    to run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
        kernel = _launch
    return differentiable(kernel, group_norm_silu_reference, x, scale, bias,
                          groups=groups, eps=eps, silu=silu)


def _launch(x, scale, bias, *, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if not supports(x, groups):
        raise ValueError(f"group_norm_silu kernel needs a CUDA float tensor with C % {groups} "
                         f"== 0 and 16-byte channel vectors; got {tuple(x.shape)} {x.dtype}")
    c = x.shape[-1]
    if (scale.shape != (c,) or bias.shape != (c,) or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("group_norm_silu: x must be contiguous and 16-byte aligned, "
                         f"scale/bias of shape ({c},)")
    n = x.shape[0]
    rows = x.numel() // (n * c)
    plan = group_norm_plan(x.shape, x.dtype, groups)
    scf, bif = _affine_f32(scale, bias)
    y = torch.empty_like(x)
    scratch = [None] * 4
    if plan.path == "two_pass":
        psum = torch.empty((n, stats_slots(rows), c), device=x.device, dtype=torch.float32)
        sc = torch.empty((n, c), device=x.device, dtype=torch.float32)
        scratch = [psum, torch.empty_like(psum), sc, torch.empty_like(sc)]
    check(library().svdx_group_norm_silu(
        x.data_ptr(), y.data_ptr(), scf.data_ptr(), bif.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), n, rows, c, groups,
        plan.rows_per_cta, _DTYPE_CODE[x.dtype], int(silu), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream), f"group_norm_silu ({plan.path})")
    group_norm_silu.launches += 1
    return y


group_norm_silu.launches = 0
