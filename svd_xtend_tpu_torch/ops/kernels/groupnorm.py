"""GroupNorm(+SiLU) over channels-last (N, ..., C) tensors, and the GN fold.

Port of ``svd_xtend_tpu/ops/pallas/groupnorm.py``: ``group_norm_silu`` (its
kernels ``_gn_silu_kernel``, ``_stats_kernel`` and ``_norm_kernel``), the plain
``group_norm_silu_reference``, and ``group_norm_fold`` (XLA code in the JAX
package: per-channel sums in one pass, then the fold on the (N, C) sums).
On the card ``group_norm_fold`` is one launch of the kernel of
``csrc/gn_fold.cu`` (``csrc/gn_stats.cuh``): it reads x once, 16 bytes a
thread (bf16 pairs where a call is too small for that), into per-(sample,
64-row chunk) f32 partials (no f32 copy of x; the plain version makes two),
then meets at a grid barrier and folds them into (sc, sh) a (sample, group)
at a time per block, in the order of the fold launch it replaces
(``fold_order_reference``), so sc and sh keep their bits. Kernel A of the
temporal resnet writes the same partials for norm2 and folds them the same
way after its last tile; their plain version is ``channel_stats_reference``.
``fold_from_partials`` (JAX's ``_fold_from_channel_sums``) is the same
kernel over given partials; no main path launches it. Over two parts
(``x2``: the up-block resnets' norm1 over the channel concat [x, x2] that is
never built, JAX's ``group_norm_fold_cat``) the statistics read each vector
from the part it lies in (one launch, as over one tensor) and the fold
reads the partials as one width, so a group that straddles the parts is
folded whole. Each call's scratch (partials, sc, sh) is one allocation; the
barrier's words are a workspace per (device, stream), made once.

``group_norm_silu``'s kernels are ``csrc/group_norm.cu``, two paths that
``group_norm_plan`` chooses from the shape alone:
  cluster  - the counterpart of ``_gn_silu_kernel``: a cluster of 8 CTAs per
             sample holds the sample in shared memory, reads x once, reduces
             the group statistics through distributed shared memory and
             writes y once (every UNet site);
  two_pass - for samples the cluster does not hold (the VAE decoder's): the
             per-channel statistics partials above, folded into (sc, sh) in
             the same launch, and one elementwise pass x·sc + sh (+ SiLU).
Both take the variance as max(E[x²] − mean², 0) (groupnorm.py:63-64).
GroupNorm has no matrix product, so it is bound by device-memory bytes.

On a CPU tensor ``group_norm_silu`` runs the reference; on a CUDA tensor it
launches the kernels or raises. The backward recomputes the reference and
differentiates it (groupnorm.py:265 in the JAX package).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
                              x2: Optional[torch.Tensor] = None, *, groups: int = 32,
                              eps: float = 1e-5):
    """GroupNorm stats + affine folded into a per-(sample, channel) f32
    affine (sc, sh): GN(x)·scale + bias == x·sc + sh (before any SiLU).
    JAX's ``group_norm_fold`` formula, on an f32 copy of x. With x2, over
    the channel concat [x, x2] without building it (JAX's
    ``group_norm_fold_cat``): each part's channel sums fill their range of
    the (N, C) sums, which are folded as one."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.reshape(n, -1, c).float()
    if x2 is None:
        return fold_from_channel_sums(xf.sum(1), (xf * xf).sum(1), xf.shape[1],
                                      scale, bias, groups, eps)
    x2f = x2.reshape(n, -1, x2.shape[-1]).float()
    if x2f.shape[1] != xf.shape[1]:
        raise ValueError(f"group_norm_fold: the parts' spatial sizes differ ({xf.shape[1]} "
                         f"and {x2f.shape[1]})")
    sums = xf.new_empty((2, n, c + x2f.shape[-1]))
    for part, cols in ((xf, slice(0, c)), (x2f, slice(c, None))):
        sums[0, :, cols] = part.sum(1)
        sums[1, :, cols] = (part * part).sum(1)
    return fold_from_channel_sums(sums[0], sums[1], xf.shape[1], scale, bias, groups, eps)


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
    bf16 contiguous (N, ..., C), C a multiple of 8 (its 16-byte vectors),
    16-byte aligned."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() >= 2 and x.is_contiguous()
            and x.shape[-1] % STATS_VEC == 0 and x.data_ptr() % 16 == 0)


# The fold in the launch that writes the partials (csrc/gn_stats.cuh): a
# grid barrier once every partial is written, then one (sample, group) at a
# time on each unit of FOLD_THREADS threads, in the order of the fold launch
# it replaces (``fold_order_reference`` is that order's plain version), so
# sc and sh keep their bits. The barrier's words are a workspace per
# (device, stream), made once outside any CUDA graph capture and left at
# zero.
STATS_VEC = 8          # channels of a statistics thread's 16-byte bf16 vector (C a multiple)
FOLD_THREADS = 256     # kFoldThreads: the threads of a fold unit
BARRIER_WORDS = 64     # kArrive and kExit, each on its own 128 bytes
BARRIER_STREAMS = 64


def fold_order_reference(psum: torch.Tensor, psq: torch.Tensor, groups: int):
    """The kernels' sums of the statistics partials (B, slots, C) per (sample,
    group), in their f32 order: thread t of a unit sums the group's values
    i = t, t + FOLD_THREADS, ... in (slot, channel) order, and a tree halves
    the FOLD_THREADS sums (t += t + h for h = 128, 64, ..., 1). Returns the
    two (B, groups) sums."""
    n, slots, c = psum.shape
    gs = c // groups
    out = []
    for part in (psum, psq):
        v = part.reshape(n, slots, groups, gs).permute(0, 2, 1, 3).reshape(n, groups, -1)
        pad = -v.shape[-1] % FOLD_THREADS
        v = torch.nn.functional.pad(v, (0, pad)).reshape(n, groups, -1, FOLD_THREADS)
        acc = torch.zeros(n, groups, FOLD_THREADS, dtype=torch.float32, device=part.device)
        for r in range(v.shape[2]):          # each thread's values in order
            acc = acc + v[:, :, r]
        h = FOLD_THREADS // 2
        while h:
            acc = torch.cat([acc[..., :h] + acc[..., h:2 * h], acc[..., h:]], -1)
            h //= 2
        out.append(acc[..., 0])
    return out[0], out[1]


_barriers = {}
_barrier_slots = {}


def fold_barrier(device: torch.device, stream: int) -> torch.Tensor:
    """This (device, stream)'s BARRIER_WORDS words of the device's
    workspace (the barrier's arrivals and exits), zeroed once (outside any
    CUDA graph capture); every launch leaves them at zero."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ws = _barriers.get(index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("group_norm_fold: the first call on a device must come before "
                               "any CUDA graph capture (its barrier words are made once)")
        ws = _barriers[index] = torch.zeros(BARRIER_STREAMS, BARRIER_WORDS, dtype=torch.int32,
                                            device=device)
    slot = _barrier_slots.setdefault((index, stream),
                                     sum(k[0] == index for k in _barrier_slots))
    if slot >= BARRIER_STREAMS:
        raise RuntimeError(f"group_norm_fold: more than {BARRIER_STREAMS} streams on a device")
    return ws[slot]


class FoldScratch(NamedTuple):
    """A fold call's scratch, views of one f32 allocation: the statistics
    partials psum, psq (N, stats_slots(rows), C) and the outputs sc, sh (N,
    C)."""
    psum: torch.Tensor
    psq: torch.Tensor
    sc: torch.Tensor
    sh: torch.Tensor


def _scratch_sizes(n, rows, c):
    part = n * stats_slots(rows) * c
    return part, part, n * c, n * c


def fold_scratch(n: int, rows: int, c: int, device) -> FoldScratch:
    """One allocation for a fold call: partials, sc and sh, each 16-byte
    aligned (C % 4 == 0)."""
    sizes = _scratch_sizes(n, rows, c)
    psum, psq, sc, sh = torch.split(
        torch.empty(sum(sizes), device=device, dtype=torch.float32), sizes)
    shape = (n, stats_slots(rows), c)
    return FoldScratch(psum.view(shape), psq.view(shape), sc.view(n, c), sh.view(n, c))


# the GroupNorm affine as group_norm_silu's kernels read it, made once per version
_affine_f32 = per_version(lambda s, b: (s.float().contiguous(), b.float().contiguous()))

# the current stream's handle by device index (torch's own fast accessor
# where this build has it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index if device.index is not None
                           else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


def fold_affine(scale: torch.Tensor, bias: torch.Tensor):
    """(scale, bias, 1 if bf16 else 0) as the fold reads them: bf16 or f32
    contiguous tensors of one type as they are (no copy a call), anything
    else as f32 made once per version."""
    if (scale.dtype == bias.dtype and scale.dtype in (torch.bfloat16, torch.float32)
            and scale.is_contiguous() and bias.is_contiguous()):
        return scale, bias, int(scale.dtype == torch.bfloat16)
    return (*_affine_f32(scale, bias), 0)


def check_fold_shape(n: int, rows: int, c: int, groups: int) -> None:
    if c % groups or n * stats_slots(rows) * c >= 2 ** 31:
        raise ValueError(f"group_norm_fold: {n} samples of {rows} rows of {c} channels in "
                         f"{groups} groups do not fit the kernel")


def _fold_call(x, x2, ptrs, n: int, rows: int, c: int, scale, bias, groups: int, eps: float,
               device) -> None:
    """csrc/gn_fold.cu, one launch: ptrs = (psum, psq, sc, sh) f32
    addresses; the partials (N, stats_slots(rows), C) are filled from x
    where x is given (and with x2, x's channels then x2's), else read."""
    scale, bias, bf16 = fold_affine(scale, bias)
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != device:
        raise ValueError(f"group_norm_fold: scale and bias must be ({c},) on {device}")
    stream = stream_of(device)
    check(library().svdx_group_norm_fold(
        None if x is None else x.data_ptr(), None if x2 is None else x2.data_ptr(), *ptrs,
        fold_barrier(device, stream).data_ptr(), scale.data_ptr(), bias.data_ptr(), n, rows,
        c, 0 if x2 is None else x.shape[-1], groups, bf16, float(eps), stream),
        "group_norm_fold")


class _FoldPlan(NamedTuple):
    """A fold call's shape-only work: samples, rows a sample, channels, the
    scratch's byte offsets (psum, psq, sc, sh) and its f32 size."""
    n: int
    rows: int
    c: int
    offsets: tuple
    size: int


_fold_plans = {}


def _fold_plan(x, x2, groups: int) -> _FoldPlan:
    key = (x.shape, None if x2 is None else x2.shape, groups)
    plan = _fold_plans.get(key)
    if plan is None:
        n, c1 = x.shape[0], x.shape[-1]
        rows = x.numel() // (n * c1)
        c = c1 if x2 is None else c1 + x2.shape[-1]
        if x2 is not None and x2.shape[:-1] != x.shape[:-1]:
            raise ValueError(f"group_norm_fold: the parts' leading shapes differ ("
                             f"{tuple(x.shape)}, {tuple(x2.shape)})")
        check_fold_shape(n, rows, c, groups)
        sizes = _scratch_sizes(n, rows, c)
        offsets = tuple(4 * sum(sizes[:i]) for i in range(len(sizes)))
        plan = _fold_plans[key] = _FoldPlan(n, rows, c, offsets, sum(sizes))
    return plan


def _check_fold_input(x, x2):
    if not stats_supports(x) or (x2 is not None and not stats_supports(x2)):
        raise ValueError("group_norm_fold kernel needs a CUDA bf16 contiguous 16-byte aligned "
                         f"(N, ..., C) with C % {STATS_VEC} == 0 (and a second part of x's "
                         f"leading shape); got {tuple(x.shape)} {x.dtype}, x2 "
                         f"{None if x2 is None else (tuple(x2.shape), x2.dtype)}")


def group_norm_fold(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    x2: Optional[torch.Tensor] = None, *, groups: int = 32,
                    eps: float = 1e-5, kernel=None):
    """``group_norm_fold_reference`` by the kernel of csrc/gn_fold.cu on a
    CUDA tensor, which it takes or this raises (one launch: x read once, no
    f32 copy, the fold in the same launch); on a CPU tensor the reference.
    With x2, over the channel concat [x, x2], which is never built. The
    backward recomputes the reference and differentiates it. ``kernel``
    replaces the CUDA launch (the CPU tests pass the reference to run the
    autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return group_norm_fold_reference(x, scale, bias, x2, groups=groups, eps=eps)
        kernel = _fold
    inputs = (x, scale, bias) if x2 is None else (x, scale, bias, x2)
    return differentiable(kernel, group_norm_fold_reference, *inputs, groups=groups, eps=eps)


def _fold_into(x, x2, scale, bias, groups: int, eps: float):
    """The fold kernel's one launch on CUDA x (and x2) into one allocation
    laid out by the shape's plan: (plan, the allocation)."""
    _check_fold_input(x, x2)
    plan = _fold_plan(x, x2, groups)
    buf = torch.empty(plan.size, device=x.device, dtype=torch.float32)
    at = buf.data_ptr()
    _fold_call(x, x2, [at + o for o in plan.offsets], plan.n, plan.rows, plan.c, scale, bias,
               groups, eps, x.device)
    group_norm_fold.launches += 1
    return plan, buf


def fold_with_partials(x, scale, bias, x2=None, *, groups: int, eps: float) -> FoldScratch:
    """The fold kernel's one launch, keeping its statistics partials: the
    scratch (psum, psq, sc, sh) it wrote."""
    plan, buf = _fold_into(x, x2, scale, bias, groups, eps)
    at = [o // 4 for o in plan.offsets] + [plan.size]
    parts = [buf[a:b] for a, b in zip(at, at[1:])]
    shape = (plan.n, stats_slots(plan.rows), plan.c)
    return FoldScratch(parts[0].view(shape), parts[1].view(shape),
                       parts[2].view(plan.n, plan.c), parts[3].view(plan.n, plan.c))


def _fold(x, scale, bias, x2=None, *, groups: int, eps: float):
    """The main path's fold: (sc, sh), views of the call's one allocation."""
    plan, buf = _fold_into(x, x2, scale, bias, groups, eps)
    nc, sc_at = plan.n * plan.c, plan.offsets[2] // 4
    return buf[sc_at:sc_at + nc].view(plan.n, plan.c), buf[sc_at + nc:].view(plan.n, plan.c)


def fold_from_partials(psum: torch.Tensor, psq: torch.Tensor, count: int,
                       scale: torch.Tensor, bias: torch.Tensor, groups: int, eps: float):
    """JAX's ``_fold_from_channel_sums``: (sc, sh) from the statistics
    partials (B, stats_slots(count), C) over `count` rows a sample. On a CUDA
    tensor the fold kernel in its partials-only form (no main path launches
    it: kernel A folds its own partials), on a CPU tensor
    ``fold_from_channel_sums`` of their slot sums."""
    if psum.device.type == "cpu":
        return fold_from_channel_sums(psum.sum(1), psq.sum(1), count, scale, bias, groups, eps)
    n, slots, c = psum.shape
    if (slots != stats_slots(count) or psq.shape != psum.shape or psum.dtype != torch.float32
            or not (psum.is_contiguous() and psq.is_contiguous())):
        raise ValueError(f"fold_from_partials: partials {tuple(psum.shape)} {psum.dtype} do not "
                         f"fit {count} rows a sample")
    check_fold_shape(n, count, c, groups)
    out = torch.empty((2, n, c), device=psum.device, dtype=torch.float32)
    _fold_call(None, None, [psum.data_ptr(), psq.data_ptr(), out[0].data_ptr(),
                            out[1].data_ptr()], n, count, c, scale, bias, groups, eps,
               psum.device)
    fold_from_partials.launches += 1
    return out[0], out[1]


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
    stream = stream_of(x.device)
    scratch = [None] * 5
    if plan.path == "two_pass":
        f = fold_scratch(n, rows, c, x.device)
        scratch = [f.psum, f.psq, fold_barrier(x.device, stream), f.sc, f.sh]
    check(library().svdx_group_norm_silu(
        x.data_ptr(), y.data_ptr(), scf.data_ptr(), bif.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch), n, rows, c, groups,
        plan.rows_per_cta, _DTYPE_CODE[x.dtype], int(silu), float(eps), stream),
        f"group_norm_silu ({plan.path})")
    group_norm_silu.launches += 1
    return y


group_norm_silu.launches = 0
