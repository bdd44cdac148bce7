"""Dynamic per-tensor int8 quantisation of bf16 activations on a hand
kernel, the first half of the W8A8 path (``ops/quant.py``).

The function is ``svd_xtend_tpu/ops/quant.py::quantize_dynamic`` (XLA code
in the JAX package, no Pallas kernel), at a conv site after its prologue:
JAX applies the folded GroupNorm affine (+ SiLU) in f32, rounds it to bf16
and then quantises it (blocks.py:294-302), over the channel concat of the
up blocks' two sources (blocks.py:277-284). ``quantize_reference`` is that
plain version; the kernel is ``csrc/int8_quant.cu`` (two launches: partial
amaxes, then the scale and the codes), which takes the prologue and the
second source as it reads, writes the codes at the full width and keeps
the scale on the device: ``stats`` is a (2,) f32 tensor (amax, scale) that
the GEMM's epilogue reads (``ops/kernels/int8_gemm.py``), so nothing waits
for the host.

Over several ranks (``quant.quantized(mode, group)``) the tensor of a call
is split over the ranks of the group (data rows, frames, a row-parallel
product's inputs), and its amax is the largest over the group: the plain
version all-reduces its amax; the kernel runs its two passes apart
(``phase`` 1, then 2) with the partial amaxes all-reduced between them in a
buffer of MAX_BLOCKS (the ranks' grids may differ), which the second pass
reads whole. A rank whose part is empty (a model rank without a head) adds
an amax of 0 to the reduction and launches nothing.

On a CPU tensor ``quantize`` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...parallel.frames import all_reduce_max_
from .. import quant
from ._build import check, library
from .conv3x3 import apply_pre_affine

THREADS = 256
MAX_BLOCKS = 1024      # csrc/int8_quant.cu's kMaxBlocks
VEC = 4                # values a thread reads at a step (8 bytes of bf16)


def _parts(x: torch.Tensor, x2: Optional[torch.Tensor]):
    return [x] if x2 is None else [x, x2]


def quantize_reference(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None):
    """Plain version: (codes of [x, x2] (..., C1 + C2) int8, stats (2,) f32 =
    (amax, scale)). ``pre=(sc, sh, silu)``: per-(sample, channel) f32 (N, C1
    + C2) applied to NHWC parts as ``conv3x3.apply_pre_affine`` does, per
    part, before the quantisation."""
    parts = _parts(x, x2)
    if pre is not None:
        sc, sh, silu = pre
        c0, out = 0, []
        for part in parts:
            c1 = c0 + part.shape[-1]
            out.append(apply_pre_affine(part, sc[:, c0:c1], sh[:, c0:c1], silu))
            c0 = c1
        parts = out
    v = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    group = quant.amax_group()
    if group is None and v.numel():
        codes, scale = quant.quantize_dynamic(v)
        amax = v.float().abs().amax()
    else:
        amax = v.float().abs().amax() if v.numel() else v.new_zeros((), dtype=torch.float32)
        if group is not None:
            amax = all_reduce_max_(amax, group)
        scale = quant.scale_of(amax)
        codes = quant.codes(v.float(), scale)
    return codes, torch.stack([amax, scale])


def supports(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None) -> bool:
    """Structural dispatch predicate: CUDA bf16 contiguous 8-byte aligned
    parts of the same leading shape with channels in multiples of 4; with
    `pre`, 4-D NHWC parts."""
    parts = _parts(x, x2)
    ok = all(p.is_cuda and p.dtype == torch.bfloat16 and p.is_contiguous() and p.dim() >= 2
             and p.shape[-1] % VEC == 0 and p.data_ptr() % 8 == 0
             and p.shape[:-1] == x.shape[:-1] and p.device == x.device for p in parts)
    return ok and (pre is None or x.dim() == 4)


def blocks_for(values: int) -> int:
    """The grid of both launches: a vector of 4 values a thread, at most
    MAX_BLOCKS blocks (the partial amaxes)."""
    return max(1, min(MAX_BLOCKS, -(-values // (VEC * THREADS))))


def _launch(x, pre, x2):
    if not supports(x, pre, x2):
        raise ValueError(
            "int8_quantize kernel needs CUDA bf16 contiguous parts of the same leading shape "
            f"with channels % {VEC} == 0 (NHWC with a prologue); got "
            + ", ".join(f"{tuple(p.shape)} {p.dtype}" for p in _parts(x, x2)))
    c1 = x.shape[-1]
    c = c1 + (0 if x2 is None else x2.shape[-1])
    m = x.numel() // c1
    sc = sh = None
    rows_per_sample = m
    silu = False
    if pre is not None:
        sc, sh, silu = pre
        n = x.shape[0]
        sc, sh = sc.float().contiguous(), sh.float().contiguous()
        for name, a in (("pre_scale", sc), ("pre_shift", sh)):
            if tuple(a.shape) != (n, c) or a.device != x.device or a.data_ptr() % 16:
                raise ValueError(f"int8_quantize: {name} must be a 16-byte aligned {(n, c)} "
                                 f"on x's device, got {tuple(a.shape)}")
        rows_per_sample = m // n
    q = torch.empty(x.shape[:-1] + (c,), device=x.device, dtype=torch.int8)
    group = quant.amax_group()
    if m * c == 0:
        # an empty part: an amax of 0 into the group's reduction, no launch
        partials = torch.zeros(MAX_BLOCKS, device=x.device, dtype=torch.float32)
        if group is not None:
            all_reduce_max_(partials, group)
        amax = partials.max()
        return q, torch.stack([amax, quant.scale_of(amax)])
    stats = torch.empty(2, device=x.device, dtype=torch.float32)
    blocks = blocks_for(m * c)
    partials = (torch.empty(blocks, device=x.device, dtype=torch.float32) if group is None
                else torch.zeros(MAX_BLOCKS, device=x.device, dtype=torch.float32))
    ptr = lambda a: None if a is None else a.data_ptr()

    def run(phase):
        check(library().svdx_int8_quantize(
            x.data_ptr(), ptr(x2), ptr(sc), ptr(sh), q.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), m, c, c1, rows_per_sample, int(bool(silu)), blocks, phase,
            torch.cuda.current_stream(x.device).cuda_stream), "int8_quantize")

    if group is None:
        run(0)
    else:
        run(1)
        all_reduce_max_(partials, group)
        run(2)
    quantize.launches += 1
    return q, stats


def quantize(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None):
    """(codes, stats) of [silu](x·sc + sh) (or x), over the channel concat
    [x, x2] when x2 is given; stats (2,) f32 = (amax, scale) on x's device."""
    if x.device.type == "cpu":
        return quantize_reference(x, pre, x2)
    return _launch(x, pre, x2)


quantize.launches = 0
