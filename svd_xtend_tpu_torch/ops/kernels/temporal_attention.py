"""Self-attention over the frame axis of (B, F, S, heads*64).

Port of ``svd_xtend_tpu/ops/pallas/temporal_attention.py::frame_attention``
(its kernel ``_kernel``). The CUDA kernel is ``csrc/temporal_attention.cu``:
persistent blocks whose producer warp brings an item's q, k and v (one head
of ``tokens`` tokens, all frames) by TMA into a ring of stages, and consumer
warps that run each token's two products on tensor cores (mma.sync) with the
softmax in registers. It is bound by device-memory bytes; see the source for
the design. ``frame_plan`` gives the launch geometry the kernel instantiates.

On a CPU tensor the wrapper runs ``frame_attention_reference`` (the einsum
form of ``_xla_reference``); on a CUDA tensor it launches the kernel or
raises. The backward recomputes the reference and differentiates it, as the
JAX package does (``jax.vjp(_xla_reference)``, temporal_attention.py:182).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._autograd import differentiable
from ._build import check, library

HEAD_DIM = 64
MAX_FRAMES = 32
# shared memory a block may take (227 KB) on an H100
SMEM_LIMIT = 232_448


class FramePlan(NamedTuple):
    """The kernel's launch geometry for F frames: token tiles of ``f_pad``
    frames (the m16n8k16 row tiles: 16, or 32 past 16 frames), ``tokens``
    tokens a stage (one consumer warp each), ``stages`` stages in the ring,
    and the block's shared memory in bytes."""
    f_pad: int
    tokens: int
    stages: int
    smem: int


def frame_plan(f: int) -> FramePlan:
    """The plan csrc/temporal_attention.cu instantiates for 1 <= f <= 32:
    its shared memory is the ring (q, k and v tiles of tokens x f_pad rows
    of 128 bytes a stage), its 2 mbarriers a stage, and 1 KB of alignment."""
    if not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"frame attention takes 1..{MAX_FRAMES} frames, got {f}")
    f_pad, tokens = (16 if f <= 16 else 32), 8
    stages = 3 if f_pad == 16 else 2
    smem = stages * (3 * tokens * f_pad * HEAD_DIM * 2 + 16) + 1024
    return FramePlan(f_pad, tokens, stages, smem)


def frame_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, num_heads: int,
                              scale: float) -> torch.Tensor:
    """Per-(b, s, head) attention over F; f32 softmax, weights rounded to the
    input dtype before the second product."""
    b, f, s, n = q.shape
    d = n // num_heads
    qh = q.reshape(b, f, s, num_heads, d)
    kh = k.reshape(b, f, s, num_heads, d)
    vh = v.reshape(b, f, s, num_heads, d)
    logits = torch.einsum("bfshd,bgshd->bshfg", qh.float(), kh.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bshfg,bgshd->bfshd", w, vh).reshape(b, f, s, n)


def supports(q: torch.Tensor, num_heads: int) -> bool:
    """Structural dispatch predicate: a CUDA bf16 call the kernel takes."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 4
            and q.shape[-1] == num_heads * HEAD_DIM
            and 1 <= q.shape[1] <= MAX_FRAMES)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, scale: float, kernel=None) -> torch.Tensor:
    """(B, F, S, H*64) -> (B, F, S, H*64), softmax over the F axis.
    ``kernel`` replaces the CUDA launch (the CPU tests pass the reference to
    run the autograd wiring without a card)."""
    if kernel is None:
        if q.device.type == "cpu":
            return frame_attention_reference(q, k, v, num_heads=num_heads,
                                             scale=scale)
        kernel = _launch
    return differentiable(kernel, frame_attention_reference, q, k, v,
                          num_heads=num_heads, scale=scale)


def _launch(q, k, v, *, num_heads: int, scale: float) -> torch.Tensor:
    if not supports(q, num_heads):
        raise ValueError(
            f"frame_attention kernel needs CUDA bf16 (B, F<={MAX_FRAMES}, S, "
            f"H*{HEAD_DIM}); got {tuple(q.shape)} {q.dtype}, heads {num_heads}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if (a.shape != q.shape or a.dtype != q.dtype or a.device != q.device
                or not a.is_contiguous() or a.data_ptr() % 16):
            raise ValueError(f"frame_attention: {name} must be a contiguous, "
                             "16-byte aligned tensor like q")
    o = torch.empty_like(q)
    b, f, s, _ = q.shape
    plan = frame_plan(f)
    err = library().svdx_frame_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, f, s,
        num_heads, plan.f_pad, plan.tokens, plan.stages, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "frame_attention_fwd")
    frame_attention.launches += 1
    return o


frame_attention.launches = 0
