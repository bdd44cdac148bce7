"""Self-attention over the frame axis of (B, F, S, heads*64).

Port of ``svd_xtend_tpu/ops/pallas/temporal_attention.py::frame_attention``
(its kernel ``_kernel``). The CUDA kernel is ``csrc/temporal_attention.cu``:
one warp per (b, s, head), lanes on channels, so q/k/v are read once and o
written once in their native layout. It is bound by device-memory bytes;
see the source for the design.

On a CPU tensor the wrapper runs ``frame_attention_reference`` (the einsum
form of ``_xla_reference``); on a CUDA tensor it launches the kernel or
raises. The backward recomputes the reference and differentiates it, as the
JAX package does (``jax.vjp(_xla_reference)``, temporal_attention.py:182).
"""

from __future__ import annotations

import torch

from ._autograd import differentiable
from ._build import check, library

HEAD_DIM = 64
MAX_FRAMES = 32


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
                or not a.is_contiguous() or a.data_ptr() % 4):
            raise ValueError(f"frame_attention: {name} must be a contiguous "
                             "tensor like q")
    o = torch.empty_like(q)
    b, f, s, _ = q.shape
    err = library().svdx_frame_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, f, s,
        num_heads, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "frame_attention_fwd")
    frame_attention.launches += 1
    return o


frame_attention.launches = 0
