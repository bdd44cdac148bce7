"""Multi-head scaled-dot-product attention and its dispatch.

Port of ``svd_xtend_tpu/ops/attention.py``. Shapes follow the BSHD
convention: q (B, S, H, D), k/v (B, T, H, D) -> (B, S, H, D).

``dot_product_attention`` is the plain form (f32 scores and softmax); the VAE
and CLIP attentions use it, as the JAX package pins them to its einsum path.
``dot_product_attention_packed`` takes the projections' unsplit (B, S, H*D)
layout and sends every call the flash kernel takes (CUDA, bf16, head_dim
64) to it (ops/kernels/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import flash_attention as fa
from .kernels.dispatch import kernels_enabled


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale) v over the T axis, heads batched; f32 softmax,
    weights rounded to the input dtype before the second product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)


def dot_product_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, num_heads: int,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Like dot_product_attention on unsplit (B, S, H*D) projections."""
    d = q.shape[-1] // num_heads
    if scale is None:
        scale = d ** -0.5
    if kernels_enabled() and fa.supports(q, k, num_heads):
        return fa.flash_attention_packed(q, k, v, num_heads=num_heads, scale=scale)
    o = dot_product_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                              split_heads(v, num_heads), scale=scale)
    return merge_heads(o)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, S, H, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)
