"""Multi-head scaled-dot-product attention and its dispatch.

Port of ``svd_xtend_tpu/ops/attention.py``. Shapes follow the BSHD
convention: q (B, S, H, D), k/v (B, T, H, D) -> (B, S, H, D).

``dot_product_attention(impl=...)``: "plain" is the einsum form (f32 scores
and softmax; JAX's "xla", to which the JAX package pins the VAE and CLIP
attentions, as the port does); "flash" is ``flash_attention`` on the BSHD
tensors (ops/kernels/flash_attention.py: the flash kernel on the card, its
plain version on the CPU); "auto" takes flash for every call the kernel
takes (CUDA, bf16, head_dim 64) while the kernels are enabled, else plain.
``dot_product_attention_packed`` takes the projections' unsplit (B, S, H*D)
layout and sends every call the flash kernel takes to it; it is the form the
UNet's transformers call.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import flash_attention as fa
from .kernels.dispatch import kernels_enabled


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """softmax(q kᵀ·scale) v over the T axis, heads batched; f32 softmax,
    weights rounded to the input dtype before the second product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl = ("flash" if kernels_enabled() and fa.supports_bshd(q, k) else "plain")
    if impl == "flash":
        return fa.flash_attention(q, k, v, scale=scale)
    if impl == "plain":
        return _plain_attention(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r}")


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
                              split_heads(v, num_heads), scale=scale, impl="plain")
    return merge_heads(o)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, S, H, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H*D)."""
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
        impl: str = "auto") -> torch.Tensor:
    """(B, S, C) projected inputs -> attention -> (B, S, C)."""
    out = dot_product_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                                split_heads(v, num_heads), impl=impl)
    return merge_heads(out)
