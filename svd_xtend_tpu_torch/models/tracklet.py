"""Tracklet2Video: the box-conditioned generation branch.

Port of ``svd_xtend_tpu/models/tracklet.py`` (the reference's README.md:
57-70 describes the capability and ships no code): an optional
conditioning branch that is an exact no-op at init (tanh gates at 0), so a
pretrained UNet with the branch added computes what it computed without it.

  - ``BoxTokenizer``: per-frame, per-instance tokens from Fourier features of
    the normalised (x1, y1, x2, y2) boxes plus a learned instance-id
    embedding; absent boxes (mask 0) become a learned null token.
  - ``InstanceEnhancer``: a pre-LN transformer layer over each instance's
    tokens across frames.
  - ``GatedSelfAttention``: GLIGEN-style injection after each spatial
    transformer block: the visual tokens attend over [visual ++ box] tokens,
    the residual scaled by tanh(alpha_attn), then a feed-forward scaled by
    tanh(alpha_dense).

Kernels: the gated attention's queries are the h·w visual tokens and its
keys the h·w + N visual and box tokens, so it goes through
``dot_product_attention_packed`` (the flash kernel on the card wherever it
takes the shape, its plain version on the CPU); the JAX package pins plain
XLA attention there, the same math. The enhancer's attention (head_dim
dim / heads, F tokens) and both feed-forwards are plain, as in JAX (its
``FeedForward``, not the fused residual GEGLU kernel). Parameter names
follow the JAX module paths (``io/convert.py`` maps them both ways).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, dot_product_attention_packed, split_heads
from .transformer import FeedForward


def fourier_embed(x: torch.Tensor, num_freqs: int = 8) -> torch.Tensor:
    """(..., D) -> (..., D·2·num_freqs) sin/cos features (GLIGEN-style), f32."""
    freqs = (2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)) * math.pi
    ang = x.float()[..., None] * freqs                           # (..., D, F)
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*x.shape[:-1], x.shape[-1] * 2 * num_freqs)


class BoxTokenizer(nn.Module):
    """(B, F, N, 4) boxes + (B, F, N) presence mask -> (B, F, N, dim) tokens."""

    def __init__(self, dim: int, num_freqs: int = 8, max_instances: int = 64):
        super().__init__()
        self.num_freqs = num_freqs
        self.instance_embedding = nn.Embedding(max_instances, dim)
        self.proj_1 = nn.Linear(4 * 2 * num_freqs, dim)
        self.proj_2 = nn.Linear(dim, dim)
        self.null_token = nn.Parameter(torch.zeros(dim))

    def forward(self, boxes: torch.Tensor, mask: torch.Tensor,
                instance_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, f, n, _ = boxes.shape
        dtype = self.proj_1.weight.dtype
        feats = fourier_embed(boxes, self.num_freqs)
        if instance_ids is None:
            instance_ids = torch.arange(n, device=boxes.device).expand(b, f, n)
        h = F.silu(self.proj_1(feats.to(dtype)) + self.instance_embedding(instance_ids))
        h = self.proj_2(h)
        m = mask.to(dtype)[..., None]
        return h * m + self.null_token * (1.0 - m)


class InstanceEnhancer(nn.Module):
    """Self-attention over frames per instance: (B, F, N, C) -> same."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, f, n, c = tokens.shape
        x = tokens.transpose(1, 2).reshape(b * n, f, c)
        h = self.norm1(x)
        heads = lambda a: split_heads(a, self.num_heads)
        o = dot_product_attention(heads(self.to_q(h)), heads(self.to_k(h)),
                                  heads(self.to_v(h)), impl="plain")
        x = x + self.to_out[0](o.reshape(b * n, f, c))
        x = x + self.ff(self.norm2(x))
        return x.reshape(b, n, f, c).transpose(1, 2)


class GatedSelfAttention(nn.Module):
    """GLIGEN-style gated injection: visual tokens (B·F, S, C) attend over
    [visual ++ box] tokens; each residual is scaled by tanh of its gate
    (``gate_init`` 0: an exact no-op while the attention is finite)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int, context_dim: int,
                 gate_init: float = 0.0):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.obj_proj = nn.Linear(context_dim, query_dim)
        self.norm1 = nn.LayerNorm(query_dim, eps=1e-5)
        self.to_q, self.to_k, self.to_v = (nn.Linear(query_dim, inner) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.norm2 = nn.LayerNorm(query_dim, eps=1e-5)
        self.ff = FeedForward(query_dim)
        self.alpha_attn = nn.Parameter(torch.full((1,), float(gate_init)))
        self.alpha_dense = nn.Parameter(torch.full((1,), float(gate_init)))

    def forward(self, x: torch.Tensor, objs: torch.Tensor) -> torch.Tensor:
        s = x.shape[1]
        y = self.norm1(torch.cat([x, self.obj_proj(objs)], dim=1))
        o = dot_product_attention_packed(self.to_q(y[:, :s]), self.to_k(y), self.to_v(y),
                                         num_heads=self.num_heads,
                                         scale=self.head_dim ** -0.5)
        gate = lambda a: torch.tanh(a.float())[0].to(x.dtype)
        x = x + gate(self.alpha_attn) * self.to_out[0](o)
        return x + gate(self.alpha_dense) * self.ff(self.norm2(x))


class TrackletConditioner(nn.Module):
    """Tokenize + enhance: boxes -> per-frame instance tokens (B·F, N, dim),
    folded like the UNet's frames-in-batch layout."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim = dim
        self.tokenizer = BoxTokenizer(dim)
        self.enhancer = InstanceEnhancer(dim, num_heads)

    def forward(self, boxes: torch.Tensor, mask: torch.Tensor,
                instance_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, f, n, _ = boxes.shape
        tokens = self.enhancer(self.tokenizer(boxes, mask, instance_ids))
        return tokens.reshape(b * f, n, self.dim)
