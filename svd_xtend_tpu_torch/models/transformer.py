"""Spatial + temporal transformer blocks of the SVD UNet.

Port of ``svd_xtend_tpu/models/transformer.py``. Per layer: a spatial
BasicTransformerBlock over the H*W tokens of each frame, then a
TemporalBasicTransformerBlock over the frame axis of the (B, F, S, C)
reshape of the same tokens (no transposes), merged by an AlphaBlender whose
sigmoid weights the temporal branch.

Kernel sites: the spatial self-attention ``attn1`` goes to the flash kernel
(ops/attention.py), the frame self-attention to the temporal-attention
kernel (both unless an attention processor is installed at the site,
models/attn_processor.py), the transformer ``norm`` to the GroupNorm kernel
(blocks.py), and every pre-LN feed-forward (norm3/ff, norm_in/ff_in) to the
fused residual GEGLU kernel (ops/kernels/geglu.py), as the JAX package
runs it by default (``SVDX_PALLAS_GEGLU`` on). The GELU is the tanh form, as
JAX's ``nn.gelu``. State-dict keys are the diffusers names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention_packed
from ..ops.kernels import geglu as gk
from ..ops.kernels import temporal_attention as tak
from ..ops.kernels.dispatch import kernels_enabled
from ..ops.video import spatial_tokens
from . import attn_processor
from .blocks import AlphaBlender, GroupNormSiLU
from .embeddings import TimestepEmbedding, sinusoidal_embedding


class Attention(nn.Module):
    """Multi-head attention, diffusers names: to_q/to_k/to_v bias-free,
    to_out.0 biased. ``site`` is its key in the processor registry (the
    UNet sets it to the module's name)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, out_dim: Optional[int] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim or query_dim)])
        self.site = ""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        proc = attn_processor.get_processor(self.site)
        if proc is not None:
            # full projections, no one-token shortcut (the processor may do
            # other math at this site)
            ctx = x if context is None else context
            o = proc(self.to_q(x), self.to_k(ctx), self.to_v(ctx), num_heads=self.num_heads,
                     scale=self.head_dim ** -0.5, site=self.site)
            return self.to_out[0](o)
        if context is not None and context.shape[-2] == 1:
            # Single-key cross-attention (the one CLIP token): softmax over
            # one key is 1, so every query's output is to_out(to_v(ctx)).
            out = self.to_out[0](self.to_v(context))        # (B, 1, out)
            return out.expand(x.shape[:-1] + (out.shape[-1],))
        ctx = x if context is None else context
        o = dot_product_attention_packed(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                         num_heads=self.num_heads,
                                         scale=self.head_dim ** -0.5)
        return self.to_out[0](o)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward: Linear(2·4C) -> h·gelu_tanh(gate) -> Linear(C);
    diffusers keys net.0.proj and net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))


def residual_geglu(x: torch.Tensor, ln: nn.LayerNorm, ff: FeedForward) -> torch.Tensor:
    """x + FeedForward(LayerNorm(x)), the JAX package's ResidualGEGLU: the
    fused kernel wherever it takes the call (its plain version on the CPU),
    the module path for a CUDA call it does not take."""
    proj, out = ff.net[0].proj, ff.net[2]
    if x.is_cuda and not (kernels_enabled() and gk.supports(x, out.in_features)):
        return x + ff(ln(x))
    return gk.ln_geglu_residual(x, ln.weight, ln.bias, proj.weight, proj.bias,
                                out.weight, out.bias)


class BasicTransformerBlock(nn.Module):
    """Pre-LN: self-attention, cross-attention, GEGLU feed-forward."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return residual_geglu(x, self.norm3, self.ff)


class FrameAxisAttention(Attention):
    """Attention over the frame axis of (B, F, S, C), in place. Same
    parameters as Attention; the context, when given, is one token per
    sample (B, 1, D), as it always is in SVD."""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        b, f, s, _ = x.shape
        proc = attn_processor.get_processor(self.site)
        if proc is not None:
            # the reference's temporal-token view (B·S, F, C), so one
            # processor signature covers spatial and frame sites
            inner = self.num_heads * self.head_dim
            tokens = lambda a: a.transpose(1, 2).reshape(b * s, f, inner)
            q = tokens(self.to_q(x))
            if context is None:
                k, v = tokens(self.to_k(x)), tokens(self.to_v(x))
            else:
                n = context.shape[-2]
                rows = lambda a: a[:, None].expand(b, s, n, inner).reshape(b * s, n, inner)
                k, v = rows(self.to_k(context)), rows(self.to_v(context))
            o = proc(q, k, v, num_heads=self.num_heads, scale=self.head_dim ** -0.5,
                     site=self.site)
            return self.to_out[0](o.reshape(b, s, f, inner).transpose(1, 2))
        if context is not None:
            if context.shape[-2] != 1:
                raise ValueError("FrameAxisAttention takes a single-token context")
            out = self.to_out[0](self.to_v(context))        # (B, 1, out)
            return out[:, :, None, :].expand(b, f, s, out.shape[-1])
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        scale = self.head_dim ** -0.5
        if kernels_enabled() and tak.supports(q, self.num_heads):
            o = tak.frame_attention(q, k, v, num_heads=self.num_heads, scale=scale)
        else:
            o = tak.frame_attention_reference(q, k, v, num_heads=self.num_heads,
                                              scale=scale)
        return self.to_out[0](o)


class TemporalBasicTransformerBlock(nn.Module):
    """FF-in, self-attention over frames, cross-attention, FF on (B, F, S, C)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = FrameAxisAttention(dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = FrameAxisAttention(dim, num_heads, head_dim, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = residual_geglu(x, self.norm_in, self.ff_in)
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return residual_geglu(x, self.norm3, self.ff)


class TransformerSpatioTemporalModel(nn.Module):
    """Factorized spatial + temporal transformer over (B*F, H, W, C)
    features, with (B*F, N, D) encoder states."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, num_layers: int = 1, norm_eps: float = 1e-6):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNormSiLU(channels, 32, norm_eps, silu=False)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_heads, head_dim, context_dim)
             for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, num_heads, head_dim, context_dim)
             for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(inner, inner, hidden_dim=inner * 4)
        self.time_mixer = AlphaBlender(0.5, switch_spatial_to_temporal_mix=True)
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                num_frames: int) -> torch.Tensor:
        bf, h, w, c = x.shape
        f = num_frames
        b = bf // f
        residual = x
        tokens = self.proj_in(spatial_tokens(self.norm(x)))
        inner = tokens.shape[-1]
        # cross-attention context of the temporal blocks: the first frame's
        # encoder state of each sample, (B, N, D)
        time_context = encoder_hidden_states.reshape(
            b, f, -1, encoder_hidden_states.shape[-1])[:, 0]
        frame_ids = torch.arange(f, dtype=torch.float32, device=x.device)
        emb = self.time_pos_embed(sinusoidal_embedding(frame_ids, inner).to(tokens.dtype))
        emb = emb.repeat(b, 1)[:, None, :]                 # (B*F, 1, inner)
        for block, tblock in zip(self.transformer_blocks,
                                 self.temporal_transformer_blocks):
            tokens = block(tokens, encoder_hidden_states)
            mix = (tokens + emb).reshape(b, f, h * w, inner)
            mix = tblock(mix, time_context).reshape(bf, h * w, inner)
            tokens = self.time_mixer(tokens, mix)
        return self.proj_out(tokens).reshape(bf, h, w, c) + residual
