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

The projections at the JAX package's ``QDense`` sites (the attentions'
to_q/k/v/out, the feed-forwards' net.0.proj / net.2, proj_in / proj_out)
are ``QLinear``: in int8 mode (``ops/quant.py``) the W8A8 dense product,
through the int8 quantise and GEMM kernels on CUDA, and the feed-forwards
leave the fused GEGLU kernel for the module path, as JAX turns it off
there (transformer.py:264).

With ``tracklet_dim > 0`` each spatial block is followed by a Tracklet2Video
gated attention (``gated_attentions``, models/tracklet.py), which runs only
when box tokens are given (JAX transformer.py:533-539).

Tensor parallelism (``tp=``, a ``parallel.TensorShard``; the 'model' mesh
axis, ``parallel/tensor.py``): each module is built for its rank's part.
Attention runs its rank's whole heads (q/k/v column-parallel, ``to_out``
row-parallel); the feed-forward its columns of the inner width, through
the GEGLU kernel's partial form (``ln_geglu_partial``: no b2, no residual)
and an all-reduce, then b2 and x; ``proj_in`` column-parallel with its
channels gathered, ``proj_out`` row-parallel on this rank's channels. The
shard is a property of the modules as built, not a per-call setting, so a
remat recompute (on the autograd engine's thread) runs the same
collectives. The gated attentions stay replicated. An attention
processor sees every head, as under JAX's GSPMD: q, k and v are gathered
over the model group (``gather_channels``, whose backward keeps this
rank's columns), the processor runs on the whole heads on every rank, and
this rank keeps its heads' columns of its output (``scatter_channels``)
for its row-parallel ``to_out``; the default path stays head-local.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..ops.attention import dot_product_attention_packed
from ..ops.kernels import geglu as gk
from ..ops.kernels import int8_gemm as i8k
from ..ops.kernels import temporal_attention as tak
from ..ops.kernels.dispatch import kernels_enabled
from ..ops.video import spatial_tokens
from ..parallel.frames import FrameShard, frames_to_tokens, tokens_to_frames
from ..parallel.tensor import (TensorShard, enter, gather_channels, reduce,
                               scatter_channels, split)
from . import attn_processor
from .blocks import AlphaBlender, GroupNormSiLU
from .embeddings import TimestepEmbedding, sinusoidal_embedding


class QLinear(nn.Linear):
    """nn.Linear with the opt-in W8A8 path of the JAX package's ``QDense``
    (transformer.py:39-76): in int8 mode, the activation quantised per
    tensor and the product on int8 codes (``int8_gemm.linear_site``);
    otherwise nn.Linear. Same parameters and state-dict keys."""

    def forward(self, x: torch.Tensor, codes=None, gate: bool = False) -> torch.Tensor:
        """`codes` and `gate` are the int8 mode's (``int8_gemm.linear_site``):
        x's codes made once for the projections that share it, and x as
        net.0.proj's [h, g] for the product's input h·gelu_tanh(g)."""
        if quant.get_mode() == "int8":
            return i8k.linear_site(x, self.weight, self.bias, codes=codes, gate=gate)
        return super().forward(x)

    def int8_codes(self):
        """The weight's int8 codes and scales (made once per parameter
        version)."""
        return i8k.dense_codes(self.weight)


class RowParallelLinear(QLinear):
    """A row-parallel QLinear: this model rank's `in_features` columns of the
    weight and the whole bias; the partial products are summed over the
    model group (``parallel.tensor.reduce``), then the bias is added once.
    In int8 mode the int32 sums are summed instead (``linear_site(...,
    group=)``), with each output channel's weight amax the whole
    channel's."""

    def __init__(self, in_features: int, out_features: int, tp: TensorShard,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.tp = tp

    def forward(self, x: torch.Tensor, codes=None, gate: bool = False) -> torch.Tensor:
        if quant.get_mode() == "int8":
            return i8k.linear_site(x, self.weight, self.bias, group=self.tp.group, codes=codes,
                                   gate=gate)
        y = reduce(F.linear(x, self.weight), self.tp)
        return y if self.bias is None else y + self.bias

    def int8_codes(self):
        return i8k.row_dense_codes(self.weight, self.tp.group)


def _out_proj(inner: int, out: int, tp: Optional[TensorShard]) -> QLinear:
    return QLinear(inner, out) if tp is None else RowParallelLinear(inner, out, tp)


class Attention(nn.Module):
    """Multi-head attention, diffusers names: to_q/to_k/to_v bias-free,
    to_out.0 biased. ``site`` is its key in the processor registry (the
    UNet sets it to the module's name). With `tp`, this model rank's heads
    (``num_heads`` is theirs)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.tp = tp
        self.total_heads = num_heads
        if tp is not None:
            num_heads = tp.heads(num_heads)
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        ctx = context_dim or query_dim
        self.to_q = QLinear(query_dim, inner, bias=False)
        self.to_k = QLinear(ctx, inner, bias=False)
        self.to_v = QLinear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([_out_proj(inner, out_dim or query_dim, tp)])
        self.site = ""

    def _processor(self):
        return attn_processor.get_processor(self.site)

    def _process(self, proc, q, k, v):
        """`proc` over every head: on a model rank, q, k and v gathered over
        the model group and this rank's heads' columns of the output kept."""
        if self.tp is None:
            return proc(q, k, v, num_heads=self.num_heads, scale=self.head_dim ** -0.5,
                        site=self.site)
        sizes = [h * self.head_dim for h in split(self.total_heads, self.tp.size)]
        q, k, v = (gather_channels(t, self.tp, sizes) for t in (q, k, v))
        o = proc(q, k, v, num_heads=self.total_heads, scale=self.head_dim ** -0.5,
                 site=self.site)
        return scatter_channels(o, self.tp, sizes)

    def _project(self, x, ctx):
        """to_q(x), to_k(ctx), to_v(ctx). In int8 mode a self-attention (ctx
        is x) quantises x once and the three products read those codes, bit
        for bit what three quantisations give."""
        if ctx is x and quant.get_mode() == "int8":
            codes = i8k.linear_codes(x)
            return tuple(p(x, codes=codes) for p in (self.to_q, self.to_k, self.to_v))
        return self.to_q(x), self.to_k(ctx), self.to_v(ctx)

    def _enter(self, x, context):
        """x and the context (x where None), entering the model group."""
        if self.tp is None:
            return x, (x if context is None else context)
        if context is None:
            x, = enter(self.tp, x)
            return x, x
        return enter(self.tp, x, context)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        proc = self._processor()
        if proc is not None:
            # full projections, no one-token shortcut (the processor may do
            # other math at this site)
            x, ctx = self._enter(x, context)
            o = self._process(proc, *self._project(x, ctx))
            return self.to_out[0](o)
        if context is not None and context.shape[-2] == 1:
            # Single-key cross-attention (the one CLIP token): softmax over
            # one key is 1, so every query's output is to_out(to_v(ctx)).
            if self.tp is not None:
                context, = enter(self.tp, context)
            out = self.to_out[0](self.to_v(context))        # (B, 1, out)
            return out.expand(x.shape[:-1] + (out.shape[-1],))
        x, ctx = self._enter(x, context)
        q, k, v = self._project(x, ctx)
        if self.num_heads == 0:
            # a model rank without a head: its (..., 0) part, a zero partial
            return self.to_out[0](q)
        o = dot_product_attention_packed(q, k, v, num_heads=self.num_heads,
                                         scale=self.head_dim ** -0.5)
        return self.to_out[0](o)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QLinear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward: Linear(2·4C) -> h·gelu_tanh(gate) -> Linear(C);
    diffusers keys net.0.proj and net.2. With `tp`, this model rank's
    columns of the inner width (net.0.proj its value rows, then the same
    gate rows; net.2 row-parallel)."""

    def __init__(self, dim: int, mult: int = 4, tp: Optional[TensorShard] = None):
        super().__init__()
        self.tp = tp
        inner = dim * mult if tp is None else tp.ff(dim * mult)
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  _out_proj(inner, dim, tp)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x, = enter(self.tp, x)
        y = self.net[0].proj(x)
        if quant.get_mode() == "int8":
            # the quantise kernel computes h·gelu_tanh(g) as it reads y
            return self.net[2](y, gate=True)
        h, gate = y.chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate, approximate="tanh"))


def residual_geglu(x: torch.Tensor, ln: nn.LayerNorm, ff: FeedForward) -> torch.Tensor:
    """x + FeedForward(LayerNorm(x)), the JAX package's ResidualGEGLU: the
    fused kernel wherever it takes the call (its plain version on the CPU),
    the module path for a CUDA call it does not take and in int8 mode
    (LN → QLinear → h·gelu_tanh(gate) → QLinear → + x, JAX
    transformer.py:264). Under tensor parallelism the kernel's partial form
    gives this rank's part of the second product, summed over the model
    group, then b2 and x are added."""
    proj, out = ff.net[0].proj, ff.net[2]
    inner = out.in_features
    if ff.tp is None:
        if quant.get_mode() == "int8" or (
                x.is_cuda and not (kernels_enabled() and gk.supports(x, inner))):
            return x + ff(ln(x))
        return gk.ln_geglu_residual(x, ln.weight, ln.bias, proj.weight, proj.bias,
                                    out.weight, out.bias)
    if quant.get_mode() == "int8" or (
            x.is_cuda and not (kernels_enabled() and gk.supports_partial(x, inner))):
        return x + ff(ln(x))
    # the LayerNorm runs inside the kernel, after the model group's entry:
    # its weights enter too, so their gradients are summed
    xe, ls, lb = enter(ff.tp, x, ln.weight, ln.bias)
    y = reduce(gk.ln_geglu_partial(xe, ls, lb, proj.weight, proj.bias, out.weight), ff.tp)
    return x + (y + out.bias)


class BasicTransformerBlock(nn.Module):
    """Pre-LN: self-attention, cross-attention, GEGLU feed-forward."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, tp=tp)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim=context_dim, tp=tp)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, tp=tp)

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
        proc = self._processor()
        if proc is not None:
            # the reference's temporal-token view (B·S, F, C), so one
            # processor signature covers spatial and frame sites
            inner = self.num_heads * self.head_dim
            x, ctx = self._enter(x, context)
            tokens = lambda a: a.transpose(1, 2).reshape(b * s, f, inner)
            if context is None:
                q, k, v = (tokens(t) for t in self._project(x, x))
            else:
                q = tokens(self.to_q(x))
                n = ctx.shape[-2]
                rows = lambda a: a[:, None].expand(b, s, n, inner).reshape(b * s, n, inner)
                k, v = rows(self.to_k(ctx)), rows(self.to_v(ctx))
            o = self._process(proc, q, k, v)
            return self.to_out[0](o.reshape(b, s, f, inner).transpose(1, 2))
        if context is not None:
            if context.shape[-2] != 1:
                raise ValueError("FrameAxisAttention takes a single-token context")
            if self.tp is not None:
                context, = enter(self.tp, context)
            out = self.to_out[0](self.to_v(context))        # (B, 1, out)
            return out[:, :, None, :].expand(b, f, s, out.shape[-1])
        x, _ = self._enter(x, None)
        q, k, v = self._project(x, x)
        scale = self.head_dim ** -0.5
        if self.num_heads == 0:
            return self.to_out[0](q)
        if kernels_enabled() and tak.supports(q, self.num_heads):
            o = tak.frame_attention(q, k, v, num_heads=self.num_heads, scale=scale)
        else:
            o = tak.frame_attention_reference(q, k, v, num_heads=self.num_heads,
                                              scale=scale)
        return self.to_out[0](o)


class TemporalBasicTransformerBlock(nn.Module):
    """FF-in, self-attention over frames, cross-attention, FF on (B, F, S, C)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = FeedForward(dim, tp=tp)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = FrameAxisAttention(dim, num_heads, head_dim, tp=tp)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = FrameAxisAttention(dim, num_heads, head_dim, context_dim=context_dim,
                                        tp=tp)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, tp=tp)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = residual_geglu(x, self.norm_in, self.ff_in)
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return residual_geglu(x, self.norm3, self.ff)


class TransformerSpatioTemporalModel(nn.Module):
    """Factorized spatial + temporal transformer over (B*F, H, W, C)
    features, with (B*F, N, D) encoder states."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, num_layers: int = 1, norm_eps: float = 1e-6,
                 tracklet_dim: int = 0, tracklet_gate_init: float = 0.0,
                 tp: Optional[TensorShard] = None):
        super().__init__()
        inner = num_heads * head_dim
        self.tp = tp
        # under tensor parallelism proj_in's outputs and proj_out's inputs
        # are this rank's channels of the inner width
        self.channel_sizes = None if tp is None else tp.channels(inner)
        local = inner if tp is None else self.channel_sizes[tp.index]
        self.norm = GroupNormSiLU(channels, 32, norm_eps, silu=False)
        self.proj_in = QLinear(channels, local)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_heads, head_dim, context_dim, tp)
             for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(inner, num_heads, head_dim, context_dim, tp)
             for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(inner, inner, hidden_dim=inner * 4)
        self.time_mixer = AlphaBlender(0.5, switch_spatial_to_temporal_mix=True)
        self.proj_out = _out_proj(local, channels, tp)
        self.gated_attentions = None
        if tracklet_dim > 0:
            from .tracklet import GatedSelfAttention
            self.gated_attentions = nn.ModuleList(
                [GatedSelfAttention(inner, num_heads, head_dim, tracklet_dim,
                                    tracklet_gate_init) for _ in range(num_layers)])

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                num_frames: int, tracklet_tokens: Optional[torch.Tensor] = None,
                shard: Optional[FrameShard] = None) -> torch.Tensor:
        """`num_frames`: the frames x holds of each sample; with a `shard`,
        this rank's frames of its videos, and the temporal blocks run on a
        token shard of every frame (``parallel/frames.py``)."""
        bf, h, w, c = x.shape
        f = num_frames
        b = bf // f
        residual = x
        tp = self.tp
        tokens = spatial_tokens(self.norm(x))
        if tp is None:
            tokens = self.proj_in(tokens)
        else:
            tokens, = enter(tp, tokens)
            tokens = gather_channels(self.proj_in(tokens), tp, self.channel_sizes)
        inner = tokens.shape[-1]
        # cross-attention context of the temporal blocks: the first frame's
        # encoder state of each sample, (B, N, D); the UNet repeats one state
        # per sample over its frames, so a rank's first frame holds it too
        time_context = encoder_hidden_states.reshape(
            b, f, -1, encoder_hidden_states.shape[-1])[:, 0]
        # the frame position embedding of every frame: with a shard it is
        # added on the token shard, which holds all F frames in order
        frame_ids = torch.arange(f if shard is None else shard.total, dtype=torch.float32,
                                 device=x.device)
        emb = self.time_pos_embed(sinusoidal_embedding(frame_ids, inner).to(tokens.dtype))
        if shard is None:
            emb = emb.repeat(b, 1)[:, None, :]             # (B*F, 1, inner)
        gated = self.gated_attentions if tracklet_tokens is not None else None
        for i, (block, tblock) in enumerate(zip(self.transformer_blocks,
                                                self.temporal_transformer_blocks)):
            tokens = block(tokens, encoder_hidden_states)
            if gated is not None:
                tokens = gated[i](tokens, tracklet_tokens)
            if shard is None:
                mix = (tokens + emb).reshape(b, f, h * w, inner)
                mix = tblock(mix, time_context).reshape(bf, h * w, inner)
            else:
                # (B, F/n, S, C) -> (B, F, S_r, C), the whole block on every
                # frame of this rank's tokens, and back
                mix = frames_to_tokens(tokens.reshape(b, f, h * w, inner), shard)
                mix = tblock(mix + emb[None, :, None, :], time_context)
                mix = tokens_to_frames(mix, shard, h * w).reshape(bf, h * w, inner)
            tokens = self.time_mixer(tokens, mix)
        if tp is not None:
            tokens = scatter_channels(tokens, tp, self.channel_sizes)
        return self.proj_out(tokens).reshape(bf, h, w, c) + residual
