"""UNetSpatioTemporalConditionModel — the SVD denoiser.

Port of ``svd_xtend_tpu/models/unet.py`` (the full forward, its remat
policy, the DeepCache split and the Tracklet2Video branch). Inputs are
channels-last: sample (B, F, H, W, 8), a scalar or (B,) timestep, encoder
states (B, N, D), added_time_ids (B, 3); output (B, F, H, W, 4). The module
computes in the dtype of its parameters; the sinusoids are f32.

Tracklet2Video (``UNetConfig.tracklet_dim > 0``, unet.py:268-277 in the JAX
package): ``tracklet_conditioner`` turns ``boxes`` (B, F, N, 4) and
``box_mask`` (B, F, N; all ones when not given) into (B·F, N, dim) tokens
once per forward, outside the remat blocks; every cross-attention down,
mid and up block hands them to its transformers' gated attentions (and a
checkpointed block's recompute gets them as an argument). Without boxes
the branch does not run.

Remat (``remat=``, unet.py:200-295 in the JAX package): "none" keeps every
activation for the backward; "block" recomputes every top-level block (the
down blocks, the mid block, the up blocks) in the backward; "outer" only
those of resolution levels 0-1 (down blocks 0-1 and their up mirrors),
which hold most of the activation bytes. It uses
``torch.utils.checkpoint(use_reentrant=False)`` and applies only while grad
mode is on; the kernels launch again in the recompute. Each checkpointed
block runs under the profiler label ``unet.checkpointed_block``, so a trace
tells its recompute (inside the backward) from the rest of the backward.

DeepCache (``cache_depth=d``, unet.py:217-392 in the JAX package):
``return_deep=True`` runs the full forward and also returns the deep
feature, the input of up block ``n_up - d``, as (b, f, h, w, c);
``cached_deep=deep`` runs the shallow forward: down blocks [0, d) (the last
one without its downsampler, whose output only fed the skipped levels),
``deep`` in place of the skipped trunk, then up blocks [n_up - d, n_up) and
the head. ``shallow(x, full(x).deep) == full(x)``: the same operations on
the same tensors.

Sequence parallelism (``shard=``, a ``parallel.FrameShard``): each rank of a
frames group runs the spatial layers on its F / n frames; the temporal
transformer blocks swap to a token shard of every frame and back, the
temporal resnets gather every frame (``parallel/frames.py``). The shard is
an argument of every block, not thread-local state, so a checkpointed
block's recompute (on the autograd engine's thread) runs the same
collectives in the same order on every rank.

Tensor parallelism (``tp=``, a ``parallel.TensorShard``): the transformers
are built for this model rank's part of their matrices
(``models/transformer.py``, ``parallel/tensor.py``); every other layer is
replicated. Unlike the frames shard, the model shard is a property of the
module as built: ``parallel.tensor.shard_state_dict`` slices a whole state
dict for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import UNetConfig
from ..ops.kernels.dispatch import kernels_enabled, plain_versions
from ..parallel.frames import FrameShard
from . import attn_processor
from .blocks import (Conv3x3, Downsample2D, GroupNormSiLU, SpatioTemporalResBlock,
                     Upsample2D)
from .embeddings import TimestepEmbedding, sinusoidal_embedding
from .transformer import Attention, TransformerSpatioTemporalModel


class DownBlock(nn.Module):
    """(CrossAttn)DownBlockSpatioTemporal: resnets (+ transformers), then an
    optional stride-2 downsampler. Returns the output and its skips."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int, eps: float, add_downsample: bool,
                 num_heads: Optional[int] = None, context_dim: int = 0,
                 transformer_layers: int = 1, tracklet: Tuple[int, float] = (0, 0.0),
                 tp=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(in_channels if i == 0 else out_channels,
                                    out_channels, temb_channels, eps)
             for i in range(num_layers)])
        self.attentions = None
        if num_heads is not None:
            self.attentions = nn.ModuleList(
                [TransformerSpatioTemporalModel(out_channels, num_heads,
                                                out_channels // num_heads,
                                                context_dim, transformer_layers,
                                                tracklet_dim=tracklet[0],
                                                tracklet_gate_init=tracklet[1], tp=tp)
                 for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels, out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, ehs, num_frames, downsample: bool = True, tokens=None,
                shard=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, num_frames, shard=shard)
            if self.attentions is not None:
                x = self.attentions[i](x, ehs, num_frames, tokens, shard)
            skips.append(x)
        if self.downsamplers is not None and downsample:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    """UNetMidBlockSpatioTemporal: resnet, transformer, resnet."""

    def __init__(self, channels: int, temb_channels: int, eps: float,
                 num_heads: int, context_dim: int, transformer_layers: int = 1,
                 tracklet: Tuple[int, float] = (0, 0.0), tp=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(channels, channels, temb_channels, eps)
             for _ in range(2)])
        self.attentions = nn.ModuleList(
            [TransformerSpatioTemporalModel(channels, num_heads, channels // num_heads,
                                            context_dim, transformer_layers,
                                            tracklet_dim=tracklet[0],
                                            tracklet_gate_init=tracklet[1], tp=tp)])

    def forward(self, x, temb, ehs, num_frames, tokens=None, shard=None):
        x = self.resnets[0](x, temb, num_frames, shard=shard)
        x = self.attentions[0](x, ehs, num_frames, tokens, shard)
        return self.resnets[1](x, temb, num_frames, shard=shard)


class UpBlock(nn.Module):
    """(CrossAttn)UpBlockSpatioTemporal: each resnet takes the running
    features and one skip as the two parts of a channel concat that is never
    built (the JAX package's split-concat form); then an optional
    upsampler."""

    def __init__(self, prev_channels: int, out_channels: int,
                 skip_channels: Sequence[int], temb_channels: int, eps: float,
                 add_upsample: bool, num_heads: Optional[int] = None,
                 context_dim: int = 0, transformer_layers: int = 1,
                 tracklet: Tuple[int, float] = (0, 0.0), tp=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [SpatioTemporalResBlock((prev_channels if i == 0 else out_channels) + sc,
                                    out_channels, temb_channels, eps)
             for i, sc in enumerate(skip_channels)])
        self.attentions = None
        if num_heads is not None:
            self.attentions = nn.ModuleList(
                [TransformerSpatioTemporalModel(out_channels, num_heads,
                                                out_channels // num_heads,
                                                context_dim, transformer_layers,
                                                tracklet_dim=tracklet[0],
                                                tracklet_gate_init=tracklet[1], tp=tp)
                 for _ in skip_channels])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x, skips: List[torch.Tensor], temb, ehs, num_frames, tokens=None,
                shard=None):
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, num_frames, skip_cat=skips[-(i + 1)], shard=shard)
            if self.attentions is not None:
                x = self.attentions[i](x, ehs, num_frames, tokens, shard)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, tp=None):
        super().__init__()
        cfg = self.config = config
        self.tp = tp
        chs = cfg.block_out_channels
        tdim = cfg.time_embed_dim
        ctx = cfg.cross_attention_dim
        eps = cfg.resnet_eps
        n = len(chs)
        tracklet = (cfg.tracklet_dim, cfg.tracklet_gate_init)
        self.conv_in = Conv3x3(cfg.in_channels, chs[0])
        self.time_embedding = TimestepEmbedding(chs[0], tdim)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, tdim)

        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, btype in enumerate(cfg.down_block_types):
            cross = _block_kind(btype, "Down")
            self.down_blocks.append(DownBlock(
                cin, chs[i], tdim, cfg.layers_per_block, eps, i < n - 1,
                cfg.num_attention_heads[i] if cross else None, ctx,
                cfg.transformer_layers_per_block[i], tracklet, tp))
            cin = chs[i]
        self.mid_block = MidBlock(chs[-1], tdim, eps, cfg.num_attention_heads[-1],
                                  ctx, cfg.transformer_layers_per_block[-1], tracklet, tp)

        rev = list(reversed(chs))
        rev_heads = list(reversed(cfg.num_attention_heads))
        rev_tl = list(reversed(cfg.transformer_layers_per_block))
        n_res = cfg.layers_per_block + 1
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            cross = _block_kind(btype, "Up")
            # skips pop from the end: all at this level, the last one from
            # the next-higher-resolution level's downsampler (or conv_in)
            skip_ch = [rev[i]] * (n_res - 1) + [rev[min(i + 1, n - 1)]]
            self.up_blocks.append(UpBlock(
                prev, rev[i], skip_ch, tdim, eps, i < n - 1,
                rev_heads[i] if cross else None, ctx, rev_tl[i], tracklet, tp))
            prev = rev[i]
        self.conv_norm_out = GroupNormSiLU(chs[0], 32, eps)
        self.conv_out = Conv3x3(chs[0], cfg.out_channels)
        self.tracklet_conditioner = None
        if cfg.tracklet_dim > 0:
            from .tracklet import TrackletConditioner
            self.tracklet_conditioner = TrackletConditioner(cfg.tracklet_dim,
                                                            cfg.tracklet_heads)
        for name, m in self.named_modules():
            if isinstance(m, Attention):        # the attention-processor sites
                m.site = name

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                added_time_ids: torch.Tensor, remat: str = "none",
                cached_deep: Optional[torch.Tensor] = None, return_deep: bool = False,
                cache_depth: int = 1, boxes: Optional[torch.Tensor] = None,
                box_mask: Optional[torch.Tensor] = None,
                instance_ids: Optional[torch.Tensor] = None,
                shard: Optional[FrameShard] = None):
        """(B, F, H, W, out) — with ``return_deep``, (out, deep feature).
        With a frames `shard`, `sample` (and `cached_deep`, the output and
        the deep feature) hold this rank's frames, and `boxes` / `box_mask`
        every frame."""
        cfg = self.config
        if remat not in ("none", "block", "outer"):
            raise ValueError(f"unknown remat policy {remat!r}")
        n_levels = len(cfg.block_out_channels)
        n_up = len(self.up_blocks)
        shallow = cached_deep is not None
        if (shallow or return_deep) and not 1 <= cache_depth < n_up:
            raise ValueError(f"cache_depth must be in [1, {n_up - 1}], got {cache_depth}")
        if shallow and return_deep:
            raise ValueError("cached_deep and return_deep are exclusive")

        def run(block, level, *args):
            # level: resolution index (0 = highest); None = the mid block
            if (remat == "none" or not torch.is_grad_enabled()
                    or (remat == "outer" and (level is None or level > 1))):
                return block(*args)
            return checkpoint(_labelled(block), *args, use_reentrant=False)

        b, f, h, w, _ = sample.shape
        if shard is not None and f != shard.count:
            raise ValueError(f"a sample of {f} frames for a shard of {shard.count}")
        dtype = self.conv_in.weight.dtype
        device = sample.device
        timestep = torch.as_tensor(timestep, dtype=torch.float32, device=device)
        timestep = timestep.reshape(-1).expand(b)
        emb = self.time_embedding(
            sinusoidal_embedding(timestep, cfg.block_out_channels[0]).to(dtype))
        add_sin = sinusoidal_embedding(added_time_ids.reshape(-1).float(),
                                       cfg.addition_time_embed_dim).reshape(b, -1)
        emb = emb + self.add_embedding(add_sin.to(dtype))

        x = sample.to(dtype).reshape(b * f, h, w, sample.shape[-1])
        emb_f = emb.repeat_interleave(f, dim=0)
        ehs_f = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)

        tokens = None
        if self.tracklet_conditioner is not None and boxes is not None:
            if box_mask is None:
                box_mask = torch.ones(boxes.shape[:3], device=boxes.device)
            tokens = self.tracklet_conditioner(boxes, box_mask, instance_ids)
            if shard is not None:
                # the enhancer attends over frames: every rank tokenises the
                # whole clip and keeps its frames
                tokens = shard.own(tokens.reshape((b, -1) + tokens.shape[1:]))
                tokens = tokens.reshape((b * f,) + tokens.shape[2:])

        x = self.conv_in(x)
        skips = [x]
        for i, block in enumerate(self.down_blocks):
            if shallow and i >= cache_depth:
                break
            downsample = not (shallow and i == cache_depth - 1)
            x, res = run(block, i, x, emb_f, ehs_f, f, downsample, tokens, shard)
            skips.extend(res)
        if not shallow:
            x = run(self.mid_block, None, x, emb_f, ehs_f, f, tokens, shard)
        deep = None
        for i, block in enumerate(self.up_blocks):
            if shallow and i < n_up - cache_depth:
                continue
            if shallow and i == n_up - cache_depth:
                x = cached_deep.to(dtype).reshape((b * f,) + cached_deep.shape[2:])
            n_res = len(block.resnets)
            x = run(block, n_levels - 1 - i, x, skips[-n_res:], emb_f, ehs_f, f, tokens, shard)
            skips = skips[:-n_res]
            if return_deep and i == n_up - cache_depth - 1:
                deep = x
        x = self.conv_out(self.conv_norm_out(x))
        out = x.reshape(b, f, h, w, cfg.out_channels)
        if return_deep:
            return out, deep.reshape((b, f) + deep.shape[1:])
        return out


def _labelled(block):
    """`block` under its profiler label, with the kernel dispatch and the
    attention processors in force when it is wrapped (the forward) also in
    its recompute: that runs in the backward, on a CUDA tensor on the
    autograd engine's own thread, which does not see the thread-local
    settings of the forward's thread."""
    plain, proc = not kernels_enabled(), attn_processor.current()

    def run(*args):
        with torch.profiler.record_function("unet.checkpointed_block"), \
                plain_versions(plain), attn_processor.processors(proc):
            return block(*args)
    return run


def _block_kind(block_type: str, direction: str) -> bool:
    """True for the cross-attention variant; raises on unknown types."""
    plain = f"{direction}BlockSpatioTemporal"
    if block_type == plain:
        return False
    if block_type == f"CrossAttn{plain}":
        return True
    raise ValueError(f"unknown {direction.lower()} block {block_type!r}")
