"""Plain float32 reference of Stable Video Diffusion (img2vid, img2vid-xt).

The networks of diffusers' StableVideoDiffusionPipeline, written again in
plain torch operations: UNetSpatioTemporalConditionModel,
AutoencoderKLTemporalDecoder and transformers' CLIPVisionModelWithProjection,
with their published state-dict names, on NCHW activations (the entry points
take and return the channels-last tensors the benchmark hands both sides).
It imports nothing of the program. Run it with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False): ``f32_context``.

Departures from diffusers, each exact or the program's stated math:
  - the GEGLU feed-forward uses the tanh GELU: the program follows the JAX
    package, whose ``nn.gelu`` is the tanh form (diffusers: erf);
  - a cross-attention over one context token (SVD's single CLIP token)
    returns to_out(to_v(context)) for every query: softmax over one key is
    exactly 1, so q and k drop out;
  - attention is ``F.scaled_dot_product_attention`` in f32 (on the card its
    memory-efficient kernel, products in 3xTF32, f32 to within rounding).

``Num`` rounds every matmul and conv operand: exact in f32, or fp8 e4m3 with
a per-tensor scale for the control of the correctness check (the forward
rounded, the backward straight through).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class Num:
    """How matmul and conv operands are rounded."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        d = t.detach()
        s = d.abs().amax().clamp_min(1e-30) / 448.0
        q = (d / s).to(torch.float8_e4m3fn).float() * s
        return t + (q - d)


EXACT = Num()


@contextlib.contextmanager
def f32_context():
    """TF32 off for cuBLAS and cuDNN while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Linear(nn.Linear):
    def __init__(self, i: int, o: int, bias: bool = True, num: Num = EXACT):
        super().__init__(i, o, bias)
        self.num = num

    def forward(self, x):
        return F.linear(self.num(x), self.num(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, i, o, k, stride=1, padding=0, bias=True, num: Num = EXACT):
        super().__init__(i, o, k, stride=stride, padding=padding, bias=bias)
        self.num = num

    def forward(self, x):
        return F.conv2d(self.num(x), self.num(self.weight), self.bias, self.stride,
                        self.padding)


class Conv3d(nn.Conv3d):
    """The (3, 1, 1) frame conv over (B, C, F, H, W), zero padding."""

    def __init__(self, i, o, num: Num = EXACT):
        super().__init__(i, o, (3, 1, 1), padding=(1, 0, 0))
        self.num = num

    def forward(self, x):
        return F.conv3d(self.num(x), self.num(self.weight), self.bias, padding=(1, 0, 0))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attend(q, k, v, heads: int, num: Num) -> torch.Tensor:
    """Softmax attention over the second-to-last axis of (..., L, C) q and
    (..., S, C) k, v, `heads` heads of C / heads, scale head_dim ** -0.5."""
    lead, lq, c = q.shape[:-2], q.shape[-2], q.shape[-1]
    split = lambda t: t.reshape(-1, t.shape[-2], heads, c // heads).transpose(1, 2)
    o = F.scaled_dot_product_attention(split(num(q)), split(num(k)), split(num(v)))
    return o.transpose(1, 2).reshape(*lead, lq, c)


class TimestepEmbedding(nn.Module):
    def __init__(self, i: int, hidden: int, o: int, num: Num):
        super().__init__()
        self.linear_1 = Linear(i, hidden, num=num)
        self.linear_2 = Linear(hidden, o, num=num)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None,
                 bias: bool = False, num: Num = EXACT):
        super().__init__()
        self.heads, self.num = heads, num
        self.to_q = Linear(dim, dim, bias, num)
        self.to_k = Linear(ctx_dim or dim, dim, bias, num)
        self.to_v = Linear(ctx_dim or dim, dim, bias, num)
        self.to_out = nn.ModuleList([Linear(dim, dim, num=num)])

    def forward(self, x, ctx=None):
        if ctx is not None and ctx.shape[-2] == 1:
            o = self.to_out[0](self.to_v(ctx))                    # (N, 1, C)
            shape = (o.shape[0],) + (1,) * (x.dim() - 2) + (o.shape[-1],)
            return o.reshape(shape).expand(x.shape[:-1] + (o.shape[-1],))
        c = x if ctx is None else ctx
        return self.to_out[0](attend(self.to_q(x), self.to_k(c), self.to_v(c), self.heads,
                                     self.num))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, num: Num):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, num=num)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, num: Num):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, num), nn.Identity(),
                                  Linear(4 * dim, dim, num=num)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class AlphaBlender(nn.Module):
    """a·spatial + (1 - a)·temporal, a = sigmoid(mix_factor), or 1 - that
    with `switch` (diffusers' switch_spatial_to_temporal_mix)."""

    def __init__(self, switch: bool):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, xs, xt):
        a = torch.sigmoid(self.mix_factor)
        if self.switch:
            a = 1.0 - a
        return a * xs + (1.0 - a) * xt


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float, num: Num):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, num=num)
        self.time_emb_proj = Linear(temb, cout, num=num) if temb else None
        self.norm2 = nn.GroupNorm(32, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, num=num)
        self.conv_shortcut = Conv2d(cin, cout, 1, num=num) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class TemporalResnetBlock(nn.Module):
    """(B, C, F, H, W) in and out."""

    def __init__(self, c: int, temb: Optional[int], eps: float, num: Num):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, c, eps)
        self.conv1 = Conv3d(c, c, num)
        self.time_emb_proj = Linear(temb, c, num=num) if temb else None
        self.norm2 = nn.GroupNorm(32, c, eps)
        self.conv2 = Conv3d(c, c, num)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            t = self.time_emb_proj(F.silu(temb))                  # (B, F, C)
            h = h + t.permute(0, 2, 1)[:, :, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return x + h


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin, cout, temb, eps, temporal_eps, switch, num: Num):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps, num)
        self.temporal_res_block = TemporalResnetBlock(cout, temb, temporal_eps, num)
        self.time_mixer = AlphaBlender(switch)

    def forward(self, x, temb, frames: int):
        h = self.spatial_res_block(x, temb)
        bf, c, hh, ww = h.shape
        b = bf // frames
        h5 = h.reshape(b, frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        t = temb.reshape(b, frames, -1) if temb is not None else None
        out = self.time_mixer(h5, self.temporal_res_block(h5, t))
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, ctx_dim, num: Num):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, num=num)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, ctx_dim, num=num)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, num)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """On (B, S, F, C): attention over the frame axis."""

    def __init__(self, dim, heads, ctx_dim, num: Num):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim, num)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, num=num)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, ctx_dim, num=num)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, num)

    def forward(self, x, ctx):
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, c: int, heads: int, ctx_dim: int, layers: int, num: Num):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, 1e-6)
        self.proj_in = Linear(c, c, num=num)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(c, heads, ctx_dim, num) for _ in range(layers)])
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(c, heads, ctx_dim, num) for _ in range(layers)])
        self.time_pos_embed = TimestepEmbedding(c, 4 * c, c, num)
        self.time_mixer = AlphaBlender(switch=True)
        self.proj_out = Linear(c, c, num=num)

    def forward(self, x, ehs, frames: int):
        bf, c, h, w = x.shape
        b, s = bf // frames, h * w
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bf, s, c))
        time_ctx = ehs.reshape(b, frames, *ehs.shape[1:])[:, 0]          # (B, 1, D)
        emb = self.time_pos_embed(timestep_embedding(
            torch.arange(frames, device=x.device), c))                      # (F, C)
        for block, tblock in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            t = block(t, ehs)
            mix = (t.reshape(b, frames, s, c) + emb[None, :, None, :]).transpose(1, 2)
            mix = tblock(mix, time_ctx).transpose(1, 2).reshape(bf, s, c)
            t = self.time_mixer(t, mix)
        t = self.proj_out(t)
        return t.reshape(bf, h, w, c).permute(0, 3, 1, 2) + x


class Downsample2D(nn.Module):
    def __init__(self, c: int, asymmetric: bool, num: Num):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv2d(c, c, 3, stride=2, padding=0 if asymmetric else 1, num=num)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample2D(nn.Module):
    def __init__(self, c: int, num: Num):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1, num=num)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down, mid or up block of the UNet (resnets, attentions, samplers)."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)

    def attention(self, i):
        return self.attentions[i] if hasattr(self, "attentions") else None


def _layers(value, n: int) -> List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class UNet(nn.Module):
    """UNetSpatioTemporalConditionModel from its published config dict."""

    def __init__(self, cfg: dict, num: Num = EXACT):
        super().__init__()
        chs = list(cfg["block_out_channels"])
        n = len(chs)
        heads = _layers(cfg["num_attention_heads"], n)
        tl = _layers(cfg["transformer_layers_per_block"], n)
        ctx = cfg["cross_attention_dim"]
        lpb = cfg["layers_per_block"]
        tdim = 4 * chs[0]
        self.chs, self.add_dim = chs, cfg["addition_time_embed_dim"]
        st = lambda i, o: SpatioTemporalResBlock(i, o, tdim, 1e-5, 1e-5, False, num)
        tr = lambda c, i: TransformerSpatioTemporalModel(c, heads[i], ctx, tl[i], num)
        self.conv_in = Conv2d(cfg["in_channels"], chs[0], 3, padding=1, num=num)
        self.time_embedding = TimestepEmbedding(chs[0], tdim, tdim, num)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"],
                                               tdim, tdim, num)
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            cross = kind.startswith("CrossAttn")
            resnets = [st(cin if j == 0 else chs[i], chs[i]) for j in range(lpb)]
            self.down_blocks.append(_Block(
                resnets, [tr(chs[i], i) for _ in range(lpb)] if cross else None,
                downsamplers=[Downsample2D(chs[i], False, num)] if i < n - 1 else None))
            cin = chs[i]
        self.mid_block = _Block([st(chs[-1], chs[-1]) for _ in range(2)], [tr(chs[-1], n - 1)])
        rev = chs[::-1]
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, kind in enumerate(cfg["up_block_types"]):
            cross = kind.startswith("CrossAttn")
            skip = [rev[i]] * lpb + [rev[min(i + 1, n - 1)]]
            resnets = [st((prev if j == 0 else rev[i]) + sc, rev[i]) for j, sc in enumerate(skip)]
            self.up_blocks.append(_Block(
                resnets, [tr(rev[i], n - 1 - i) for _ in skip] if cross else None,
                upsamplers=[Upsample2D(rev[i], num)] if i < n - 1 else None))
            prev = rev[i]
        self.conv_norm_out = nn.GroupNorm(32, chs[0], 1e-5)
        self.conv_out = Conv2d(chs[0], cfg["out_channels"], 3, padding=1, num=num)

    def forward(self, sample, timestep, ehs, added_time_ids, remat: bool = False):
        """sample (B, F, H, W, C_in), timestep (B,), ehs (B, N, D), added_time_ids
        (B, 3) -> (B, F, H, W, C_out). `remat`: recompute each block in the
        backward (torch.utils.checkpoint), which changes no value."""
        b, f, hh, ww, cin = sample.shape
        emb = self.time_embedding(timestep_embedding(timestep.reshape(-1).expand(b),
                                                     self.chs[0]))
        emb = emb + self.add_embedding(
            timestep_embedding(added_time_ids.reshape(-1), self.add_dim).reshape(b, -1))
        emb = emb.repeat_interleave(f, dim=0)
        ehs = ehs.repeat_interleave(f, dim=0)
        run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if (
            remat and torch.is_grad_enabled()) else (lambda fn, *a: fn(*a))
        x = self.conv_in(sample.reshape(b * f, hh, ww, cin).permute(0, 3, 1, 2))
        skips = [x]
        for block in self.down_blocks:
            x, res = run(self._down, block, x, emb, ehs, f)
            skips.extend(res)
        x = run(self._mid, x, emb, ehs, f)
        for block in self.up_blocks:
            k = len(block.resnets)
            x = run(self._up, block, x, emb, ehs, f, *skips[-k:])
            skips = skips[:-k]
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).reshape(b, f, hh, ww, -1)

    @staticmethod
    def _down(block, x, emb, ehs, f):
        res = []
        for i, resnet in enumerate(block.resnets):
            x = resnet(x, emb, f)
            if block.attention(i) is not None:
                x = block.attention(i)(x, ehs, f)
            res.append(x)
        if hasattr(block, "downsamplers"):
            x = block.downsamplers[0](x)
            res.append(x)
        return x, res

    def _mid(self, x, emb, ehs, f):
        x = self.mid_block.resnets[0](x, emb, f)
        x = self.mid_block.attentions[0](x, ehs, f)
        return self.mid_block.resnets[1](x, emb, f)

    @staticmethod
    def _up(block, x, emb, ehs, f, *skips):
        skips = list(skips)
        for i, resnet in enumerate(block.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), emb, f)
            if block.attention(i) is not None:
                x = block.attention(i)(x, ehs, f)
        if hasattr(block, "upsamplers"):
            x = block.upsamplers[0](x)
        return x


class VAEAttention(nn.Module):
    """The VAE mid block's attention: GroupNorm, one head per 512 channels,
    biased projections, residual."""

    def __init__(self, c: int, num: Num):
        super().__init__()
        self.heads, self.num = max(1, c // 512), num
        self.group_norm = nn.GroupNorm(32, c, 1e-6)
        self.to_q, self.to_k, self.to_v = (Linear(c, c, num=num) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(c, c, num=num)])

    def forward(self, x):
        n, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        o = self.to_out[0](attend(self.to_q(t), self.to_k(t), self.to_v(t), self.heads,
                                  self.num))
        return o.reshape(n, h, w, c).permute(0, 3, 1, 2) + x


class Encoder(nn.Module):
    def __init__(self, cfg: dict, num: Num):
        super().__init__()
        chs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], chs[0], 3, padding=1, num=num)
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            resnets = [ResnetBlock2D(cin if j == 0 else ch, ch, None, 1e-6, num)
                       for j in range(lpb)]
            cin = ch
            self.down_blocks.append(_Block(resnets, downsamplers=[
                Downsample2D(ch, True, num)] if i < len(chs) - 1 else None))
        self.mid_block = _Block([ResnetBlock2D(chs[-1], chs[-1], None, 1e-6, num)
                                 for _ in range(2)], [VAEAttention(chs[-1], num)])
        self.conv_norm_out = nn.GroupNorm(32, chs[-1], 1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * cfg["latent_channels"], 3, padding=1, num=num)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: dict, num: Num):
        super().__init__()
        chs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
        st = lambda i, o: SpatioTemporalResBlock(i, o, None, 1e-6, 1e-5, True, num)
        top = chs[-1]
        self.conv_in = Conv2d(cfg["latent_channels"], top, 3, padding=1, num=num)
        self.mid_block = _Block([st(top, top) for _ in range(2)], [VAEAttention(top, num)])
        self.up_blocks = nn.ModuleList()
        cin = top
        rev = chs[::-1]
        for i, ch in enumerate(rev):
            resnets = [st(cin if j == 0 else ch, ch) for j in range(lpb + 1)]
            cin = ch
            self.up_blocks.append(_Block(resnets, upsamplers=[
                Upsample2D(ch, num)] if i < len(rev) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(32, chs[0], 1e-6)
        self.conv_out = Conv2d(chs[0], cfg["out_channels"], 3, padding=1, num=num)
        self.time_conv_out = Conv3d(cfg["out_channels"], cfg["out_channels"], num)

    def forward(self, z):
        """(B, F, h, w, latent), already divided by the scaling factor ->
        (B, F, H, W, 3)."""
        b, f, h, w, c = z.shape
        x = self.conv_in(z.reshape(b * f, h, w, c).permute(0, 3, 1, 2))
        x = self.mid_block.resnets[0](x, None, f)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, None, f)
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x, None, f)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        bf, co, hh, ww = x.shape
        x = self.time_conv_out(x.reshape(b, f, co, hh, ww).permute(0, 2, 1, 3, 4))
        return x.permute(0, 2, 3, 4, 1)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: dict, num: Num = EXACT):
        super().__init__()
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = Encoder(cfg, num)
        lat2 = 2 * cfg["latent_channels"]
        self.quant_conv = Conv2d(lat2, lat2, 1, num=num)
        self.decoder = TemporalDecoder(cfg, num)

    def encode(self, images):
        """(N, H, W, 3) -> (mean, logvar), each (N, H/8, W/8, latent)."""
        m = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)


class _EncoderLayer(nn.Module):
    def __init__(self, w: int, heads: int, inner: int, eps: float, num: Num):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(w, eps=eps)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Linear(w, w, num=num))
        self.layer_norm2 = nn.LayerNorm(w, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Linear(w, inner, num=num), Linear(inner, w, num=num)
        self.heads, self.num = heads, num

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(attend(a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads, self.num))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPVisionModelWithProjection(nn.Module):
    """transformers' CLIP vision tower with projection, from the published
    image_encoder config dict (exact-erf GELU)."""

    def __init__(self, cfg: dict, num: Num = EXACT):
        super().__init__()
        w, p = cfg["hidden_size"], cfg["patch_size"]
        eps = cfg["layer_norm_eps"]
        self.image_size = cfg["image_size"]
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(w))
        vm.embeddings.patch_embedding = Conv2d(cfg["num_channels"], w, p, stride=p, bias=False,
                                               num=num)
        vm.embeddings.position_embedding = nn.Embedding((self.image_size // p) ** 2 + 1, w)
        vm.pre_layrnorm = nn.LayerNorm(w, eps=eps)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList(
            [_EncoderLayer(w, cfg["num_attention_heads"], cfg["intermediate_size"], eps, num)
             for _ in range(cfg["num_hidden_layers"])])
        vm.post_layernorm = nn.LayerNorm(w, eps=eps)
        self.visual_projection = Linear(w, cfg["projection_dim"], bias=False, num=num)

    def forward(self, pixels):
        """(N, S, S, 3) normalised pixels -> (N, projection_dim)."""
        vm, emb = self.vision_model, self.vision_model.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[None])
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def networks(cfg: dict, num: Num = EXACT) -> dict:
    """{"unet", "vae", "clip"} built from a configuration file's published
    groups (``unet``, ``vae``, ``image_encoder``)."""
    return {"unet": UNet(cfg["unet"], num),
            "vae": AutoencoderKLTemporalDecoder(cfg["vae"], num),
            "clip": CLIPVisionModelWithProjection(cfg["image_encoder"], num)}


# -- CLIP preprocessing: the pipeline's _resize_with_antialiasing --

def _cubic(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    x = x.abs()
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return torch.where(x <= 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


@functools.lru_cache(maxsize=16)
def _resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64, made once per size: gaussian blur (sigma max((n_in/n_out - 1)/2,
    0.001), odd kernel max(4 sigma, 3), reflect padding), then bicubic
    interpolation with align_corners=True (a = -0.75, edge taps clamped)."""
    sigma = max((n_in / n_out - 1.0) / 2.0, 0.001)
    k = int(max(4.0 * sigma, 3))
    k += 1 - k % 2
    g = torch.exp(-(torch.arange(k, dtype=torch.float64) - k // 2) ** 2 / (2 * sigma * sigma))
    g = g / g.sum()
    blur = torch.zeros(n_in, n_in, dtype=torch.float64)
    period = max(2 * n_in - 2, 1)
    for i in range(n_in):
        for tap in range(k):
            j = (i + tap - (k - 1) // 2) % period
            j = period - j if j >= n_in else j
            blur[i, j] += g[tap]
    if n_out == n_in:
        return blur
    src = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / (n_out - 1)
    i0 = src.floor()
    interp = torch.zeros(n_out, n_in, dtype=torch.float64)
    for tap in range(-1, 3):
        idx = (i0 + tap).clamp(0, n_in - 1).long()
        interp.index_put_((torch.arange(n_out), idx), _cubic(src - i0 - tap), accumulate=True)
    return interp @ blur


def clip_pixels(images: torch.Tensor, cfg: dict, mean: Sequence[float],
                std: Sequence[float]) -> torch.Tensor:
    """[-1, 1] (N, H, W, 3) -> CLIP's normalised (N, S, S, 3): antialiased
    resize to image_size, then [0, 1], then the image processor's mean/std."""
    s = cfg["image_size"]
    op_h = _resize_matrix(images.shape[1], s).float().to(images.device)
    op_w = _resize_matrix(images.shape[2], s).float().to(images.device)
    x = torch.einsum("oh,nhwc->nowc", op_h, images.float())
    x = torch.einsum("pw,nhwc->nhpc", op_w, x)
    x = (x + 1.0) / 2.0
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)
