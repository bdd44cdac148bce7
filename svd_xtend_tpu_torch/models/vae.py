"""AutoencoderKLTemporalDecoder — per-frame 2D encoder, temporal decoder.

Port of ``svd_xtend_tpu/models/vae.py``: the KL Encoder (4 stages with
asymmetric-padding downsamplers, mid resnet-attention-resnet), the
posterior (its mode for generation, a sample for training, with the
frame-chunked encode of diffusion/training.py:55-81), and the
TemporalDecoder whose resnets are spatio-temporal with a final
``time_conv_out`` frame conv. Channels-last throughout; the encoder takes
(N, H, W, 3), the decoder (B, F, h, w, latent).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.config import VAEConfig
from ..ops.attention import dot_product_attention
from .blocks import (Conv2d, Conv3x3, Downsample2D, GroupNormSiLU, ResnetBlock2D,
                     SpatioTemporalResBlock, TemporalConv, Upsample2D)


class VAEAttention(nn.Module):
    """Mid-block self-attention: GN, one head per 512 channels, residual."""

    def __init__(self, channels: int, eps: float = 1e-6, head_dim: int = 512):
        super().__init__()
        self.num_heads = max(1, channels // head_dim)
        self.group_norm = GroupNormSiLU(channels, 32, eps, silu=False)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        tokens = self.group_norm(x).reshape(n, h * w, c)
        split = lambda y: y.reshape(n, h * w, self.num_heads, c // self.num_heads)
        o = dot_product_attention(split(self.to_q(tokens)), split(self.to_k(tokens)),
                                  split(self.to_v(tokens)), impl="plain")
        return self.to_out[0](o.reshape(n, h * w, c)).reshape(n, h, w, c) + x


class _Stage(nn.Module):
    def __init__(self, resnets, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


class _Mid(nn.Module):
    def __init__(self, resnets, attention):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([attention])


class Encoder(nn.Module):
    """(N, H, W, 3) -> (N, H/8, W/8, 2·latent) moments."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, eps = cfg.block_out_channels, cfg.norm_eps
        self.conv_in = Conv3x3(cfg.in_channels, chs[0])
        self.down_blocks = nn.ModuleList()
        cin = chs[0]
        for i, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(cin, ch, None, eps))
                cin = ch
            last = i == len(chs) - 1
            self.down_blocks.append(_Stage(
                resnets, None if last else [Downsample2D(ch, ch, asymmetric_padding=True)]))
        self.mid_block = _Mid([ResnetBlock2D(chs[-1], chs[-1], None, eps)
                               for _ in range(2)], VAEAttention(chs[-1], eps))
        self.conv_norm_out = GroupNormSiLU(chs[-1], 32, eps)
        self.conv_out = Conv3x3(chs[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for resnet in stage.resnets:
                x = resnet(x)
            if hasattr(stage, "downsamplers"):
                x = stage.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(self.conv_norm_out(x))


class TemporalDecoder(nn.Module):
    """(B, F, h, w, latent) -> (B, F, 8h, 8w, 3)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, eps = cfg.block_out_channels, cfg.norm_eps
        st = lambda cin, cout: SpatioTemporalResBlock(cin, cout, None, eps,
                                                      temporal_eps=1e-5, merge_factor=0.0)
        top = chs[-1]
        self.conv_in = Conv3x3(cfg.latent_channels, top)
        self.mid_block = _Mid([st(top, top) for _ in range(2)], VAEAttention(top, eps))
        rev = list(reversed(chs))
        self.up_blocks = nn.ModuleList()
        cin = top
        for i, ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(st(cin, ch))
                cin = ch
            self.up_blocks.append(_Stage(
                resnets, upsamplers=[Upsample2D(ch)] if i < len(rev) - 1 else None))
        self.conv_norm_out = GroupNormSiLU(chs[0], 32, eps)
        self.conv_out = Conv3x3(chs[0], cfg.out_channels)
        self.time_conv_out = TemporalConv(cfg.out_channels, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, f, h, w, _ = z.shape
        x = self.conv_in(z.reshape(b * f, h, w, z.shape[-1]))
        x = self.mid_block.resnets[0](x, None, f)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, None, f)
        for stage in self.up_blocks:
            for resnet in stage.resnets:
                x = resnet(x, None, f)
            if hasattr(stage, "upsamplers"):
                x = stage.upsamplers[0](x)
        x = self.conv_out(self.conv_norm_out(x))
        hh, ww, c = x.shape[1:]
        x = self.time_conv_out(x.reshape(b, f, hh * ww, c))
        return x.reshape(b, f, hh, ww, c)


@dataclasses.dataclass
class DiagonalGaussian:
    """Latent posterior N(mean, exp(logvar)); generation uses its mode,
    training a sample."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std·noise for unit-normal `noise` shaped like the mean."""
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean.dtype)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode(self, images: torch.Tensor) -> DiagonalGaussian:
        """(N, H, W, 3) -> posterior over (N, H/8, W/8, latent), f32."""
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(images)).float())

    def encode_sample_chunked(self, images: torch.Tensor, chunk_size: int,
                              noise: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> posterior samples (N, H/8, W/8, latent) f32,
        encoding `chunk_size` images at a time (0: all at once), the last
        chunk ragged. The encoder never mixes images, so chunking is exact;
        `noise` (N, h, w, latent) holds each chunk's draws in image order."""
        n = images.shape[0]
        cap = min(chunk_size or n, n)
        return torch.cat([self.encode(images[i:i + cap]).sample(noise[i:i + cap])
                          for i in range(0, n, cap)])

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, F, h, w, latent), already divided by the scaling factor."""
        return self.decoder(z)
