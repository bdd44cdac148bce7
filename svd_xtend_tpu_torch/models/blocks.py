"""ResNet and sampling blocks of the spatio-temporal UNet and the VAE.

Port of ``svd_xtend_tpu/models/blocks.py`` as plain diffusers math on
channels-last activations: spatial blocks act on (N, H, W, C), temporal
blocks on (B, F, H*W, C). Convs other than the 3x3 SAME ones (the 1x1
shortcuts, the stride-2 downsamplers, the upsamplers' convs, as the JAX
package keeps them outside its Pallas kernel) go to ``F.conv2d`` through the
NCHW view of the NHWC tensor (``torch.channels_last``, no copy). The up-block
skip is concatenated; the upsample is nearest 2x then a 3x3 conv.

Kernel sites on CUDA:
  - ``Conv3x3``: the conv3x3 kernel (ops/kernels/conv3x3.py) wherever its
    ``supports`` takes the call: both convs of every ResnetBlock2D of the UNet
    and the VAE (in the GN-fold form: the GroupNorm statistics folded into a
    per-(sample, channel) affine that the kernel's prologue applies with the
    SiLU, the time embedding and the skip added in its epilogue),
    the UNet's ``conv_in`` and the VAE encoder's ``conv_out``. It declines,
    for channel counts that are not multiples of 8, the UNet's ``conv_out``
    (Co 4), the VAE encoder's ``conv_in`` (Ci 3), the decoder's ``conv_in``
    (Ci 4) and ``conv_out`` (Co 3); those take ``F.conv2d``;
  - every other GroupNorm(+SiLU) goes to the GroupNorm kernel
    (ops/kernels/groupnorm.py), the GN folds to the fold's kernels
    (``groupnorm.group_norm_fold``), and every TemporalResnetBlock with its
    collapsed AlphaBlender to the fused temporal-resnet kernels
    (ops/kernels/temporal_resnet.py).
State-dict keys are the diffusers names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import video
from ..ops.kernels import conv3x3 as cvk
from ..ops.kernels import groupnorm as gnk
from ..ops.kernels import temporal_resnet as trk
from ..ops.kernels.dispatch import kernels_enabled


class GroupNormSiLU(nn.Module):
    """GroupNorm(groups) + affine (+ SiLU) over (N, ..., C)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if kernels_enabled() and gnk.supports(x, self.groups):
            return gnk.group_norm_silu(x, self.weight, self.bias, groups=self.groups,
                                       eps=self.eps, silu=self.silu)
        return gnk.group_norm_silu_reference(x, self.weight, self.bias,
                                             self.groups, self.eps, self.silu)

    def fold(self, x: torch.Tensor):
        """The statistics half only: per-(sample, channel) f32 (sc, sh) with
        GN(x)·weight + bias == x·sc + sh, for a consumer that applies the
        normalise (+ SiLU) as it reads x (the JAX module's ``fold_only``).
        Over an up-block's concatenated input it equals JAX's
        ``group_norm_fold_cat``, groups straddling the two parts included.
        On the card the fold's kernels compute it (``group_norm_fold``, which
        raises on an x they do not take)."""
        fold = gnk.group_norm_fold if kernels_enabled() else gnk.group_norm_fold_reference
        return fold(x, self.weight, self.bias, groups=self.groups, eps=self.eps)


class AlphaBlender(nn.Module):
    """a·spatial + (1-a)·temporal with a = sigmoid(mix_factor); with
    `switch_spatial_to_temporal_mix` the sigmoid weights the temporal branch
    (the transformer time mixer)."""

    def __init__(self, merge_factor: float = 0.5,
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.full((1,), float(merge_factor)))

    def alpha_scalar(self) -> torch.Tensor:
        """The spatial-branch weight as an f32 scalar tensor."""
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        return 1.0 - alpha if self.switch else alpha

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha_scalar().to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC activations (weights OIHW, as in diffusers)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return video.nhwc(super().forward(video.nchw(x)))


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv on NHWC with the fused epilogues of the JAX
    package's ``Conv3x3`` (blocks.py:225-348; its int8, Winograd and tiled
    forms are not ported): ``pre=(sc, sh, silu)`` a per-(N, Ci) f32 input
    affine (+ SiLU), ``post_shift`` (N, Co) f32 and ``residual`` added to the
    output. The parameter is diffusers' OIHW weight, stored channels_last so
    that the kernel reads it as (Co, 3, 3, Ci) without a copy.

    On CUDA every call ``supports`` takes goes to the conv3x3 kernel; the
    rest (and every call on the CPU) takes the JAX package's route where its
    dispatch declines: the affine as plain ops, the conv (``F.conv2d``),
    then the shift and the residual (blocks.py:325-348)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.weight.data = self.weight.data.contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, pre=None, post_shift: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        sc, sh, silu = pre if pre is not None else (None, None, False)
        if kernels_enabled() and cvk.supports(x, self.weight):
            return cvk.conv3x3(x, self.weight, self.bias, pre_scale=sc, pre_shift=sh,
                               pre_silu=silu, post_shift=post_shift, residual=residual)
        if pre is not None:
            x = cvk.apply_pre_affine(x, sc, sh, silu)
        y = video.nhwc(super().forward(video.nchw(x)))
        if post_shift is not None:
            y = y + post_shift[:, None, None, :].to(y.dtype)
        if residual is not None:
            y = y + residual
        return y


class TemporalConv(nn.Conv3d):
    """(3, 1) conv over the frame axis of (B, F, S, C), zero padding, as
    three channel matmuls; parameters are diffusers' Conv3d (O, I, 3, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    def taps(self) -> torch.Tensor:
        """(3, I, O): out[f] = x[f-1] @ taps[0] + x[f] @ taps[1] + x[f+1] @ taps[2]."""
        return self.weight[:, :, :, 0, 0].permute(2, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return trk.temporal_conv_reference(x, self.taps(), self.bias)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv3x3, + t-emb, GN -> SiLU -> conv3x3, + skip, in the
    JAX package's GN-fold form (blocks.py:494-536, its default): each
    GroupNorm contributes only its folded (sc, sh), and the normalise + SiLU,
    the time-embedding add (f32) and the skip add ride the two Conv3x3
    calls."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, groups, eps)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNormSiLU(out_channels, groups, eps)
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        t = None
        if self.time_emb_proj is not None:
            t = self.time_emb_proj(F.silu(temb)).float()
        sc, sh = self.norm1.fold(x)
        h = self.conv1(x, pre=(sc, sh, True), post_shift=t)
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        sc2, sh2 = self.norm2.fold(h)
        return self.conv2(h, pre=(sc2, sh2, True), residual=skip)


class TemporalResnetBlock(nn.Module):
    """ResNet over the frame axis with its AlphaBlender collapsed in:
    out = x + w·h2, w = 1 - α (exact with the identity shortcut and no
    image-only indicator, which is every SVD site). (B, F, H, W, C) in and
    out."""

    def __init__(self, channels: int, temb_channels: Optional[int] = None,
                 eps: float = 1e-6, groups: int = 32):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = GroupNormSiLU(channels, groups, eps)
        self.conv1 = TemporalConv(channels, channels)
        self.time_emb_proj = (nn.Linear(temb_channels, channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNormSiLU(channels, groups, eps)
        self.conv2 = TemporalConv(channels, channels)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                blend_weight: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        xs = x.reshape(b, f, hh * ww, c)
        if self.time_emb_proj is not None:
            t = self.time_emb_proj(F.silu(temb))           # (B, F, C)
        else:                                              # the VAE decoder
            t = torch.zeros(b, f, c, device=x.device, dtype=x.dtype)
        args = (xs, t, self.conv1.taps(), self.conv1.bias, self.conv2.taps(),
                self.conv2.bias, self.norm1.weight, self.norm1.bias,
                self.norm2.weight, self.norm2.bias, blend_weight)
        if kernels_enabled() and trk.supports(xs):
            out = trk.temporal_resnet_block(*args, groups=self.groups, eps=self.eps)
        else:
            out = trk.temporal_resnet_reference(*args, self.groups, self.eps)
        return out.reshape(b, f, hh, ww, c)


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResNet on folded frames + temporal ResNet, alpha-blended.
    (B*F, H, W, C) in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5,
                 temporal_eps: Optional[float] = None, merge_factor: float = 0.5):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels,
                                               temb_channels, eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, temb_channels, temporal_eps or eps)
        self.time_mixer = AlphaBlender(merge_factor)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                num_frames: int) -> torch.Tensor:
        h = self.spatial_res_block(x, temb)
        bf, hh, ww, c = h.shape
        b = bf // num_frames
        temb_frames = temb.reshape(b, num_frames, -1) if temb is not None else None
        out = self.temporal_res_block(h.reshape(b, num_frames, hh, ww, c),
                                      temb_frames,
                                      1.0 - self.time_mixer.alpha_scalar())
        return out.reshape(bf, hh, ww, c)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv; the VAE encoder pads (0, 1), (0, 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = Conv2d(in_channels, out_channels, 3, stride=2,
                           padding=0 if asymmetric_padding else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_padding:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = video.nhwc(F.interpolate(video.nchw(x), scale_factor=2.0, mode="nearest"))
        return self.conv(x)
