"""Fused temporal resnet + collapsed blend on (B, F, S, C).

Port of ``svd_xtend_tpu/ops/pallas/temporal_resnet.py``:
``temporal_resnet_block`` (its kernels ``_kernel_a`` and ``_kernel_b``, with
the plain versions ``conv_a_reference`` and ``conv_b_reference``), the plain
``temporal_resnet_reference`` and ``_fold_from_channel_sums``.

    out = x + w·conv2(gn2silu(conv1(gn1silu(x)) + b1 + temb))

The CUDA kernels are ``csrc/temporal_resnet.cu``: each (3, 1) frame conv is
one implicit GEMM with K = 3·C on the tensor cores, the GroupNorm normalise
+ SiLU applied to its input as it is loaded. Kernel A adds b1 and the
per-frame temb and writes norm2's per-tile channel sums of its stored bf16
output; kernel B adds the residual, with w = 1 - α folded into conv2's
weights and bias. The GN folds around them are plain torch, as they are XLA
code in the JAX package.

On a CPU tensor ``temporal_resnet_block`` runs the reference; on a CUDA
tensor it launches the kernels or raises. The backward recomputes the
reference and differentiates it, the blend weight ``w`` included
(temporal_resnet.py:318 in the JAX package). Weights are taps (3, C, C):
``out[f] = x[f-1] @ k[0] + x[f] @ k[1] + x[f+1] @ k[2] + b``.
"""

from __future__ import annotations

import torch

from ._autograd import differentiable
from ._build import check, library
from .groupnorm import (fold_from_channel_sums, group_norm_fold,
                        group_norm_silu_reference)

CHANNEL_MULTIPLE = 64


def temporal_conv_reference(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The TemporalConv math: three frame-shifted channel matmuls."""
    zero = torch.zeros_like(x[:, :1])
    prev = torch.cat([zero, x[:, :-1]], dim=1)
    nxt = torch.cat([x[:, 1:], zero], dim=1)
    return prev @ k[0] + x @ k[1] + nxt @ k[2] + b


def temporal_resnet_reference(x, t, k1, b1, k2, b2, scale1, bias1, scale2,
                              bias2, w, groups: int, eps: float) -> torch.Tensor:
    """Plain oracle: x + w·conv2(gn2silu(conv1(gn1silu(x)) + b1 + t)).
    x: (B, F, S, C); t: (B, F, C); k1/k2: (3, C, C); w: scalar tensor."""
    h = group_norm_silu_reference(x, scale1, bias1, groups, eps)
    h = temporal_conv_reference(h, k1, b1) + t[:, :, None, :].to(x.dtype)
    h2 = group_norm_silu_reference(h, scale2, bias2, groups, eps)
    h2 = temporal_conv_reference(h2, k2, b2)
    return (x.float() + w.float() * h2.float()).to(x.dtype)


def supports(x: torch.Tensor) -> bool:
    """Structural dispatch predicate: a CUDA bf16 (B, F, S, C) the kernels
    take (C a multiple of the 64-column output tile)."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
            and x.shape[-1] % CHANNEL_MULTIPLE == 0)


def pack_taps(k: torch.Tensor) -> torch.Tensor:
    """Taps (3, C, Co) -> the kernel's (Co, 3C) bf16 with k = tap·C + ci."""
    return k.permute(2, 0, 1).reshape(k.shape[2], -1).to(torch.bfloat16).contiguous()


def _activate(x, sc, sh):
    """silu(x·sc + sh) per (sample, channel), rounded to x's dtype."""
    a = x.float() * sc[:, None, None, :] + sh[:, None, None, :]
    return (a * torch.sigmoid(a)).to(x.dtype)


def conv_a_reference(x, k, bias, sc, sh, t):
    """Plain kernel A on taps k (3, C, C): (h, per-sample channel sum, sum of
    squares of the stored h), the sums (B, C) over all F·S positions."""
    acc = (temporal_conv_reference(_activate(x, sc, sh).float(), k.float(), bias.float())
           + t.float()[:, :, None, :])
    h = acc.to(x.dtype)
    hf = h.float().flatten(1, 2)
    return h, hf.sum(1), (hf * hf).sum(1)


def conv_b_reference(h, k, bias, sc, sh, res):
    """Plain kernel B on taps k (3, C, C): res + conv(silu(h·sc + sh)) + bias."""
    acc = temporal_conv_reference(_activate(h, sc, sh).float(), k.float(), bias.float())
    return (res.float() + acc).to(h.dtype)


def _launch(x, wt, bias, sc, sh, extra, out, psum, psq, first: bool) -> None:
    b, f, s, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().svdx_temporal_resnet_conv(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), sc.data_ptr(),
        sh.data_ptr(), extra.data_ptr(), out.data_ptr(),
        None if psum is None else psum.data_ptr(),
        None if psq is None else psq.data_ptr(),
        b, f, s, c, int(first), stream)
    check(err, "temporal_resnet_conv_a" if first else "temporal_resnet_conv_b")


def conv_a(x, wt, bias, sc, sh, t):
    """Kernel A: h = conv(silu(x·sc + sh)) + bias + t[b, f], plus per-tile
    channel (sum, sum of squares) of the stored h: (B, nTiles, C) each."""
    b, f, s, c = x.shape
    tiles = -(-f * s // library().svdx_temporal_resnet_tile_rows())
    h = torch.empty_like(x)
    psum = torch.empty((b, tiles, c), device=x.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    _launch(x, wt, bias, sc, sh, t, h, psum, psq, True)
    conv_a.launches += 1
    return h, psum, psq


def conv_b(h, wt, bias, sc, sh, res):
    """Kernel B: res + conv(silu(h·sc + sh)) + bias."""
    out = torch.empty_like(h)
    _launch(h, wt, bias, sc, sh, res, out, None, None, False)
    conv_b.launches += 1
    return out


conv_a.launches = 0
conv_b.launches = 0


def _validate(x, t, k1, k2):
    if not supports(x):
        raise ValueError(
            "temporal_resnet kernels need a CUDA bf16 (B, F, S, C) with "
            f"C % {CHANNEL_MULTIPLE} == 0; got {tuple(x.shape)} {x.dtype}")
    b, f, _, c = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("temporal_resnet: x must be contiguous, 16-byte aligned")
    if t.shape != (b, f, c):
        raise ValueError(f"temporal_resnet: temb must be {(b, f, c)}, got {tuple(t.shape)}")
    for name, k in (("k1", k1), ("k2", k2)):
        if k.shape != (3, c, c):
            raise ValueError(f"temporal_resnet: {name} must be {(3, c, c)}")


def temporal_resnet_block(x, t, k1, b1, k2, b2, scale1, bias1, scale2, bias2,
                          w, *, groups: int = 32, eps: float = 1e-5, kernel=None):
    """Fused temporal resnet + blend; semantics of temporal_resnet_reference.
    ``kernel`` replaces the CUDA launches (the CPU tests pass the reference
    to run the autograd wiring without a card)."""
    if kernel is None:
        if x.device.type == "cpu":
            return temporal_resnet_reference(x, t, k1, b1, k2, b2, scale1, bias1,
                                             scale2, bias2, w, groups, eps)
        kernel = _launch_block
    return differentiable(kernel, temporal_resnet_reference, x, t, k1, b1, k2, b2,
                          scale1, bias1, scale2, bias2, w, groups=groups, eps=eps)


def _launch_block(x, t, k1, b1, k2, b2, scale1, bias1, scale2, bias2, w, *,
                  groups: int, eps: float):
    _validate(x, t, k1, k2)
    _, f, s, _ = x.shape
    sc1, sh1 = group_norm_fold(x, scale1, bias1, groups=groups, eps=eps)
    h, psum, psq = conv_a(x, pack_taps(k1), b1.float().contiguous(), sc1, sh1,
                          t.to(x.dtype).contiguous())
    sc2, sh2 = fold_from_channel_sums(psum.sum(1), psq.sum(1), f * s, scale2,
                                      bias2, groups, eps)
    # fold the blend weight into conv2 (linear in weights and bias)
    wf = w.float()
    k2w = (k2.float() * wf).to(k2.dtype)
    b2w = (b2.float() * wf).to(b2.dtype).float().contiguous()
    return conv_b(h, pack_taps(k2w), b2w, sc2, sh2, x)
