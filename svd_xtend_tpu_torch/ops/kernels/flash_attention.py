"""Flash attention on the packed (B, S, H*64) layout, forward and backward.

Port of ``svd_xtend_tpu/ops/pallas/flash_attention.py::flash_attention_packed``:
its forward kernel ``_fwd_packed_kernel`` and its backward kernels
``_dq_kernel`` and ``_dkv_kernel``. The forward is ``csrc/flash_attention.cu``
on the mainloop of ``csrc/flash_fwd.cuh`` (one block per 128 query rows of a
head, TMA into a ring of 128-key shared-memory stages, wgmma, the softmax of
one 64-key sub-tile under the P·V product of the last); the backward pair is
``csrc/flash_backward.cu`` (one block per 128 query rows or 128 keys of a
head, the same TMA ring and wgmma). All read the heads in place with a row
stride of H*64, with f32 softmax statistics and every product on the tensor
cores. The forward writes the f32 log-sum-exp (B, H, S) when a gradient will
be needed; the backward reads it. The forward kernel folds the scale into
its exponent after taking the row maximum of the raw scores, so it takes
only ``scale > 0`` (every caller passes head_dim ** -0.5). See the sources
for the designs.

On a CPU tensor the wrapper runs ``flash_attention_packed_reference`` (the
plain einsum form of ``ops/attention.py::_xla_attention``), differentiated
by autograd; on a CUDA tensor it launches the kernels or raises. The plain
versions of the kernels themselves are ``flash_attention_fwd_reference``
(output and LSE) and ``flash_attention_bwd_reference`` (the explicit
backward formulas in f32).

``flash_attention`` is the port of the head-major entry point
(``flash_attention.py::flash_attention``, its kernel ``_fwd_kernel``) on
(B, S, H, 64) tensors: a contiguous (B, S, H, 64) tensor has the memory
layout of the packed (B, S, H*64) one, so the same forward kernel computes it
on the same memory, with no transposes, and its backward goes through the
same dQ and dK/dV kernels. It counts its forward launches apart.

``flash_attention_headsliced`` is the port of the TPU probe's
``scripts/microbench_flash_headslice.py::_fwd_headsliced``: the packed
forward with the grid over (batch, head, query tile), out and LSE. That is
the organisation of the forward kernel here (one block per 128-row tile,
head and batch, each head's 64 columns read in place), so it launches the
same kernel with the LSE on, and counts its launches apart. The LSE is
(B, H, S) f32; the TPU's (B, H·8, S) with 8 replicated sublanes is a TPU
layout and is not kept.
"""

from __future__ import annotations

import torch

from ._build import check, library

HEAD_DIM = 64


def flash_attention_packed_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, *, num_heads: int,
                                     scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale) v per head on (B, S, H*D); f32 scores, weights
    rounded to the input dtype before the second product."""
    b, s, hd = q.shape
    t = k.shape[1]
    d = hd // num_heads
    qh = q.reshape(b, s, num_heads, d)
    kh = k.reshape(b, t, num_heads, d)
    vh = v.reshape(b, t, num_heads, d)
    logits = torch.einsum("bshd,bthd->bhst", qh.float(), kh.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", w, vh).reshape(b, s, hd)


def _scores(q, k, num_heads, scale):
    b, s, hd = q.shape
    d = hd // num_heads
    return torch.einsum("bshd,bthd->bhst", q.float().reshape(b, s, num_heads, d),
                        k.float().reshape(b, k.shape[1], num_heads, d)) * scale


def flash_attention_fwd_reference(q, k, v, num_heads: int, scale: float):
    """Plain forward kernel: (output like q, f32 LSE (B, H, S) in nats)."""
    lse = torch.logsumexp(_scores(q, k, num_heads, scale), dim=-1)
    return flash_attention_packed_reference(q, k, v, num_heads=num_heads, scale=scale), lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, num_heads: int, scale: float):
    """Plain backward kernels in f32: P = exp(S·scale − LSE), dP = dO·Vᵀ,
    dS = P∘(dP − δ)·scale, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, with
    δ = rowsum(dO∘O). Returns (dq, dk, dv) in the inputs' dtype."""
    b, s, hd = q.shape
    t, d = k.shape[1], hd // num_heads
    heads = lambda x, n: x.float().reshape(b, n, num_heads, d)
    p = torch.exp(_scores(q, k, num_heads, scale) - lse[..., None])
    dof = heads(do, s)
    dp = torch.einsum("bshd,bthd->bhst", dof, heads(v, t))
    ds = p * (dp - attention_delta(o, do, num_heads)[..., None]) * scale
    dq = torch.einsum("bhst,bthd->bshd", ds, heads(k, t))
    dk = torch.einsum("bhst,bshd->bthd", ds, heads(q, s))
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    return tuple(x.reshape(b, -1, hd).to(q.dtype) for x in (dq, dk, dv))


def attention_delta(o: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """δ = rowsum(dO∘O) per head in f32, (B, H, S) (plain torch, as the JAX
    package computes it outside its kernels, flash_attention.py:455)."""
    b, s, hd = o.shape
    prod = (do.float() * o.float()).reshape(b, s, num_heads, hd // num_heads)
    return prod.sum(-1).transpose(1, 2).contiguous()


def supports(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> bool:
    """Structural dispatch predicate: a CUDA bf16 call the kernel takes."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 3
            and k.dim() == 3 and q.shape[0] == k.shape[0]
            and q.shape[2] == k.shape[2] == num_heads * HEAD_DIM)


def _validate(q, k, v, num_heads):
    if not supports(q, k, num_heads):
        raise ValueError(
            f"flash_attention_packed kernel needs CUDA bf16 (B, S, H*{HEAD_DIM}) "
            f"q and k with equal batch and width; got q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)}, heads {num_heads}")
    if v.shape != k.shape or v.dtype != q.dtype or k.dtype != q.dtype:
        raise ValueError("flash_attention_packed: v must match k, dtypes q's")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"flash_attention_packed: {name} must be contiguous, "
                             "16-byte aligned and on q's device")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention_fwd(q, k, v, num_heads: int, scale: float, with_lse: bool = True):
    """The forward kernel: (o, f32 LSE (B, H, S) or None)."""
    out = _fwd_launch(q, k, v, num_heads, scale, with_lse)
    flash_attention_packed.launches += 1
    return out


def _fwd_launch(q, k, v, num_heads: int, scale: float, with_lse: bool):
    _validate(q, k, v, num_heads)
    if not scale > 0:
        raise ValueError(f"flash attention forward kernel needs scale > 0; got {scale}")
    o = torch.empty_like(q)
    b, s, _ = q.shape
    lse = (torch.empty((b, num_heads, s), device=q.device, dtype=torch.float32)
           if with_lse else None)
    err = library().svdx_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, k.shape[1], num_heads,
        float(scale), _stream(q))
    check(err, "flash_attention_fwd")
    return o, lse


def _validate_bwd(q, k, v, do, lse, delta, num_heads):
    _validate(q, k, v, num_heads)
    b, s, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("flash attention backward: dO must be a contiguous tensor like q")
    for name, a in (("lse", lse), ("delta", delta)):
        if (a.shape != (b, num_heads, s) or a.dtype != torch.float32
                or not a.is_contiguous()):
            raise ValueError(f"flash attention backward: {name} must be f32 "
                             f"{(b, num_heads, s)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, num_heads: int, scale: float):
    """The dQ kernel: one block per (128-query tile, head, batch)."""
    _validate_bwd(q, k, v, do, lse, delta, num_heads)
    dq = torch.empty_like(q)
    b, s, _ = q.shape
    err = library().svdx_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, s, k.shape[1], num_heads, float(scale),
        _stream(q))
    check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, num_heads: int, scale: float):
    """The dK/dV kernel: one block per (128-key tile, head, batch)."""
    _validate_bwd(q, k, v, do, lse, delta, num_heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, s, _ = q.shape
    err = library().svdx_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, k.shape[1], num_heads,
        float(scale), _stream(q))
    check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, num_heads: int, scale: float):
    """The backward kernels: (dq, dk, dv); δ in plain torch."""
    delta = attention_delta(o, do, num_heads)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, num_heads, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, num_heads, scale)
    return dq, dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel saving (q, k, v, o, LSE); backward kernels. `forward`
    and `backward` are the kernel callables (or their plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale, forward, backward):
        o, lse = forward(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale, ctx.backward_fn = num_heads, scale, backward
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.backward_fn(q, k, v, o, lse, do.contiguous(), ctx.num_heads,
                                     ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, num_heads: int, scale: float, kernels=None) -> torch.Tensor:
    """(B, S, H*64) x (B, T, H*64) -> (B, S, H*64), softmax over T.

    ``kernels`` = (forward, backward) replaces the CUDA kernels: the CPU tests
    pass (flash_attention_fwd_reference, flash_attention_bwd_reference) to
    run the autograd wiring without a card."""
    if kernels is None:
        if q.device.type == "cpu":
            return flash_attention_packed_reference(q, k, v, num_heads=num_heads,
                                                    scale=scale)
        kernels = (flash_attention_fwd, flash_attention_bwd)
    fwd, bwd = kernels
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, num_heads, float(scale), fwd, bwd)
    if fwd in (flash_attention_fwd, _bshd_fwd):
        return fwd(q, k, v, num_heads, scale, with_lse=False)[0]
    return fwd(q, k, v, num_heads, scale)[0]


flash_attention_packed.launches = 0  # forward-kernel launches


def _bshd_fwd(q, k, v, num_heads: int, scale: float, with_lse: bool = True):
    """The forward kernel on the packed view of (B, S, H, 64) tensors."""
    out = _fwd_launch(q, k, v, num_heads, scale, with_lse)
    flash_attention.launches += 1
    return out


def supports_bshd(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Structural dispatch predicate of ``flash_attention``: CUDA bf16
    (B, S, H, 64) q and (B, T, H, 64) k."""
    return (q.dim() == 4 and k.dim() == 4 and q.shape[2] == k.shape[2]
            and q.shape[3] == k.shape[3] == HEAD_DIM
            and supports(q.flatten(2), k.flatten(2), q.shape[2]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, kernels=None) -> torch.Tensor:
    """softmax(q kᵀ·scale) v on (B, S, H, 64) x (B, T, H, 64) -> (B, S, H, 64).
    ``kernels`` as for ``flash_attention_packed``."""
    b, s, h, d = q.shape
    if kernels is None:
        if q.device.type == "cuda" and not supports_bshd(q, k):
            raise ValueError(f"flash_attention kernel needs CUDA bf16 (B, S, H, "
                             f"{HEAD_DIM}) q, k, v; got q {tuple(q.shape)} {q.dtype}, "
                             f"k {tuple(k.shape)}")
        kernels = (_bshd_fwd, flash_attention_bwd) if q.device.type == "cuda" else None
    packed = [a.reshape(a.shape[0], a.shape[1], h * d) for a in (q, k, v)]
    return flash_attention_packed(*packed, num_heads=h, scale=scale,
                                  kernels=kernels).reshape(b, s, h, d)


flash_attention.launches = 0  # forward-kernel launches


def flash_attention_headsliced(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               scale: float, num_heads: int):
    """(B, S, H*64) x (B, T, H*64) -> (out (B, S, H*64), f32 LSE (B, H, S)):
    the forward kernel with its log-sum-exp, no autograd."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, num_heads, scale)
    out = _fwd_launch(q, k, v, num_heads, scale, with_lse=True)
    flash_attention_headsliced.launches += 1
    return out


flash_attention_headsliced.launches = 0
