"""The flash-attention forward in four softmax organisations (a probe).

Port of ``scripts/microbench_flash_variants.py::run`` and its kernel
``_kernel``: non-causal attention on the head-major (B·H, S, 64) layout,
output only, in the modes

- ``base``: the online-softmax statistics updated per KV sub-tile;
- ``major``: one max/rescale/exp pass per KV major tile;
- ``major_exp2``: ``major`` with log2(e) folded into the scale and exp2;
- ``nosoftmax``: p = s·scale, l = Σp, out = (Σ bf16(p)·v) / (l, or 1 where
  l == 0): the products and data movement without the softmax.

The CUDA kernel is ``csrc/flash_variants.cu``: the packed forward's TMA +
wgmma mainloop (``csrc/flash_fwd.cuh``) with one softmax policy per mode.
The card's sub-tile is one wgmma's N, 64 keys, and its major tile one ring
stage, 128 keys: ``base`` takes its statistics per sub-tile, the other modes
per major tile (the source says why). Like the TPU probe it takes only
sequences that are multiples of 128.

On a CPU tensor ``flash_variants`` runs ``flash_variants_reference``; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ._build import check, library

HEAD_DIM = 64
BLOCK = 128          # the TPU probe's _choose_block refuses other sequences
LOG2E = 1.4426950408889634
MODES = ("base", "major", "major_exp2", "nosoftmax")


def flash_variants_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, mode: str) -> torch.Tensor:
    """Plain version: f32 scores; the exp (exp2 in ``major_exp2``) of the
    scaled scores less their row maximum, or the scaled scores themselves in
    ``nosoftmax``; weights rounded to v's dtype before the second product,
    their f32 row sum the divisor (1 where it is 0)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    s = torch.einsum("bsd,btd->bst", q.float(), k.float())
    if mode == "nosoftmax":
        p = s * scale
    elif mode == "major_exp2":
        x = s * (scale * LOG2E)
        p = torch.exp2(x - x.amax(-1, keepdim=True))
    else:
        x = s * scale
        p = torch.exp(x - x.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bst,btd->bsd", p.to(v.dtype).float(), v.float())
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def _validate(q, k, v, mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    ok = (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 3 and k.dim() == 3
          and q.shape[0] == k.shape[0] and q.shape[2] == k.shape[2] == HEAD_DIM
          and v.shape == k.shape and k.dtype == v.dtype == q.dtype
          and q.shape[1] % BLOCK == 0 and k.shape[1] % BLOCK == 0)
    if not ok:
        raise ValueError(
            f"flash_variants kernel needs CUDA bf16 (B*H, S, {HEAD_DIM}) q, k, v with "
            f"S a multiple of {BLOCK}; got q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device != q.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"flash_variants: {name} must be contiguous, 16-byte "
                             "aligned and on q's device")


def flash_variants(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                   mode: str) -> torch.Tensor:
    """(B·H, S, 64) x (B·H, T, 64) -> (B·H, S, 64) in the given mode."""
    if q.device.type == "cpu":
        return flash_variants_reference(q, k, v, scale, mode)
    _validate(q, k, v, mode)
    o = torch.empty_like(q)
    bh, s, _ = q.shape
    err = library().svdx_flash_variant_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, k.shape[1],
        float(scale), MODES.index(mode), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, f"flash_variants[{mode}]")
    flash_variants.launches += 1
    return o


flash_variants.launches = 0
