"""The flash forward's dependent QKᵀ→PV chain, in bf16 and in int8 (a probe).

Port of ``scripts/probe_int8_flash.py``: its kernels ``_chain_bf16`` and
``_chain_int8_qd`` (launched by its ``run``), which ask whether int8
products would speed up the flash kernel. One (bq, 64) q, kᵀ (64, bkm) and
v (bkm, 64) go through ``n_inner`` dependent steps (there a module global,
``N_INNER``, here an argument):

- ``chain_bf16``: p = bf16(q·kᵀ·(1/bkm)); q = bf16(p·v·0.25), f32 sums;
- ``chain_int8_qd``: kᵀ and v already int8; each step quantises q and then
  p dynamically, ``quant(x) = (round(x/s) as int8, s)`` with
  s = max|x|/127 + 1e-12 over the whole tensor, int32 sums, f32 dequantise.

Both return the last q as f32 (bq, 64). The values do not survive many
steps (bf16 shrinks towards 0, int8 grows by its K/V scale and overflows),
as in the TPU probe: compare them at a few steps.

The CUDA kernels are ``csrc/flash_chain.cu`` (the int8 one a cooperative
launch with a grid barrier per maximum; the source says why). The int8
kernel equals its plain version bit for bit. On CPU tensors the entry
points run the plain versions; on CUDA tensors they launch the kernels or
raise.
"""

from __future__ import annotations

import torch

from ._build import check, library

HEAD_DIM = 64
ROWS = 64            # rows of q per block, and keys per staged chunk
INV_127 = 1.0 / 127.0  # rounds to the same f32 as 1.0f / 127.0f


def _quant(x: torch.Tensor):
    """(round(x / s) as exact integers in x's dtype, s) with s = max|x|·(1/127)
    + 1e-12 in f32 and rounding half to even (jnp.round). The JAX body writes
    max|x| / 127; XLA compiles a division by a constant as the product with
    its f32 reciprocal, and so does this (torch would divide on the CPU and
    multiply on CUDA)."""
    s = x.abs().max() * INV_127 + 1e-12
    return torch.round(x / s), s


def chain_bf16_reference(q: torch.Tensor, kT: torch.Tensor, v: torch.Tensor,
                         n_inner: int = 60) -> torch.Tensor:
    """Plain ``_chain_bf16``: products of bf16 values summed in f32."""
    kf, vf = kT.float(), v.float()
    inv = 1.0 / kT.shape[1]
    x = q.to(torch.bfloat16)
    for _ in range(n_inner):
        p = ((x.float() @ kf) * inv).to(torch.bfloat16)
        x = ((p.float() @ vf) * 0.25).to(torch.bfloat16)
    return x.float()


def chain_int8_qd_reference(q: torch.Tensor, kTi: torch.Tensor, vi: torch.Tensor,
                            n_inner: int = 60) -> torch.Tensor:
    """Plain ``_chain_int8_qd``. The integer products are taken in float64,
    where they are exact (|Σ| ≤ bkm·127² < 2^53), and converted to f32 as
    int32 → f32 rounds them; every other step is f32 in the JAX body's order.
    (torch's int8 @ int8 on the CPU returns int8 and wraps around.)"""
    kd, vd = kTi.double(), vi.double()
    inv = 1.0 / kTi.shape[1]
    x = q.float()
    for _ in range(n_inner):
        qi, sq = _quant(x)
        p = (qi.double() @ kd).float() * sq
        p = p * inv
        pi, sp = _quant(p)
        o = (pi.double() @ vd).float() * sp
        x = o * 0.25
    return x


def _validate(q, kT, v, dtype):
    ok = (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 2 and kT.dim() == 2
          and v.dim() == 2 and q.shape[1] == kT.shape[0] == v.shape[1] == HEAD_DIM
          and kT.shape[1] == v.shape[0] and kT.dtype == v.dtype == dtype
          and q.shape[0] % ROWS == 0 and kT.shape[1] % ROWS == 0)
    if not ok:
        raise ValueError(
            f"flash chain kernel needs CUDA bf16 q (bq, {HEAD_DIM}), {dtype} kT "
            f"({HEAD_DIM}, bkm) and v (bkm, {HEAD_DIM}), bq and bkm multiples of {ROWS}; "
            f"got q {tuple(q.shape)} {q.dtype}, kT {tuple(kT.shape)} {kT.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}")
    for name, a in (("q", q), ("kT", kT), ("v", v)):
        if a.device != q.device or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"flash chain: {name} must be contiguous, 16-byte aligned "
                             "and on q's device")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def chain_bf16(q: torch.Tensor, kT: torch.Tensor, v: torch.Tensor,
               n_inner: int = 60) -> torch.Tensor:
    """(bq, 64) bf16, (64, bkm) bf16, (bkm, 64) bf16 -> (bq, 64) f32."""
    if q.device.type == "cpu":
        return chain_bf16_reference(q, kT, v, n_inner)
    _validate(q, kT, v, torch.bfloat16)
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    err = library().svdx_chain_bf16(q.data_ptr(), kT.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), q.shape[0], kT.shape[1], int(n_inner),
                                    1.0 / kT.shape[1], _stream(q))
    check(err, "chain_bf16")
    chain_bf16.launches += 1
    return out


def chain_int8_qd(q: torch.Tensor, kTi: torch.Tensor, vi: torch.Tensor,
                  n_inner: int = 60) -> torch.Tensor:
    """(bq, 64) bf16, (64, bkm) int8, (bkm, 64) int8 -> (bq, 64) f32."""
    if q.device.type == "cpu":
        return chain_int8_qd_reference(q, kTi, vi, n_inner)
    _validate(q, kTi, vi, torch.int8)
    bq, bkm = q.shape[0], kTi.shape[1]
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    p_scratch = torch.empty((bq, bkm), device=q.device, dtype=torch.float32)
    partial = torch.empty((2, bq // ROWS), device=q.device, dtype=torch.float32)
    err = library().svdx_chain_int8_qd(q.data_ptr(), kTi.data_ptr(), vi.data_ptr(),
                                       out.data_ptr(), p_scratch.data_ptr(),
                                       partial[0].data_ptr(), partial[1].data_ptr(), bq,
                                       bkm, int(n_inner), 1.0 / bkm, _stream(q))
    check(err, "chain_int8_qd")
    chain_int8_qd.launches += 1
    return out


chain_bf16.launches = 0
chain_int8_qd.launches = 0
