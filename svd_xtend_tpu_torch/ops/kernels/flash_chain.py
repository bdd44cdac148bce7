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

The CUDA kernels are ``csrc/flash_chain.cu``: a cluster of CLUSTER blocks
per 64 rows of q, split by keys (``key_slices``), each holding its keys' K
and V in shared memory for all steps and issuing wgmma against them; the
cluster sums its partial P·V through distributed shared memory in rank
order (``chain_bf16_split_reference`` is that order's plain version). The
int8 chain takes two grid-wide maxima a step, the second from the int32
scores' maximum (``chain_int8_qd_intmax_reference``: |f32(n)·sq·(1/bkm)| is
odd and monotone in n, so max|p| is p(max|S|) bit for bit); its barrier
counters are a workspace per (device, stream). The int8 kernel equals its
plain version bit for bit. On CPU tensors the entry points run the plain
versions; on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ._build import check, library

HEAD_DIM = 64
ROWS = 64            # rows of q per cluster, and keys per staged block
CLUSTER = 4          # blocks a cluster, split by keys (at most bkm / 64): bf16's
CLUSTER_INT8 = 8     # ... int8's, whose two grid-wide maxima a step favour more SMs
WS_WORDS = 160       # the int8 chain's barrier workspace (csrc/flash_chain.cu)
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


def key_slices(bkm: int, cluster: int):
    """The key ranges of a cluster's blocks: block r takes the 64-key blocks
    [r·nb // cluster, (r + 1)·nb // cluster), nb = bkm // 64."""
    nb = bkm // ROWS
    return [(r * nb // cluster * ROWS, (r + 1) * nb // cluster * ROWS) for r in range(cluster)]


def cluster_size(bkm: int, cluster: int = CLUSTER) -> int:
    return max(1, min(cluster, bkm // ROWS))


SMEM_CAP = 232448 - 128   # csrc/flash_chain.cu's bound on a block's dynamic shared memory


def smem_bytes(bkm: int, cluster: int, int8: bool) -> int:
    """A block's dynamic shared memory (csrc/flash_chain.cu's smem_bytes):
    its K and V tiles of 8 KB a 64-key block, qi and pi (int8), the
    double-buffered 64 x 64 partials and 1 KB of alignment slack."""
    kb = -(-(bkm // ROWS) // cluster)
    return 1024 + 2 * kb * 8192 + (2 * 8192 if int8 else 0) + 2 * ROWS * HEAD_DIM * 4


def fits(bkm: int, cluster: int, int8: bool) -> bool:
    """Whether a cluster of `cluster` blocks holds bkm keys' K and V."""
    return smem_bytes(bkm, cluster_size(bkm, cluster), int8) <= SMEM_CAP


def chain_bf16_split_reference(q, kT, v, n_inner: int = 60, cluster: int = CLUSTER):
    """Plain version of the clustered bf16 kernel's order: each step every
    block's partial P·V over its key slice in f32, the partials summed in
    rank order; p and q rounded to bf16 as in ``chain_bf16_reference``."""
    kf, vf = kT.float(), v.float()
    inv = 1.0 / kT.shape[1]
    slices = key_slices(kT.shape[1], cluster_size(kT.shape[1], cluster))
    x = q.to(torch.bfloat16)
    for _ in range(n_inner):
        o = None
        for a, b in slices:
            p = ((x.float() @ kf[:, a:b]) * inv).to(torch.bfloat16)
            part = p.float() @ vf[a:b]
            o = part if o is None else o + part
        x = (o * 0.25).to(torch.bfloat16)
    return x.float()


def chain_int8_qd_intmax_reference(q: torch.Tensor, kTi: torch.Tensor, vi: torch.Tensor,
                                   n_inner: int = 60) -> torch.Tensor:
    """The int8 kernel's arithmetic: the scale of p from the largest |S| of
    the int32 scores (the first pass) instead of the largest |p|, then p
    recomputed and quantised (the second pass). Equal to
    ``chain_int8_qd_reference`` bit for bit: f32(n)·sq·(1/bkm), each product
    rounded to nearest, is odd and non-decreasing in n."""
    kd, vd = kTi.double(), vi.double()
    inv = 1.0 / kTi.shape[1]
    x = q.float()
    for _ in range(n_inner):
        qi, sq = _quant(x)
        s = qi.double() @ kd                            # the int32 scores, exact
        sp = ((s.abs().max().float() * sq) * inv) * INV_127 + 1e-12
        p = (s.float() * sq) * inv
        pi = torch.round(p / sp)
        o = (pi.double() @ vd).float() * sp
        x = o * 0.25
    return x


def _validate(q, kT, v, dtype, cluster):
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
    if not fits(kT.shape[1], cluster, dtype == torch.int8):
        raise ValueError(f"flash chain: a cluster of {cluster_size(kT.shape[1], cluster)} "
                         f"blocks does not hold {kT.shape[1]} keys in shared memory")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


_workspaces = {}
_stream_slots = {}
WS_STREAMS = 64


def _workspace(device: torch.device, stream: int) -> torch.Tensor:
    """This (device, stream)'s WS_WORDS barrier words of the device's
    workspace, zeroed once (outside any CUDA graph capture); the int8 kernel
    leaves them at zero."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    ws = _workspaces.get(index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("chain_int8_qd: the first call on a device must come before "
                               "any CUDA graph capture (its workspace is made once)")
        ws = _workspaces[index] = torch.zeros(WS_STREAMS, WS_WORDS, dtype=torch.int32,
                                              device=device)
    slot = _stream_slots.setdefault((index, stream), sum(k[0] == index for k in _stream_slots))
    if slot >= WS_STREAMS:
        raise RuntimeError(f"chain_int8_qd: more than {WS_STREAMS} streams on a device")
    return ws[slot]


def chain_bf16(q: torch.Tensor, kT: torch.Tensor, v: torch.Tensor,
               n_inner: int = 60, cluster: int = CLUSTER) -> torch.Tensor:
    """(bq, 64) bf16, (64, bkm) bf16, (bkm, 64) bf16 -> (bq, 64) f32."""
    if q.device.type == "cpu":
        return chain_bf16_reference(q, kT, v, n_inner)
    _validate(q, kT, v, torch.bfloat16, cluster)
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    err = library().svdx_chain_bf16(q.data_ptr(), kT.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    q.shape[0], kT.shape[1], int(n_inner),
                                    cluster_size(kT.shape[1], cluster), 1.0 / kT.shape[1],
                                    _stream(q))
    check(err, "chain_bf16")
    chain_bf16.launches += 1
    return out


def chain_int8_qd(q: torch.Tensor, kTi: torch.Tensor, vi: torch.Tensor,
                  n_inner: int = 60, cluster: int = CLUSTER_INT8) -> torch.Tensor:
    """(bq, 64) bf16, (64, bkm) int8, (bkm, 64) int8 -> (bq, 64) f32."""
    if q.device.type == "cpu":
        return chain_int8_qd_reference(q, kTi, vi, n_inner)
    _validate(q, kTi, vi, torch.int8, cluster)
    bkm = kTi.shape[1]
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    stream = _stream(q)
    err = library().svdx_chain_int8_qd(q.data_ptr(), kTi.data_ptr(), vi.data_ptr(),
                                       out.data_ptr(), _workspace(q.device, stream).data_ptr(),
                                       q.shape[0], bkm, int(n_inner), cluster_size(bkm, cluster),
                                       1.0 / bkm, stream)
    check(err, "chain_int8_qd")
    chain_int8_qd.launches += 1
    return out


chain_bf16.launches = 0
chain_int8_qd.launches = 0
