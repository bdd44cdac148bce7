"""Dynamic per-tensor int8 quantisation of bf16 activations on a hand
kernel, the first half of the W8A8 path (``ops/quant.py``).

The function is ``svd_xtend_tpu/ops/quant.py::quantize_dynamic`` (XLA code
in the JAX package, no Pallas kernel), at a conv site after its prologue:
JAX applies the folded GroupNorm affine (+ SiLU) in f32, rounds it to bf16
and then quantises it (blocks.py:294-302), over the channel concat of the
up blocks' two sources (blocks.py:277-284); and at the feed-forward's
second projection after the gate, h * gelu_tanh(g) of net.0.proj's halves
(transformer.py:204-208 of the port's module path). ``quantize_reference``
is that plain version; the kernel is ``csrc/int8_quant.cu``, which applies
the prologue, the gate or the second source as it reads, writes the codes
at the full width and keeps the scale on the device: ``stats`` is a (2,)
f32 tensor (amax, scale) that the GEMM's epilogue reads
(``ops/kernels/int8_gemm.py``), so nothing waits for the host.

Without an amax group the kernel is one cooperative launch of persistent
blocks that keep the prologue's values in shared memory across a grid-wide
barrier (``quantize_plan``, a pure function of the shape and the SM count,
says how the rows are shared and kept); the barrier's counter and the
blocks' maxima live in a workspace per (device, stream), made once outside
any CUDA graph capture. Over several ranks (``quant.quantized(mode,
group)``) the tensor of a call is split over the ranks of the group (data
rows, frames, a row-parallel product's inputs), and its amax is the
largest over the group: the plain version all-reduces its amax; the kernel
runs in two launches (``phase`` 1, then 2) with the blocks' maxima
all-reduced between them in a buffer of MAX_BLOCKS (the ranks' grids may
differ), which the second launch reads whole. A rank whose part is empty (a
model rank without a head) adds an amax of 0 to the reduction and launches
nothing.

On a CPU tensor ``quantize`` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...parallel.frames import all_reduce_max_
from .. import quant
from ._build import check, library
from .conv3x3 import apply_pre_affine
from .gemm_plan import SM_COUNT, sm_count

CONSUMERS = 480        # csrc/int8_quant.cu's kConsumers (and one producer warp)
MAX_BLOCKS = 1024      # kMaxBlocks: the phased form's partials
MAX_SLOTS = 63         # kMaxSlots
HEADER = 2048          # kHeader
LUT_BYTES = 131072     # kLutBytes: the gate's GELU table, in shared memory at the gate
MAX_SMEM = 232448      # the most dynamic shared memory a block takes on Hopper
TILE_BYTES = 32768     # a slot's target: the rows of a bulk copy
SMALL_TILE_BYTES = 16384  # ... for a call under SMALL_CALL_TILES of those a block
SMALL_CALL_TILES = 4
TINY_BYTES = 128 << 10  # a call this small takes one block and no barrier (the 2- and 28-row denses)
L2_KEEP = 24 << 20     # tiles read again are held in L2 (evict-last) up to this much
# the workspace: per stream, the barrier's count (word 0) and generation
# (word 32), then MAX_BLOCKS partials
WS_HEADER = 128
WS_WORDS = WS_HEADER + MAX_BLOCKS
WS_STREAMS = 64
MODES = {"plain": 0, "affine": 1, "affine+silu": 2, "gate": 3}


@dataclasses.dataclass(frozen=True)
class QuantizePlan:
    """How a launch shares the rows: `tiles` tiles of `tile_rows` rows,
    `grid` blocks of `share` tiles each (the last may hold fewer), read
    through a ring of `slots` shared-memory slots of `slot_bytes`: a block
    keeps its last `slots` tiles there across the barrier and reads its
    others again after it (``streamed_tiles``); `vec` values a thread and
    step; `tma`: the bulk asynchronous copies (else vector loads); `keep_l2`:
    the tiles read again are loaded with L2's evict-last policy."""
    tile_rows: int
    tiles: int
    grid: int
    share: int
    slots: int
    slot_bytes: int
    vec: int
    tma: bool
    keep_l2: bool
    gate: bool = False

    @property
    def smem_bytes(self) -> int:
        return HEADER + (LUT_BYTES if self.gate else 0) + self.slots * self.slot_bytes

    @property
    def streamed_tiles(self) -> int:
        """Tiles read twice in one launch (all of them in the phased form,
        whose plans keep none: ``kept_tiles`` 0)."""
        return self.tiles - self.kept_tiles

    @property
    def kept_tiles(self) -> int:
        shares = [min(self.share, self.tiles - b * self.share) for b in range(self.grid)]
        return sum(min(n, self.slots) for n in shares)


def quantize_plan(m: int, widths: Tuple[int, ...], gate: bool = False,
                  rows_per_sample: Optional[int] = None, sms: int = SM_COUNT,
                  phased: bool = False, aligned: bool = True) -> QuantizePlan:
    """The plan of a call over `m` rows whose sources hold `widths` values a
    row (x's, then x2's; at the gate x's 2c). Tiles of about TILE_BYTES, or
    SMALL_TILE_BYTES where the call is under SMALL_CALL_TILES large tiles a
    block (at most `rows_per_sample` rows with an affine prologue, so a tile
    spans at most two samples); one block where the call is at most
    TINY_BYTES, else up to one block an SM with an equal share each; as
    many slots as the share needs and shared memory holds (at the gate,
    beside the GELU table). `phased` (an amax group): two launches,
    every tile read in each (the plan's kept tiles are then not kept).
    `aligned`: the sources' addresses are 16-byte aligned."""
    parts = (widths[0] // 2,) if gate else tuple(widths)
    if m < 1 or any(w < 4 or w % 4 for w in parts):
        raise ValueError(f"int8_quantize plan: {m} rows of widths {widths}")
    vec = 8 if all(w % 8 == 0 for w in parts) else 4
    row_bytes = 2 * sum(widths)
    small = m * row_bytes < SMALL_CALL_TILES * TILE_BYTES * sms
    tile_rows = max(1, (SMALL_TILE_BYTES if small else TILE_BYTES) // row_bytes)
    if rows_per_sample is not None:
        tile_rows = min(tile_rows, rows_per_sample)
    slot_bytes = -(-tile_rows * row_bytes // 128) * 128
    budget = MAX_SMEM - HEADER - (LUT_BYTES if gate else 0)
    slots = min(MAX_SLOTS, budget // slot_bytes)
    if slots < 2:
        raise ValueError(f"int8_quantize plan: a row of {row_bytes} bytes is too wide")
    tiles = -(-m // tile_rows)
    if not phased and tiles <= slots and m * row_bytes <= TINY_BYTES:
        grid = 1
    else:
        grid = min(sms, tiles)
    share = -(-tiles // grid)
    grid = -(-tiles // share)
    slots = min(slots, share)
    plan = QuantizePlan(tile_rows, tiles, grid, share, slots, slot_bytes, vec,
                        aligned and vec == 8, False, gate)
    again = plan.tiles if phased else plan.streamed_tiles
    return dataclasses.replace(plan, keep_l2=0 < again * tile_rows * row_bytes <= L2_KEEP)


def _parts(x: torch.Tensor, x2: Optional[torch.Tensor]):
    return [x] if x2 is None else [x, x2]


def gate_reference(y: torch.Tensor) -> torch.Tensor:
    """h * gelu_tanh(g) of y = [h, g] (..., 2c): the feed-forward's module
    path (models/transformer.py::FeedForward) in y's dtype."""
    h, g = y.chunk(2, dim=-1)
    return h * F.gelu(g, approximate="tanh")


def quantize_reference(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None,
                       gate: bool = False):
    """Plain version: (codes of [x, x2] (..., C1 + C2) int8, stats (2,) f32 =
    (amax, scale)). ``pre=(sc, sh, silu)``: per-(sample, channel) f32 (N, C1
    + C2) applied to NHWC parts as ``conv3x3.apply_pre_affine`` does, per
    part, before the quantisation. ``gate``: x is [h, g] (..., 2c) and the
    tensor quantised is ``gate_reference(x)`` (..., c)."""
    parts = _parts(x, x2)
    if gate:
        parts = [gate_reference(x)]
    if pre is not None:
        sc, sh, silu = pre
        c0, out = 0, []
        for part in parts:
            c1 = c0 + part.shape[-1]
            out.append(apply_pre_affine(part, sc[:, c0:c1], sh[:, c0:c1], silu))
            c0 = c1
        parts = out
    v = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    group = quant.amax_group()
    if group is None and v.numel():
        codes, scale = quant.quantize_dynamic(v)
        amax = v.float().abs().amax()
    else:
        amax = v.float().abs().amax() if v.numel() else v.new_zeros((), dtype=torch.float32)
        if group is not None:
            amax = all_reduce_max_(amax, group)
        scale = quant.scale_of(amax)
        codes = quant.codes(v.float(), scale)
    return codes, torch.stack([amax, scale])


def supports(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None,
             gate: bool = False) -> bool:
    """Structural dispatch predicate: CUDA bf16 contiguous 8-byte aligned
    parts of the same leading shape with channels in multiples of 4 (at the
    gate 8: two halves of 4), two rows within a block's shared memory; with
    `pre`, 4-D NHWC parts of at most CONSUMERS channel vectors; the gate
    alone."""
    parts = _parts(x, x2)
    ok = all(p.is_cuda and p.dtype == torch.bfloat16 and p.is_contiguous() and p.dim() >= 2
             and p.shape[-1] % (8 if gate else 4) == 0 and p.data_ptr() % 8 == 0
             and p.shape[:-1] == x.shape[:-1] and p.device == x.device for p in parts)
    row_bytes = 2 * sum(p.shape[-1] for p in parts) if ok else 0
    budget = MAX_SMEM - HEADER - (LUT_BYTES if gate else 0)
    # with a prologue a consumer thread keeps one channel vector of each part
    vec = 8 if all(p.shape[-1] % 8 == 0 for p in parts) else 4
    narrow = pre is None or all(p.shape[-1] <= vec * CONSUMERS for p in parts)
    return (ok and row_bytes * 2 <= budget and narrow and (pre is None or x.dim() == 4)
            and not (gate and (pre is not None or x2 is not None)))


_workspaces: Dict[int, torch.Tensor] = {}
_stream_slots: Dict[Tuple[int, int], int] = {}
_gate_luts: Dict[int, torch.Tensor] = {}


def _once(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _workspaces and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("int8_quantize: the first call on a device must come before "
                           "any CUDA graph capture (its workspace is made once)")
    return index


def gate_lut(device: torch.device) -> torch.Tensor:
    """The gate's table on `device` (torch's bf16 tanh GELU of every bf16 g
    by its bits, csrc/int8_quant.cu), made once."""
    index = _once(device)
    lut = _gate_luts.get(index)
    if lut is None:
        lut = torch.empty(LUT_BYTES // 2, dtype=torch.int16, device=device)
        check(library().svdx_int8_gate_lut(lut.data_ptr(),
                                           torch.cuda.current_stream(device).cuda_stream),
              "int8_gate_lut")
        _gate_luts[index] = lut
    return lut


def _workspace(device: torch.device, stream: int) -> torch.Tensor:
    """This (device, stream)'s WS_WORDS words of the device's workspace,
    zeroed once; the kernel leaves the barrier's count at 0."""
    index = _once(device)
    ws = _workspaces.get(index)
    if ws is None:
        ws = torch.zeros(WS_STREAMS, WS_WORDS, dtype=torch.int32, device=device)
        _workspaces[index] = ws
    slot = _stream_slots.setdefault((index, stream), len(
        [k for k in _stream_slots if k[0] == index]))
    if slot >= WS_STREAMS:
        raise RuntimeError(f"int8_quantize: more than {WS_STREAMS} streams on a device")
    return ws[slot]


def _launch(x, pre, x2, gate):
    if not supports(x, pre, x2, gate):
        raise ValueError(
            "int8_quantize kernel needs CUDA bf16 contiguous parts of the same leading shape "
            "with channels % 4 == 0 (NHWC with a prologue; the gate's halves % 4, alone); got "
            + ", ".join(f"{tuple(p.shape)} {p.dtype}" for p in _parts(x, x2)))
    widths = tuple(p.shape[-1] for p in _parts(x, x2))
    c = widths[0] // 2 if gate else sum(widths)
    m = x.shape[:-1].numel()
    sc = sh = None
    rows_per_sample = None
    mode = MODES["gate"] if gate else MODES["plain"]
    if pre is not None:
        sc, sh, silu = pre
        n = x.shape[0]
        sc, sh = sc.float().contiguous(), sh.float().contiguous()
        for name, a in (("pre_scale", sc), ("pre_shift", sh)):
            if tuple(a.shape) != (n, c) or a.device != x.device or a.data_ptr() % 16:
                raise ValueError(f"int8_quantize: {name} must be a 16-byte aligned {(n, c)} "
                                 f"on x's device, got {tuple(a.shape)}")
        rows_per_sample = m // max(n, 1)
        mode = MODES["affine+silu" if silu else "affine"]
    q = torch.empty(x.shape[:-1] + (c,), device=x.device, dtype=torch.int8)
    group = quant.amax_group()
    if m * c == 0:
        # an empty part: an amax of 0 into the group's reduction, no launch
        partials = torch.zeros(MAX_BLOCKS, device=x.device, dtype=torch.float32)
        if group is not None:
            all_reduce_max_(partials, group)
        amax = partials.max()
        return q, torch.stack([amax, quant.scale_of(amax)])
    stats = torch.empty(2, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    aligned = all(p.data_ptr() % 16 == 0 for p in _parts(x, x2))
    plan = quantize_plan(m, widths, gate, rows_per_sample, sm_count(x.device),
                         phased=group is not None, aligned=aligned)
    if group is None:
        ws = _workspace(x.device, stream)
        partials, bar = ws[WS_HEADER:], ws[:WS_HEADER]
    else:
        partials, bar = torch.zeros(MAX_BLOCKS, device=x.device, dtype=torch.float32), None
    ptr = lambda a: None if a is None else a.data_ptr()

    lut = gate_lut(x.device) if gate else None

    def run(phase):
        check(library().svdx_int8_quantize(
            x.data_ptr(), ptr(x2), ptr(sc), ptr(sh), ptr(lut), q.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), ptr(bar), m, c,
            widths[0] if x2 is not None else c, rows_per_sample or 1, mode, plan.tile_rows,
            plan.share, plan.slots, plan.grid, plan.slot_bytes, plan.vec, int(plan.tma),
            int(plan.keep_l2), phase, stream), "int8_quantize")
        quantize.launches += 1

    if group is None:
        run(0)
    else:
        run(1)
        all_reduce_max_(partials, group)
        run(2)
    return q, stats


def quantize(x: torch.Tensor, pre=None, x2: Optional[torch.Tensor] = None, gate: bool = False):
    """(codes, stats) of [silu](x·sc + sh) (or x), over the channel concat
    [x, x2] when x2 is given, or of h·gelu_tanh(g) of x = [h, g] with
    `gate`; stats (2,) f32 = (amax, scale) on x's device."""
    if x.device.type == "cpu":
        return quantize_reference(x, pre, x2, gate)
    return _launch(x, pre, x2, gate)


quantize.launches = 0


def gate_values(y: torch.Tensor) -> torch.Tensor:
    """The gate prologue's bf16 values of y = [h, g] (m, 2c) on the card, as
    the kernel computes them (a proof entry, held to ``gate_reference``)."""
    if not (y.is_cuda and y.dtype == torch.bfloat16 and y.is_contiguous() and y.dim() == 2
            and y.shape[1] % 2 == 0):
        raise ValueError(f"gate_values needs a CUDA bf16 contiguous (m, 2c), got {tuple(y.shape)}")
    out = torch.empty(y.shape[0], y.shape[1] // 2, device=y.device, dtype=torch.bfloat16)
    check(library().svdx_int8_gate_values(y.data_ptr(), gate_lut(y.device).data_ptr(),
                                          out.data_ptr(), y.shape[0], y.shape[1] // 2,
                                          torch.cuda.current_stream(y.device).cuda_stream),
          "int8_gate_values")
    return out


def code_selftest(device=None) -> Tuple[int, int]:
    """(pairs whose code differs from the IEEE division's, pairs checked) over
    every bf16 v and bf16 amax >= |v| on the card (a proof entry)."""
    device = torch.device(device or "cuda")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    check(library().svdx_int8_code_selftest(counts.data_ptr(),
                                            torch.cuda.current_stream(device).cuda_stream),
          "int8_code_selftest")
    bad, pairs = counts.tolist()
    return bad, pairs


def silu_selftest(device=None) -> Tuple[int, int]:
    """(f32 a whose branch-free SiLU's bf16 differs from the exact form's,
    values checked) over every f32 |a| <= 16 on the card (a proof entry)."""
    device = torch.device(device or "cuda")
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    check(library().svdx_int8_silu_selftest(counts.data_ptr(),
                                            torch.cuda.current_stream(device).cuda_stream),
          "int8_silu_selftest")
    bad, n = counts.tolist()
    return bad, n
