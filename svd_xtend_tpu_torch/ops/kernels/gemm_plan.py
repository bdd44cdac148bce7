"""The plan of one launch on the shared Hopper GEMM mainloop
(``csrc/sm90_gemm.cuh``): tile width, K slices and grid, chosen on the host
from the shape alone.

C (M x N) = A (M x K) · Bᵀ with K in tiles of 64. A block (two consumer
warpgroups) computes BM = 128 rows by ``bn`` columns; its items are
(N tile, M tile, K slice) with the N tile fastest (``GemmPlan.items`` walks
them in the kernel's order), and ``grid`` persistent blocks take items
w = block, block + grid, ... A K slice s of S covers the K tiles
[s·kt // S, (s + 1)·kt // S); with S > 1 the partial sums are added in the
fixed order 0..S-1 by a second kernel, which also runs the epilogue.

The choice is the cheapest under a model of the card fitted to the device
times of every candidate at the UNet's conv3x3 sites and dU shapes on an
H100 80GB HBM3 at 700 W (``scripts/bench_gemm_plans.py``; PERF.md), in µs: a K tile of an item
costs c1·bn/64 + c0; an item adds o1 for its epilogue where it finishes
its own outputs; a split adds its partials' traffic at rho µs a GB; items
are spread over the SMs in whole rounds. Where some candidate gives every
SM an item (K slices), one that does not is not taken. Over the 40
measured shapes (32 conv3x3, GEGLU's second GEMM at 8) the model's pick was
2.7 % slower than the fastest candidate on average, 39 % at worst (the 5x8
level's 1280 -> 1280 dU, where the fastest plan leaves SMs without an
item). The plain rule "the widest tile with the least N waste, then the
fewest K slices that give every SM an item" was 9.7 % slower on average:
at the UNet's sites it costs the CFG pass's conv3x3 forwards 1.1 ms more
(12.3 ms against 11.2), mostly at the 10x16 and 5x8 levels, where the
model splits K or narrows the tile to even out the rounds.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Sequence

K_TILE = 64              # K per stage: one 128-byte swizzle atom of bf16
SM_COUNT = 132           # an H100 SXM; the wrappers pass the card's own count
MAX_BOX = 256            # TMA's largest box dimension
MAX_SLICES = 4          # the most the plan bench measured
MIN_SLICE_TILES = 4      # K tiles per slice at least

BM = 128                 # rows per tile (both mainloops)

# the model's constants, µs (fitted; see the module docstring)
_C1, _C0 = 0.1691, 0.25          # a K tile: c1 per 128 x 64 outputs, c0 fixed
_O1 = 1.0                        # an item's epilogue
_RHO = 600.0                     # a split's partials, µs a GB


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One launch: ``mainloop`` "tma" (csrc/sm90_gemm.cuh) or "mma" (conv3x3's
    mma.sync mainloop, for Ci % 64 != 0: 128 x 128 tiles, one block each, K
    in tiles of 32)."""

    m: int
    n: int
    k_tiles: int
    bn: int
    k_slices: int
    grid: int
    mainloop: str = "tma"
    bm = BM

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.bm)

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.bn)

    @property
    def n_items(self) -> int:
        return self.m_tiles * self.n_tiles * self.k_slices

    @property
    def a_box(self) -> tuple:
        """(inner elements, rows) of A's TMA box: 64 bf16 = 128 bytes."""
        return (K_TILE, self.bm)

    @property
    def b_box(self) -> tuple:
        return (K_TILE, self.bn)

    @property
    def workspace_elems(self) -> int:
        """f32 partials the split needs, (k_slices, m, n), or 0."""
        return self.k_slices * self.m * self.n if self.k_slices > 1 else 0

    def items(self) -> Iterator[tuple]:
        """(m0, n0, k0, k1) of every item in the kernel's order."""
        bounds = slice_bounds(self.k_tiles, self.k_slices)
        for w in range(self.n_items):
            nt, rest = w % self.n_tiles, w // self.n_tiles
            mt, ks = rest % self.m_tiles, rest // self.m_tiles
            yield mt * self.bm, nt * self.bn, *bounds[ks]


def slice_bounds(k_tiles: int, k_slices: int) -> list:
    """[(k0, k1)] of each K slice, as the kernel splits them."""
    return [(s * k_tiles // k_slices, (s + 1) * k_tiles // k_slices) for s in range(k_slices)]


def cost(plan: GemmPlan, sm_count: int = SM_COUNT) -> float:
    """The model's µs for one launch (see the module docstring)."""
    k_per_item = -(-plan.k_tiles // plan.k_slices)
    tile = _C1 * plan.bn / 64 + _C0
    rounds = -(-plan.n_items // sm_count)
    if plan.k_slices == 1:
        return rounds * (k_per_item * tile + _O1)
    partials = (plan.k_slices * 8 + 4) * plan.m * plan.n * 1e-9
    return rounds * k_per_item * tile + _RHO * partials


def candidates(m: int, n: int, k_tiles: int, widths: Sequence[int],
               sm_count: int = SM_COUNT, max_slices: int = MAX_SLICES) -> list:
    """Every plan the kernels take for the shape, each with its grid."""
    out = []
    for bn in widths:
        for k_slices in range(1, max_slices + 1):
            if k_slices > 1 and k_tiles // k_slices < MIN_SLICE_TILES:
                break
            plan = GemmPlan(m, n, k_tiles, bn, k_slices, 1)
            out.append(dataclasses.replace(plan, grid=min(plan.n_items, sm_count)))
    return out


def plan_gemm(m: int, n: int, k_tiles: int, widths: Sequence[int], sm_count: int = SM_COUNT,
              max_slices: int = MAX_SLICES) -> GemmPlan:
    """The cheapest plan under `cost` among those the kernels take (those
    with an item for every SM first)."""
    if m < 1 or n < 1 or k_tiles < 1 or n % 2:
        raise ValueError(f"gemm plan: no plan for M {m}, N {n}, {k_tiles} K tiles")
    # ties: fewer slices, then wider tiles
    return min(candidates(m, n, k_tiles, widths, sm_count, max_slices),
               key=lambda p: (p.n_items < sm_count, cost(p, sm_count), p.k_slices, -p.bn))


# the tile widths csrc/temporal_resnet.cu instantiates (SVDX_TRESNET_TILE_N)
TRESNET_TILE_N = (128, 160, 256)


@functools.cache
def tresnet_plan(b: int, f: int, s: int, c: int, sms: int = SM_COUNT) -> GemmPlan:
    """The plan of one temporal-resnet frame conv over (b, f, s, c) on a card
    of `sms` SMs: the implicit GEMM M = b·f·s, N = c, K = 3c (a K tile is 64
    channels of one frame tap), the K split only where it gives every SM an
    item. Memoized, as conv3x3_plan: no plan is computed per launch."""
    return plan_gemm(b * f * s, c, 3 * c // K_TILE, TRESNET_TILE_N, sms)


def mma_plan(m: int, n: int, k_tiles: int) -> GemmPlan:
    """conv3x3's mma.sync mainloop: 128 x 128 tiles, one block per tile."""
    plan = GemmPlan(m, n, k_tiles, 128, 1, 1, mainloop="mma")
    return dataclasses.replace(plan, grid=plan.n_items)


def sm_count(device) -> int:
    """The SMs of a CUDA device (cached per device index)."""
    import torch
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.cache
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
