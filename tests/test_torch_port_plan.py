"""The launch plans of the shared Hopper GEMM mainloop (csrc/sm90_gemm.cuh)
and GEGLU's W1 packing, on the CPU: plans are pure functions of the shape,
so every conv3x3 site, GEGLU shape and temporal resnet site of the main
paths is checked here for
what the kernels rely on (the mainloop, tiles and K slices that cover the
problem once, TMA-legal boxes, tile widths the sources instantiate); the
packed W1 against the plain GEGLU. Also the frame attention's launch
geometry (csrc/temporal_attention.cu) for every frame count it takes, and
group_norm_silu's path choice (csrc/group_norm.cu) at every site of the
main paths."""

import collections
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
from svd_xtend_tpu_torch.ops.kernels import geglu as gg
from svd_xtend_tpu_torch.ops.kernels import gemm_plan
from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
from svd_xtend_tpu_torch.ops.kernels.gemm_plan import K_TILE, MAX_BOX, SM_COUNT, slice_bounds
from svd_xtend_tpu_torch.scripts import sites

CSRC = Path(cv.__file__).resolve().parents[2] / "csrc"


def _source_widths(macro: str) -> tuple:
    """The tile widths a `#define macro 8, 64, ...` line of csrc/ lists."""
    for src in CSRC.glob("*.cu"):
        m = re.search(rf"#define {macro} ([\d, ]+)\n", src.read_text())
        if m:
            return tuple(int(v) for v in m.group(1).split(","))
    raise AssertionError(f"{macro} not found in {CSRC}")


def _conv_sites():
    """(batch, H, W, Ci, Co, label) of every conv3x3 launch shape of the paths:
    the UNet at CFG batch 28 and training batch 14, the train step's dU
    (dy's Co channels in, the forward's Ci out), the VAE decoder's and
    encoder's chunks of 8 frames and generate's one-frame image encode."""
    out = set()
    for batch in (28, 14):
        out |= {(batch, h, w, ci, co, epi) for h, w, ci, co, epi, _ in sites.UNET_CONV_SITES}
    out |= {(14, h, w, co, ci, "dU") for h, w, co, ci, _ in sites.UNET_DGRAD_SITES}
    out |= {(8, h, w, ci, co, epi) for h, w, ci, co, epi, _ in sites.VAE_DECODE_SITES}
    for batch in (8, 1):
        out |= {(batch, h, w, ci, co, epi) for h, w, ci, co, epi, _ in sites.VAE_ENCODE_SITES}
    return sorted(out)


def _check_cover(plan):
    """The items tile M, N and the K tiles exactly once, in the kernel's
    order, and the grid fits the items (and, persistent, the SMs)."""
    assert plan.m_tiles * plan.bm >= plan.m > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= plan.n > (plan.n_tiles - 1) * plan.bn
    bounds = slice_bounds(plan.k_tiles, plan.k_slices)
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.k_tiles
    assert all(k0 < k1 for k0, k1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    seen = collections.Counter(plan.items())
    assert sum(seen.values()) == plan.n_items == len(seen)
    assert {(m0 // plan.bm, n0 // plan.bn) for m0, n0, _, _ in seen} == {
        (i, j) for i in range(plan.m_tiles) for j in range(plan.n_tiles)}
    per_tile = collections.Counter((m0, n0) for m0, n0, _, _ in seen)
    assert set(per_tile.values()) == {plan.k_slices}
    if plan.mainloop == "tma":       # persistent blocks
        assert 1 <= plan.grid <= min(plan.n_items, SM_COUNT)
    else:                            # one block per tile
        assert plan.grid == plan.n_items


def _check_tma(plan, widths):
    assert plan.mainloop == "tma"
    assert plan.bn in widths and plan.bm == 128
    for box in (plan.a_box, plan.b_box):
        assert box[0] * 2 == 128 and all(1 <= d <= MAX_BOX for d in box)
    assert plan.workspace_elems == (plan.k_slices * plan.m * plan.n if plan.k_slices > 1 else 0)


@pytest.mark.parametrize("site", _conv_sites(), ids=lambda st: "-".join(map(str, st)))
def test_conv3x3_plan_at_site(site):
    batch, h, w, ci, co, label = site
    plan = cv.conv3x3_plan(batch, h, w, ci, co)
    assert (plan.m, plan.n) == (batch * h * w, co)
    if ci % K_TILE:
        # only the UNet's conv_in (Ci 8) keeps the mma.sync mainloop
        assert (ci, label) == (8, "none") and plan.mainloop == "mma"
        assert plan.bn == 128
    else:
        _check_tma(plan, _source_widths("SVDX_CONV_TILE_N"))
        assert plan.k_tiles == 9 * ci // K_TILE
        assert (plan.bn == 8) == (co <= 8)
    _check_cover(plan)


def test_conv3x3_plan_fills_the_5x8_level():
    """At the 5x8 level (M = 1120 or 560) the plans give the SMs work: at
    least 132 items by K slices."""
    for batch, ci, co in [(28, 1280, 1280), (28, 2560, 1280), (14, 1280, 1280),
                          (14, 1280, 2560)]:
        plan = cv.conv3x3_plan(batch, 5, 8, ci, co)
        assert plan.n_items >= SM_COUNT, (batch, ci, co, plan)


def test_conv3x3_plan_takes_the_card_sm_count():
    plan = cv.conv3x3_plan(28, 40, 64, 320, 320, sms=114)
    _check_tma(plan, _source_widths("SVDX_CONV_TILE_N"))
    assert plan.grid <= 114
    assert cv.conv3x3_plan(28, 40, 64, 320, 320) == cv.conv3x3_plan(28, 40, 64, 320, 320)


@pytest.mark.parametrize("site", sites.TRESNET_SITES, ids=lambda st: "-".join(map(str, st)))
def test_tresnet_plan_at_site(site):
    """Every temporal resnet shape of the exact video and the train step: a
    TMA plan at a width csrc/temporal_resnet.cu instantiates, K = 3C in
    tiles of 64, covering the M x N items once, memoized."""
    b, f, s, c, per_video, per_step = site
    assert per_video + per_step > 0
    plan = gemm_plan.tresnet_plan(b, f, s, c)
    assert gemm_plan.TRESNET_TILE_N == _source_widths("SVDX_TRESNET_TILE_N")
    _check_tma(plan, gemm_plan.TRESNET_TILE_N)
    assert (plan.m, plan.n, plan.k_tiles) == (b * f * s, c, 3 * c // K_TILE)
    _check_cover(plan)
    assert gemm_plan.tresnet_plan(b, f, s, c) is plan


def test_tresnet_sites_count_the_blocks():
    """578 launches of each kernel per exact video (22 blocks a CFG UNet pass
    for 25 steps, 14 a decode chunk for 2 chunks), 44 per train step (22
    blocks, forward and recompute); the 5x8 level splits K at both batches,
    and every split gives each SM an item."""
    assert sum(st[4] for st in sites.TRESNET_SITES) == 25 * 22 + 2 * 14
    assert sum(st[5] for st in sites.TRESNET_SITES) == 2 * 22
    for b in (2, 1):
        assert gemm_plan.tresnet_plan(b, 14, 40, 1280).k_slices > 1
    for b, f, s, c, _, _ in sites.TRESNET_SITES:
        plan = gemm_plan.tresnet_plan(b, f, s, c)
        assert plan.k_slices == 1 or plan.n_items >= SM_COUNT


@pytest.mark.parametrize("shape", [(2, 1, 7, 64), (2, 3, 50, 128), (1, 1, 1, 64),
                                   (3, 14, 40, 320)])
def test_tresnet_plan_small_and_ragged(shape):
    """F = 1, ragged S, C = 64 (one tile wider than the matrix): still an
    instantiated width, covering every item; on a card of fewer SMs the grid
    follows."""
    plan = gemm_plan.tresnet_plan(*shape)
    _check_tma(plan, gemm_plan.TRESNET_TILE_N)
    _check_cover(plan)
    assert gemm_plan.tresnet_plan(*shape, sms=16).grid <= 16


@pytest.mark.parametrize("t,c", sites.GEGLU_SHAPES + [(130, 320), (1000, 320), (130, 1280),
                                                      (1000, 64), (130, 64), (37, 64)])
def test_geglu_plan(t, c):
    first, second = gg.geglu_plan(t, c)
    _check_tma(first, _source_widths("SVDX_GEGLU1_TILE_N"))
    _check_tma(second, _source_widths("SVDX_GEGLU2_TILE_N"))
    assert (first.m, first.n, first.k_tiles, first.k_slices) == (t, 8 * c, c // K_TILE, 1)
    assert first.bn % (2 * gg.PAIR_ROWS) == 0       # whole value/gate blocks per tile
    assert (second.m, second.n, second.k_tiles) == (t, c, 4 * c // K_TILE)
    _check_cover(first)
    _check_cover(second)


@pytest.mark.parametrize("c", [64, 320, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_w1_inverts(c, dtype):
    w1 = torch.from_numpy(np.random.default_rng(c).standard_normal((8 * c, c))).to(dtype)
    packed = gg.pack_w1(w1)
    assert packed.shape == w1.shape
    assert torch.equal(gg.unpack_w1(packed), w1)
    # block b of 128 rows: value rows 64b.. then the matching gate rows
    inner = 4 * c
    for b in (0, inner // 64 - 1):
        assert torch.equal(packed[128 * b:128 * b + 64], w1[64 * b:64 * b + 64])
        assert torch.equal(packed[128 * b + 64:128 * b + 128],
                           w1[inner + 64 * b:inner + 64 * b + 64])


def _geglu_from_packed(x, ls, lb, w1p, b1, w2, b2):
    """The plain GEGLU on the packed W1, paired as the first GEMM's epilogue
    pairs it: packed column 128b + j (j < 64) is value column 64b + j, and
    packed column 128b + 64 + j its gate."""
    dt = x.dtype
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    xn = ((xc * torch.rsqrt(var + gg.LN_EPS)) * ls.float() + lb.float()).to(dt)
    hg = F.linear(xn.float(), w1p.to(dt).float(), gg.pack_w1(b1[:, None])[:, 0].float())
    hg = hg.unflatten(-1, (-1, 2, gg.PAIR_ROWS))
    h, g = hg[..., 0, :].flatten(-2), hg[..., 1, :].flatten(-2)
    u = (h * F.gelu(g, approximate="tanh")).to(dt)
    return x + F.linear(u.float(), w2.to(dt).float(), b2.float()).to(dt)


@pytest.mark.parametrize("t,c,dtype", [(130, 64, torch.bfloat16), (37, 320, torch.bfloat16),
                                       (50, 128, torch.float32)])
def test_packed_pairing_matches_reference(t, c, dtype):
    rng = np.random.default_rng(t)
    rn = lambda *s, sc=1.0: torch.from_numpy(rng.standard_normal(s) * sc).to(dtype)
    args = [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
            0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]
    ref = gg.ln_geglu_residual_reference(*args)
    packed = list(args)
    packed[3] = gg.pack_w1(args[3])
    assert torch.equal(_geglu_from_packed(*packed), ref)


# ------------------------------------------- frame attention, group norm --

def _instantiated_frame_plans() -> set:
    """The (f_pad, tokens, stages) plans csrc/temporal_attention.cu's entry
    point dispatches to."""
    src = (CSRC / "temporal_attention.cu").read_text()
    found = re.findall(r"if \(f_pad == (\d+) && tokens == (\d+) && stages == (\d+)\)\n"
                       r"\s+return launch<(\d+), (\d+), (\d+)>", src)
    assert found, "no plan dispatch found in temporal_attention.cu"
    for plan in found:
        assert plan[:3] == plan[3:]
    return {tuple(int(v) for v in plan[:3]) for plan in found}


@pytest.mark.parametrize("f", range(1, ta.MAX_FRAMES + 1))
def test_frame_plan(f):
    """A plan the source instantiates; a token's frames fill one or two
    m16 row tiles (16 when F <= 16); the ring of 2-3 stages, one consumer
    warp a token, within a block's shared memory."""
    plan = ta.frame_plan(f)
    assert (plan.f_pad, plan.tokens, plan.stages) in _instantiated_frame_plans()
    assert plan.f_pad == (16 if f <= 16 else 32)
    assert 2 <= plan.stages <= 3 and plan.tokens * 32 + 32 <= 1024
    tile = plan.tokens * plan.f_pad * 128         # one of q, k, v: 1024-byte multiples
    assert tile % 1024 == 0
    assert plan.smem == plan.stages * (3 * tile + 16) + 1024 <= ta.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("f", [0, ta.MAX_FRAMES + 1])
def test_frame_plan_refuses_frame_counts_outside_the_kernel(f):
    with pytest.raises(ValueError):
        ta.frame_plan(f)


def _gn_constants() -> dict:
    src = (CSRC / "group_norm.cu").read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_group_norm_plan_mirrors_the_kernel():
    """The Python plan's constants and shared-memory layout are the
    kernel's (csrc/group_norm.cu's gn_cluster namespace)."""
    k = _gn_constants()
    assert (k["kCtas"], k["kThreads"], k["kPieces"], k["kMaxGroups"], k["kSmemLimit"]) == (
        gn.CLUSTER_CTAS, gn.GN_THREADS, gn.GN_PIECES, gn.GN_MAX_GROUPS, gn.SMEM_LIMIT)


def _gn_sites():
    """(shape, silu) of every group_norm_silu site of the paths."""
    return sorted({(shape, silu) for shape, silu, *_ in sites.GN_SITES})


@pytest.mark.parametrize("shape,silu", _gn_sites())
def test_group_norm_plan_at_the_sites(shape, silu):
    """Every UNet site (generate's batch 28, the train step's 14) runs the
    cluster kernel, its rows cut into 8 CTAs once, within a CTA's shared
    memory; the VAE's samples of more than the cluster holds run the two
    passes."""
    plan = gn.group_norm_plan(shape, torch.bfloat16, 32)
    rows, c = math.prod(shape[1:-1]), shape[-1]
    if plan.path == "cluster":
        assert plan.rows_per_cta * gn.CLUSTER_CTAS >= rows > (plan.rows_per_cta - 1) * 8
        assert plan.smem == gn.cluster_smem(plan.rows_per_cta, c, 2) <= gn.SMEM_LIMIT
        assert plan.rows_per_cta * c * 2 <= plan.smem
    else:
        assert plan == gn.GroupNormPlan("two_pass", 0, 0)
        assert gn.cluster_smem(-(-rows // 8), c, 2) > gn.SMEM_LIMIT
    unet = shape[0] in (28, 14)
    assert (plan.path == "cluster") == unet


def test_group_norm_launches_by_path():
    """431 launches an exact video (425 of them the UNet's, on the cluster
    kernel), 39 a train step, and the two-pass path 6 times a video."""
    paths = collections.Counter()
    for shape, silu, eps, video, step in sites.GN_SITES:
        paths[gn.group_norm_plan(shape, torch.bfloat16, 32).path] += video
    assert sum(st[3] for st in sites.GN_SITES) == 431
    assert sum(st[4] for st in sites.GN_SITES) == 39
    assert paths == {"cluster": 425, "two_pass": 6}


@pytest.mark.parametrize("c", [64, 128, 320, 512, 640, 1280])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_group_norm_plan_largest_cluster_sample(c, dtype):
    """The cluster path takes a sample up to the largest rows whose cut fits
    a CTA, and refuses the next 8 rows; a channel count of more 16-byte
    vectors than a CTA has threads always takes the two passes."""
    elem = dtype.itemsize
    if c // (16 // elem) > gn.GN_THREADS:
        assert gn.group_norm_plan((2, 8, c), dtype, 32).path == "two_pass"
        return
    rows = 8
    while gn.cluster_smem(rows // 8 + 1, c, elem) <= gn.SMEM_LIMIT:
        rows += 8
    assert gn.group_norm_plan((2, rows, c), dtype, 32).path == "cluster"
    assert gn.group_norm_plan((2, rows + 1, c), dtype, 32).path == "two_pass"
    assert gn.group_norm_plan((2, 1, c), dtype, 32).path == "cluster"


def test_group_norm_plan_refuses_more_groups_than_the_kernel_holds():
    assert gn.group_norm_plan((2, 64, 1280), torch.bfloat16, gn.GN_MAX_GROUPS).path == "cluster"
    assert gn.group_norm_plan((2, 64, 1280), torch.bfloat16, 128).path == "two_pass"
