"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU, in bf16, at small ragged shapes and at the training sites'
shapes (the full-size run is chip_smoke.py), and the kernels inside
autograd: every kernel's output on inputs that require grad carries a
grad_fn, and its gradients match those of its plain version. Every test is
marked ``cuda`` and skips without a card.

This file imports no jax, so it runs where jax is absent; there, skip the
repository conftest (which sets up jax for the JAX package's tests):

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import copy
import dataclasses
import math
import os

import pytest
import torch

from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe

from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
from svd_xtend_tpu_torch.ops.kernels import flash_chain as fc
from svd_xtend_tpu_torch.ops.kernels import flash_variants as fv
from svd_xtend_tpu_torch.ops.kernels import geglu as gg
from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc
from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
from svd_xtend_tpu_torch.ops.kernels.gemm_plan import GemmPlan
from svd_xtend_tpu_torch.scripts import sites

pytestmark = pytest.mark.cuda


@pytest.fixture
def rn():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA/Triton only")
    g = torch.Generator(device="cuda").manual_seed(0)
    return lambda *s, sc=1.0: (torch.randn(*s, device="cuda", generator=g) * sc
                               ).to(torch.bfloat16)


def _assert_close_bf16(got, ref):
    """Within 4 bf16 ulps of the output's scale: kernel and plain version
    round the same products at different points."""
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    bound = 4.0 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("s,t", [(200, 136), (64, 64), (40, 40)])
def test_flash_attention_kernel(rn, s, t):
    q, k, v = rn(2, s, 128), rn(2, t, 128), rn(2, t, 128)
    n = fa.flash_attention_packed.launches
    got = fa.flash_attention_packed(q, k, v, num_heads=2, scale=0.125)
    assert fa.flash_attention_packed.launches == n + 1
    _assert_close_bf16(got, fa.flash_attention_packed_reference(q, k, v, num_heads=2,
                                                                scale=0.125))


@pytest.mark.parametrize("f", [1, 3, 14, 32])
def test_frame_attention_kernel(rn, f):
    q, k, v = rn(2, f, 50, 128), rn(2, f, 50, 128), rn(2, f, 50, 128)
    got = ta.frame_attention(q, k, v, num_heads=2, scale=0.125)
    _assert_close_bf16(got, ta.frame_attention_reference(q, k, v, num_heads=2, scale=0.125))


@pytest.mark.parametrize("f,s,c", [(3, 50, 128), (1, 7, 64), (14, 40, 320)])
def test_temporal_resnet_kernels(rn, f, s, c):
    args = [rn(2, f, s, c), rn(2, f, c), rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1),
            rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1), 1 + 0.1 * rn(c).float(),
            0.1 * rn(c).float(), 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float(),
            torch.tensor(0.37, device="cuda")]
    got = tr.temporal_resnet_block(*args, groups=32, eps=1e-5)
    _assert_close_bf16(got, tr.temporal_resnet_reference(*args, 32, 1e-5))


def _tresnet_inputs(b, f, s, c, seed=0):
    """Seeded (x, t, k1, b1, k2, b2, sc1, sh1, w) at (b, f, s, c)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *sh, sc=1.0: (torch.randn(*sh, device="cuda", generator=g) * sc
                              ).to(torch.bfloat16)
    return (rn(b, f, s, c), rn(b, f, c, sc=0.5), rn(3, c, c, sc=(3 * c) ** -0.5),
            rn(c, sc=0.1), rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1),
            (1 + 0.1 * rn(b, c).float()) / 2, 0.1 * rn(b, c).float(),
            torch.tensor([0.37], device="cuda"))


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _tresnet_ab(inputs, plans=(None, None)):
    """Kernels A and B (on `plans` where given; B on the plain h) against
    their plain versions: h within 4 bf16 ulps; the statistics' channel
    sums within temporal_resnet.sums_tolerance of conv_a_reference's and,
    slot by slot, 1e-5 of the plain statistics of the kernel's own h;
    norm2's fold (sc2, sh2) in kernel A within 1e-4 of the plain fold of its
    h and bit for bit the fold kernel's from that h (statistics read back
    from device memory, the same fixed-order fold: split K or not); kernel
    B within 4 ulps. Returns (h, psum, psq, sc2, sh2, out)."""
    x, t, k1, b1, k2, b2, sc1, sh1, w = inputs
    b, f, s, c = x.shape
    (wt1, b1f), (wt2, b2f) = tr.packed(k1, b1), tr.packed(k2, b2)
    scale2, bias2 = 1 + 0.1 * sc1[0], 0.1 * sh1[-1]
    h = torch.empty_like(x)
    scratch = gn.fold_scratch(b, f * s, c, x.device)
    tr._launch(x, wt1, b1f, sc1, sh1, t, None, h, True, (scratch, scale2, bias2, 32, 1e-5),
               plans[0])
    psum, psq, sc2, sh2 = scratch
    rh, rsum, rsq = tr.conv_a_reference(x, k1, b1, sc1, sh1, t)
    _assert_close_bf16(h, rh)
    own = gn.channel_stats_reference(h.reshape(-1, c), f * s)
    for got, ref, mine in ((psum, rsum, own[0]), (psq, rsq, own[1])):
        assert _rel(got.sum(1), ref) <= tr.sums_tolerance(f * s)
        assert _rel(got, mine) <= 1e-5
    for got, ref in zip((sc2, sh2), tr.norm2_fold_reference(h, scale2, bias2, 32, 1e-5)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    back = gn.fold_with_partials(h, scale2, bias2, groups=32, eps=1e-5)
    assert all(torch.equal(a, o) for a, o in zip((psum, psq, sc2, sh2),
                                                 (back.psum, back.psq, back.sc, back.sh)))
    out = torch.empty_like(x)
    tr._launch(rh, wt2, b2f, sc1, sh1, x, w, out, False, None, plans[1])
    _assert_close_bf16(out, tr.conv_b_reference(rh, k2, b2, sc1, sh1, x, w))
    return h, psum, psq, sc2, sh2, out


@pytest.mark.parametrize("site", sites.TRESNET_SITES, ids=lambda st: "-".join(map(str, st)))
def test_tresnet_sites(rn, site):
    """Kernels A and B on their plans at every temporal resnet shape of the
    exact video and the train step, at full width (the 5x8 level's K split
    included); two runs give the same bits, the statistics included."""
    inputs = _tresnet_inputs(*site[:4])
    first, again = _tresnet_ab(inputs), _tresnet_ab(inputs)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    # the sums' bound catches h truncated to bf16 instead of rounded
    x, t, k1, b1, *_, sc1, sh1, _ = inputs
    acc = tr.conv_a_f32_reference(x, k1, b1, sc1, sh1, t)
    _, rsum, rsq = tr.conv_a_reference(x, k1, b1, sc1, sh1, t)
    trunc = (acc.view(torch.int32) & -65536).view(torch.float32).flatten(1, 2)
    bound = tr.sums_tolerance(site[1] * site[2])
    assert _rel(trunc.sum(1), rsum) > bound and _rel((trunc * trunc).sum(1), rsq) > bound


@pytest.mark.parametrize("shape", [(2, 1, 7, 64), (3, 1, 50, 128), (2, 3, 7, 64), (2, 3, 50, 128),
                                   (3, 14, 40, 320), (1, 5, 30, 192), (4, 2, 9, 256)])
def test_tresnet_small_and_ragged(rn, shape):
    """F = 1, ragged S (7, 50), tiles and 64-row chunks that straddle
    samples, C = 64 and 192 (tiles wider than the matrix)."""
    _tresnet_ab(_tresnet_inputs(*shape))


# (bn, k_slices): every tile width csrc/temporal_resnet.cu instantiates, split and not
_TRESNET_TILES = [(128, 1), (128, 4), (160, 1), (160, 3), (256, 1), (256, 2)]


@pytest.mark.parametrize("tile", _TRESNET_TILES, ids=lambda t: "bn%d-ks%d" % t)
def test_tresnet_every_tile(rn, tile):
    """Both kernels at each tile width and K split, on a ragged shape whose
    tiles straddle samples: against the plain versions, and on fewer
    persistent blocks the same bits."""
    bn, ks = tile
    b, f, s, c = 3, 5, 19, 320
    plan = GemmPlan(b * f * s, c, 3 * c // 64, bn, ks, 1)
    wide, few = (dataclasses.replace(plan, grid=min(plan.n_items, g)) for g in (132, 5))
    inputs = _tresnet_inputs(b, f, s, c)
    got = _tresnet_ab(inputs, (wide, wide))
    assert all(torch.equal(a, b) for a, b in zip(got, _tresnet_ab(inputs, (few, few))))


def test_tresnet_refuses_plans_it_does_not_take(rn):
    x, t = rn(1, 2, 8, 64), rn(1, 2, 64)
    wt, bias = tr.pack_taps(rn(3, 64, 64)), rn(64).float()
    sc, sh = rn(1, 64).float(), rn(1, 64).float()
    h, scratch = torch.empty_like(x), gn.fold_scratch(1, 16, 64, x.device)
    for plan in (GemmPlan(16, 64, 3, 64, 1, 1), GemmPlan(16, 64, 3, 96, 1, 1),
                 GemmPlan(16, 64, 3, 128, 4, 1), GemmPlan(16, 64, 3, 128, 1, 0)):
        with pytest.raises(RuntimeError):
            tr._launch(x, wt, bias, sc, sh, t, None, h, True, (scratch, bias, bias, 32, 1e-5),
                       plan)


def test_tresnet_block_is_three_launches(rn):
    """The block launches norm1's fold, kernel A and kernel B, and no
    fold_from_partials; the stream's barrier counters are left at zero."""
    args = [*_tresnet_inputs(2, 14, 40, 1280)[:6], 1 + 0.1 * rn(1280).float(),
            0.1 * rn(1280).float(), 1 + 0.1 * rn(1280).float(), 0.1 * rn(1280).float(),
            torch.tensor(0.37, device="cuda")]
    counts = lambda: (gn.group_norm_fold.launches, gn.fold_from_partials.launches,
                      tr.conv_a.launches, tr.conv_b.launches)
    before = counts()
    got = tr.temporal_resnet_block(*args, groups=32, eps=1e-5)
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 1, 1]
    _assert_close_bf16(got, tr.temporal_resnet_reference(*args, 32, 1e-5))
    stream = torch.cuda.current_stream().cuda_stream
    assert not gn.fold_barrier(got.device, stream).any()           # the barrier's counters at 0


@pytest.mark.parametrize("shape", [(2, 14, 40, 1280), (3, 7, 9, 64), (28, 40, 64, 320),
                                   (8, 5, 8, 2560)])
def test_group_norm_fold_kernel(rn, shape):
    """The fold's one launch: the statistics partials against their plain
    version slot by slot (1e-5 relative, f32 sums in another order), the
    fold against the plain fold and fold_from_partials against the plain
    fold of the slot sums (1e-4); two calls, fold_from_partials and three
    replays of a CUDA graph give the same bits, and leave the barriers'
    counters at zero."""
    x = rn(*shape) * 2 + 0.5
    c = shape[-1]
    rows = x.numel() // (shape[0] * c)
    scale, bias = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
    full = gn.fold_with_partials(x, scale, bias, groups=32, eps=1e-5)
    for got, r in zip((full.psum, full.psq), gn.channel_stats_reference(x.reshape(-1, c), rows)):
        assert ((got - r).abs().max() / r.abs().max()).item() <= 1e-5
    n = gn.group_norm_fold.launches
    got = gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
    assert gn.group_norm_fold.launches == n + 1
    again = gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, (full.sc, full.sh)))
    want = gn.group_norm_fold_reference(x, scale, bias, groups=32, eps=1e-5)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
    n = gn.fold_from_partials.launches
    parts = gn.fold_from_partials(full.psum, full.psq, rows, scale, bias, 32, 1e-5)
    assert gn.fold_from_partials.launches == n + 1
    assert all(torch.equal(a, b) for a, b in zip(got, parts))
    want = gn.fold_from_channel_sums(full.psum.sum(1), full.psq.sum(1), rows, scale, bias, 32,
                                     1e-5)
    for g_, w_ in zip(parts, want):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, got))
    torch.cuda.synchronize()
    assert not any(ws.any() for ws in gn._barriers.values())   # the barriers' counters at 0


def test_group_norm_fold_two_parts(rn):
    """The two-part form (the up blocks' concat, never built) against the
    plain fold of the concat, a group straddling the parts (C1 = 200)."""
    x, x2 = rn(4, 6, 10, 200) * 2 + 0.5, rn(4, 6, 10, 120) - 0.5
    scale, bias = 1 + 0.1 * rn(320).float(), 0.1 * rn(320).float()
    got = gn.group_norm_fold(x, scale, bias, x2, groups=32, eps=1e-5)
    want = gn.group_norm_fold_reference(torch.cat([x, x2], -1), scale, bias, groups=32, eps=1e-5)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)


def test_affine_silu_prologue(rn):
    """The prologue pass alone against the plain activation."""
    x = rn(2, 3, 50, 128) * 2
    sc, sh = (1 + 0.1 * rn(2, 128).float()) / 2, 0.1 * rn(2, 128).float()
    _assert_close_bf16(tr.affine_silu(x, sc, sh), tr._activate(x, sc, sh))


@pytest.mark.parametrize("shape,silu", [((3, 7, 9, 64), True), ((2, 100, 320), False)])
def test_group_norm_kernel(rn, shape, silu):
    x = rn(*shape) * 3 + 1
    c = shape[-1]
    w, b = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
    got = gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=silu)
    _assert_close_bf16(got, gn.group_norm_silu_reference(x, w, b, 32, 1e-6, silu))


FRAME_COUNTS = [1, 2, 8, 14, 16, 17, 25, 32]


@pytest.mark.parametrize("heads", [1, 5, 20])
@pytest.mark.parametrize("s", [7, 40, 50, 160])
@pytest.mark.parametrize("f", FRAME_COUNTS)
def test_frame_attention_geometry(rn, f, s, heads):
    """Both token-tile heights (16 and 32 frames), token tails (S not a
    multiple of the 8 tokens a stage) and one to 20 heads: within 4 bf16
    ulps of the plain version, one launch, two runs the same bits."""
    q, k, v = (rn(2, f, s, heads * 64) for _ in range(3))
    n = ta.frame_attention.launches
    got = ta.frame_attention(q, k, v, num_heads=heads, scale=0.125)
    assert ta.frame_attention.launches == n + 1
    _assert_close_bf16(got, ta.frame_attention_reference(q, k, v, num_heads=heads,
                                                         scale=0.125))
    assert torch.equal(got, ta.frame_attention(q, k, v, num_heads=heads, scale=0.125))


@pytest.mark.parametrize("f", [2, 14, 17, 32])
def test_frame_attention_large_logits(rn, f):
    """Logits out to about ±30 (q and k scaled by 3): the softmax's max and
    exp2 in f32 keep the kernel within 4 bf16 ulps."""
    q, k, v = rn(2, f, 40, 320, sc=3.0), rn(2, f, 40, 320, sc=3.0), rn(2, f, 40, 320)
    logits = torch.einsum("bfshd,bgshd->bshfg", *(a.float().view(2, f, 40, 5, 64)
                                                  for a in (q, k))) * 0.125
    assert logits.abs().max().item() >= 25
    got = ta.frame_attention(q, k, v, num_heads=5, scale=0.125)
    _assert_close_bf16(got, ta.frame_attention_reference(q, k, v, num_heads=5, scale=0.125))


def _gn_check(rn, shape, silu, dtype=torch.bfloat16, path=None):
    """group_norm_silu on x*3 + 1 against its plain version (4 bf16 ulps of
    the output's scale), on the path `path` where given; one launch, two
    runs the same bits."""
    x = (rn(*shape).float() * 3 + 1).to(dtype)
    c = shape[-1]
    w, b = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
    if path is not None:
        assert gn.group_norm_plan(shape, dtype, 32).path == path
    n = gn.group_norm_silu.launches
    got = gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=silu)
    assert gn.group_norm_silu.launches == n + 1
    assert got.dtype == dtype
    _assert_close_bf16(got, gn.group_norm_silu_reference(x, w, b, 32, 1e-6, silu))
    assert torch.equal(got, gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=silu))


@pytest.mark.parametrize("shape,silu", [((2, 2560, 320), False), ((2, 640, 640), False),
                                        ((2, 160, 1280), False), ((2, 40, 1280), False),
                                        ((2, 40, 64, 320), True)])
def test_group_norm_unet_sites(rn, shape, silu):
    """Every UNet site's sample (two samples of it) on the cluster kernel."""
    _gn_check(rn, shape, silu, path="cluster")


def test_group_norm_cluster_limit(rn):
    """The largest sample the cluster path takes at C = 320, and the next
    row, which the two passes take: both right."""
    rows = 8
    while gn.cluster_smem(rows // 8 + 1, 320, 2) <= gn.SMEM_LIMIT:
        rows += 8
    _gn_check(rn, (2, rows, 320), True, path="cluster")
    _gn_check(rn, (2, rows + 1, 320), True, path="two_pass")


@pytest.mark.parametrize("shape,silu", [((2, 20480, 128), True), ((1, 40, 64, 512), False),
                                        ((2, 2560, 512), True)])
def test_group_norm_two_pass(rn, shape, silu):
    """The VAE's samples (its decoder's full-resolution rows cut to 20480)
    on the two-pass path."""
    _gn_check(rn, shape, silu, path="two_pass")


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("c", [64, 128, 320, 512, 640, 1280])
def test_group_norm_channels(rn, c, silu):
    _gn_check(rn, (3, 300, c), silu)


@pytest.mark.parametrize("rows", [300, 30000])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_group_norm_dtypes(rn, dtype, rows):
    """fp16 and f32 on both paths (30000 rows of 320 do not fit the cluster)."""
    path = "cluster" if rows == 300 else "two_pass"
    _gn_check(rn, (2, rows, 320), True, dtype, path=path)


def test_group_norm_refused_cluster_launch_raises(rn, monkeypatch):
    """A cluster launch the kernel refuses (here a plan whose rows overflow
    a CTA's shared memory) raises; it does not fall back to the two passes."""
    x = rn(2, 4096, 320)
    monkeypatch.setattr(gn, "group_norm_plan",
                        lambda *a: gn.GroupNormPlan("cluster", 512, gn.SMEM_LIMIT + 1))
    with pytest.raises(RuntimeError, match="cluster"):
        gn.group_norm_silu(x, torch.ones(320, device="cuda"), torch.zeros(320, device="cuda"),
                           groups=32, eps=1e-6, silu=False)


def test_wrappers_raise_on_untaken_shapes(rn):
    with pytest.raises(ValueError):
        tr.temporal_resnet_block(rn(1, 2, 5, 96), rn(1, 2, 96), rn(3, 96, 96), rn(96),
                                 rn(3, 96, 96), rn(96), rn(96), rn(96), rn(96), rn(96),
                                 torch.tensor(0.5, device="cuda"))
    with pytest.raises(ValueError):
        fa.flash_attention_packed(rn(1, 8, 96), rn(1, 8, 96), rn(1, 8, 96), num_heads=2,
                                  scale=0.1)
    with pytest.raises(ValueError):
        ta.frame_attention(*(rn(1, 33, 4, 64) for _ in range(3)), num_heads=1, scale=0.1)


# ------------------------------------------------- kernels inside autograd --

def _grads(fn, inputs, dout):
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, leaves, dout)


def _geglu_args(rn, t, c):
    return [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
            0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]


def _tresnet_args(rn, f, s, c):
    return [rn(2, f, s, c), rn(2, f, c), rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1),
            rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1), 1 + 0.1 * rn(c), 0.1 * rn(c),
            1 + 0.1 * rn(c), 0.1 * rn(c), torch.tensor(0.37, device="cuda")]


def _kernel_cases(rn):
    """(name, kernel call, plain call, inputs) of every kernel Function whose
    backward is its plain version's."""
    return [
        ("frame_attention",
         lambda q, k, v: ta.frame_attention(q, k, v, num_heads=2, scale=0.125),
         lambda q, k, v: ta.frame_attention_reference(q, k, v, num_heads=2, scale=0.125),
         [rn(2, 14, 40, 128) for _ in range(3)]),
        ("temporal_resnet_block",
         lambda *a: tr.temporal_resnet_block(*a, groups=32, eps=1e-5),
         lambda *a: tr.temporal_resnet_reference(*a, 32, 1e-5),
         _tresnet_args(rn, 14, 40, 320)),
        ("group_norm_silu",
         lambda x, w, b: gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=True),
         lambda x, w, b: gn.group_norm_silu_reference(x, w, b, 32, 1e-6, True),
         [rn(4, 40, 64, 320) * 3 + 1, 1 + 0.1 * rn(320), 0.1 * rn(320)]),
        ("ln_geglu_residual", gg.ln_geglu_residual, gg.ln_geglu_residual_reference,
         _geglu_args(rn, 300, 320)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_kernel_function_gradients_match_plain(rn, case):
    """Forward through the kernel, backward through the plain version: the
    gradients equal autograd's of the plain version on the same inputs (the
    same recompute, so the bound is the bf16 one of the forward)."""
    name, kernel, plain, inputs = _kernel_cases(rn)[case]
    ref_out = plain(*inputs)
    dout = torch.randn(ref_out.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(ref_out.dtype)
    out, got = _grads(kernel, inputs, dout)
    _, ref = _grads(plain, inputs, dout)
    _assert_close_bf16(out, ref_out)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g is not None and g.shape == inputs[i].shape, (name, i)
        _assert_close_bf16(g, r)


def _flash_grad_errors(rn, b, s, heads, t=None):
    """Max-abs error against the f32 plain gradient of (the kernels' dq, dk,
    dv) and (the bf16 plain version's), per input; `t` keys (s by default)."""
    t = s if t is None else t
    q, k, v = rn(b, s, heads * 64), rn(b, t, heads * 64), rn(b, t, heads * 64)
    do = rn(b, s, heads * 64)
    run = lambda q, k, v: fa.flash_attention_packed(q, k, v, num_heads=heads, scale=0.125)
    plain = lambda q, k, v: fa.flash_attention_packed_reference(q, k, v, num_heads=heads,
                                                                scale=0.125)
    _, got = _grads(run, (q, k, v), do)
    _, bf = _grads(plain, (q, k, v), do)
    _, f32 = _grads(plain, (q.float(), k.float(), v.float()), do.float())
    torch.cuda.synchronize()
    err = lambda a, r: (a.float() - r).abs().max().item()
    return [(err(g, r), err(p, r), bool(torch.isfinite(g).all()))
            for g, p, r in zip(got, bf, f32)]


# where the bf16 plain gradient is exact (S = 1: the softmax is constant, so
# dQ = dK = 0 and dV = dO), the kernels' dS = P (dP - delta) is the f32
# rounding of two 64-term sums taken in other orders, ~1e-6 at these
# scales; a bf16 ulp of a unit gradient is 3.9e-3
EXACT_PLAIN_FLOOR = 1e-4


@pytest.mark.parametrize("b,s,heads", [(3, 40, 2), (2, 160, 2), (1, 2560, 1), (2, 200, 5),
                                       (1, 1, 5), (2, 640, 10)])
def test_flash_backward_kernels_against_plain(rn, b, s, heads):
    """dQ/dK/dV of the kernels at ragged (40, 160, 200, 1) and full (640,
    2560) lengths, the last four not multiples of the kernels' 128-row
    blocks or at the real head counts: the kernels' error against the f32
    plain gradient is finite and at most 1.5x the bf16 plain version's (or
    within EXACT_PLAIN_FLOOR where that one is exact)."""
    n_dq, n_dkv = fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches
    for kernel_err, plain_err, finite in _flash_grad_errors(rn, b, s, heads):
        bound = 1.5 * plain_err if plain_err > 0 else EXACT_PLAIN_FLOOR
        assert finite and kernel_err <= bound, (kernel_err, plain_err)
    assert fa.flash_attention_bwd_dq.launches == n_dq + 1
    assert fa.flash_attention_bwd_dkv.launches == n_dkv + 1


@pytest.mark.parametrize("b,s,heads", [(2, 200, 5), (2, 640, 10)])
def test_flash_backward_is_deterministic(rn, b, s, heads):
    """Two calls of each backward kernel on the same inputs give the same
    bits: every output tile has one owner, no atomics."""
    q, k, v, do = (rn(b, s, heads * 64) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, heads, 0.125)
    delta = fa.attention_delta(o, do, heads)
    runs = [(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, heads, 0.125),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, heads, 0.125))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.parametrize("batch,rows,heads,sample,row0,head",
                         [(1, 64, 1, 0, 0, 0), (2, 100, 3, 1, 64, 2), (3, 40, 5, 2, 0, 4)])
def test_sm90_wgmma_forms(rn, batch, rows, heads, sample, row0, head):
    """csrc/sm90.cuh on the card: a 3-D TMA box of one head (rows past the
    sample's end zero), read by wgmma as a K-major and an MN-major operand,
    with A in registers or in shared memory, and an accumulator re-packed as
    A fragments, against the same f32 products of the zero-padded tiles."""
    from svd_xtend_tpu_torch.ops.kernels._build import library

    a, b = rn(batch, rows, heads * 64), rn(batch, rows, heads * 64)
    out = torch.empty(4, 64, 64, device="cuda")
    err = library().svdx_sm90_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch,
                                       rows, heads * 64, sample, row0, head,
                                       torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()

    def tile(x):
        t = torch.zeros(64, 64, device="cuda")
        part = x[sample, row0:row0 + 64, head * 64:(head + 1) * 64].float()
        t[:part.shape[0]] = part
        return t

    a_tile, b_tile = tile(a), tile(b)
    abt = a_tile @ b_tile.T
    want = [abt, a_tile @ b_tile, abt, abt.to(torch.bfloat16).float() @ b_tile]
    for got, ref in zip(out, want):
        # f32 sums of the same exact bf16 products, in another order
        torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-4)


def test_sm90_tensor_map_refuses_misaligned(rn):
    """The tensor-map encoder refuses a base that is not 16-byte aligned: the
    C entry points return the error without launching."""
    from svd_xtend_tpu_torch.ops.kernels._build import library

    lib, stream = library(), torch.cuda.current_stream().cuda_stream
    x = rn(1, 64, 128)
    out = torch.zeros(4, 64, 64, device="cuda")
    assert lib.svdx_sm90_selftest(x.data_ptr() + 2, x.data_ptr(), out.data_ptr(), 1, 64, 128,
                                  0, 0, 0, stream) != 0
    lse = torch.zeros(1, 2, 64, device="cuda")
    dq = torch.zeros_like(x)
    n = fa.flash_attention_bwd_dq.launches
    assert lib.svdx_flash_attention_bwd_dq(
        x.data_ptr(), x.data_ptr() + 2, x.data_ptr(), x.data_ptr(), lse.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), 1, 64, 64, 2, 0.125, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 0).all()) and bool((dq == 0).all())
    assert fa.flash_attention_bwd_dq.launches == n


@pytest.mark.parametrize("s", [40, 160, 2560])
def test_flash_forward_lse(rn, s):
    q, k, v = rn(2, s, 128), rn(2, s, 128), rn(2, s, 128)
    o, lse = fa.flash_attention_fwd(q, k, v, 2, 0.125)
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, 2, 0.125)
    _assert_close_bf16(o, ref_o)
    assert lse.shape == (2, 2, s) and lse.dtype == torch.float32
    # f32 log-sum-exp of the same f32 scores, summed in another order
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


def _check_forward(o, lse, ref_o, ref_lse):
    """Output within 4 bf16 ulps of its scale; the LSE within 1e-4 (f32
    log-sum-exp of the same f32 scores, summed in another order)."""
    _assert_close_bf16(o, ref_o)
    assert bool(torch.isfinite(lse).all())
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s,heads", [(2560, 5), (640, 10), (160, 20), (40, 20)])
def test_flash_forward_unet_levels(rn, s, heads):
    """The forward with its LSE at the four UNet levels' (tokens, heads), at
    batch 2: at 160 and 40 tokens one 128-row block holds the last rows and
    one 128-key stage the last keys."""
    q, k, v = (rn(2, s, heads * 64) for _ in range(3))
    _check_forward(*fa.flash_attention_fwd(q, k, v, heads, 0.125),
                   *fa.flash_attention_fwd_reference(q, k, v, heads, 0.125))


@pytest.mark.parametrize("s,t", [(200, 136), (130, 40), (40, 17), (257, 64), (100, 300),
                                 (1, 129), (129, 1), (64, 300), (65, 200)])
def test_flash_forward_ragged_lengths(rn, s, t):
    """s_q != s_kv: keys shorter than one 64-key sub-tile (40, 17, 1), not a
    multiple of it (136, 129, 300) or exactly one (64); queries past S in the
    last 128-row block (200, 130, 257, 1, 129, 65); at most 64 queries (40, 1,
    64: the one-warpgroup block, 300 keys turning its 2-stage ring)."""
    q, k, v = rn(2, s, 128), rn(2, t, 128), rn(2, t, 128)
    _check_forward(*fa.flash_attention_fwd(q, k, v, 2, 0.125),
                   *fa.flash_attention_fwd_reference(q, k, v, 2, 0.125))


@pytest.mark.parametrize("b,s,heads", [(20, 40, 20), (2, 640, 10), (8, 1152, 5),
                                       (16, 1100, 5)])
def test_flash_forward_block_shapes(rn, b, s, heads):
    """Shapes at which the launcher's estimate picks each block shape on a
    132-SM H100: one consumer warpgroup (two blocks an SM), two, and three
    (192-row items: the last of 1152 queries full, of 1100 with 140 rows)."""
    q, k, v = (rn(b, s, heads * 64) for _ in range(3))
    _check_forward(*fa.flash_attention_fwd(q, k, v, heads, 0.125),
                   *fa.flash_attention_fwd_reference(q, k, v, heads, 0.125))


@pytest.mark.parametrize("b,s,t", [(3, 200, 136), (5, 40, 40), (3, 640, 640)])
def test_flash_forward_sample_boundaries(rn, b, s, t):
    """B >= 3 with ragged ends: each sample's output and LSE are the bits of
    that sample alone (no tile reads keys of, or writes rows into, a
    neighbouring sample), and match the plain version."""
    q, k, v = rn(b, s, 192), rn(b, t, 192), rn(b, t, 192)
    o, lse = fa.flash_attention_fwd(q, k, v, 3, 0.125)
    _check_forward(o, lse, *fa.flash_attention_fwd_reference(q, k, v, 3, 0.125))
    for i in range(b):
        oi, li = fa.flash_attention_fwd(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                        v[i:i + 1].contiguous(), 3, 0.125)
        torch.cuda.synchronize()
        assert torch.equal(oi[0], o[i]) and torch.equal(li[0], lse[i])


@pytest.mark.parametrize("b,s,heads", [(2, 200, 5), (2, 2560, 5)])
def test_flash_forward_is_deterministic(rn, b, s, heads):
    """Two calls of the forward on the same inputs give the same bits."""
    q, k, v = (rn(b, s, heads * 64) for _ in range(3))
    runs = [fa.flash_attention_fwd(q, k, v, heads, 0.125) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_flash_forward_refuses_non_positive_scale(rn):
    """The kernel takes the row maximum on the raw scores and folds the
    scale into the exponent, so it takes only scale > 0: the wrapper raises,
    and the C entry point returns an error without launching."""
    from svd_xtend_tpu_torch.ops.kernels._build import library

    q = rn(1, 64, 128)
    n = fa.flash_attention_packed.launches
    for scale in (0.0, -0.125):
        with pytest.raises(ValueError):
            fa.flash_attention_packed(q, q, q, num_heads=2, scale=scale)
    o = torch.zeros_like(q)
    assert library().svdx_flash_attention_fwd(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), None, 1, 64, 64, 2, -0.125,
        torch.cuda.current_stream().cuda_stream) != 0
    torch.cuda.synchronize()
    assert bool((o == 0).all()) and fa.flash_attention_packed.launches == n


@pytest.mark.parametrize("t,c", [(35840, 320), (8960, 640), (2240, 1280), (560, 1280),
                                 (100, 320), (37, 64)])
def test_geglu_kernel(rn, t, c):
    """The four UNet sites at training batch 1 (T x C), and a ragged T."""
    args = _geglu_args(rn, t, c)
    n = gg.ln_geglu_residual.launches
    got = gg.ln_geglu_residual(*args)
    assert gg.ln_geglu_residual.launches == n + 1
    _assert_close_bf16(got - args[0], gg.ln_geglu_residual_reference(*args) - args[0])
    _assert_close_bf16(got, gg.ln_geglu_residual_reference(*args))


@pytest.mark.parametrize("t,c", sites.GEGLU_SHAPES[4:] + [(130, 320), (1000, 640),
                                                           (130, 64), (1000, 64)])
def test_geglu_kernel_serving_and_ragged(rn, t, c):
    """generate's CFG shapes (2T), ragged T and C = 64, on their plans."""
    args = _geglu_args(rn, t, c)
    got = gg.ln_geglu_residual(*args)
    _assert_close_bf16(got - args[0], gg.ln_geglu_residual_reference(*args) - args[0])
    _assert_close_bf16(got, gg.ln_geglu_residual_reference(*args))


@pytest.mark.parametrize("t,c,inner", [(71680, 320, 640), (17920, 640, 1280),
                                       (4480, 1280, 2560), (1120, 1280, 2560),
                                       (35840, 320, 320), (2240, 1280, 192), (130, 64, 64),
                                       (1000, 64, 128)])
def test_geglu_partial_kernel(rn, t, c, inner):
    """The partial form (a model rank's inner columns, no b2, no residual) at
    the shard shapes of a model axis of 2 (inner 2C), of 4 (320: a width
    that is not a whole number of 128-column tiles of u) and an uneven
    split of 8 (192), and small C; the whole form's K split at the 5x8
    level."""
    args = [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(2 * inner, c, sc=c ** -0.5),
            0.1 * rn(2 * inner), rn(c, inner, sc=inner ** -0.5)]
    n = gg.ln_geglu_partial.launches
    got = gg.ln_geglu_partial(*args)
    assert gg.ln_geglu_partial.launches == n + 1
    _assert_close_bf16(got, gg.ln_geglu_partial_reference(*args))
    assert torch.equal(got, gg.ln_geglu_partial(*args))


def test_geglu_partial_wrapper_raises_on_untaken_shapes(rn):
    args = [rn(10, 64), 1 + 0.1 * rn(64), 0.1 * rn(64), rn(2 * 96, 64), 0.1 * rn(2 * 96),
            rn(64, 96)]
    with pytest.raises(ValueError):
        gg.ln_geglu_partial(*args)          # inner 96: not a multiple of 64


@pytest.mark.parametrize("shape", [(71680, 320, 320), (4480, 1280, 640), (130, 2560, 1280)])
def test_int8_dense_sums(rn, shape):
    """The int8 GEMM's raw form (the row-parallel product's int32 sums):
    bit for bit the plain version's exact sums."""
    rows, k, co = shape
    xq, _ = iq.quantize(rn(rows, k))
    wq, _ = ig.dense_codes(rn(co, k, sc=k ** -0.5))
    n = ig.int8_dense.launches
    got = ig.dense_sums(xq, wq)
    assert ig.int8_dense.launches == n + 1 and got.dtype == torch.int32
    _same_bits(got, qt.dense_accumulate(xq.cpu(), wq.cpu()).to(got.device))


# (first GEMM's bn; second's bn, k_slices)
_GEGLU_TILES = [(256, 128, 1), (256, 128, 3), (256, 160, 1), (256, 160, 2), (256, 160, 4)]


@pytest.mark.parametrize("tiles", _GEGLU_TILES, ids=lambda t: "-".join(map(str, t)))
def test_geglu_every_tile(rn, tiles):
    """Both GEMMs at each tile width and split a plan may pick, at a ragged
    T; on fewer persistent blocks, the same bits."""
    bn1, bn2, ks2 = tiles
    t, c = 300, 320
    args = _geglu_args(rn, t, c)
    first = GemmPlan(t, 8 * c, c // 64, bn1, 1, 7)
    second = GemmPlan(t, c, 4 * c // 64, bn2, ks2, 3)
    got = gg._launch(*args, plans=(first, second))
    again = gg._launch(*args, plans=(first, dataclasses.replace(second, grid=1)))
    _assert_close_bf16(got - args[0], gg.ln_geglu_residual_reference(*args) - args[0])
    assert torch.equal(got, again)


def test_geglu_packs_w1_once_per_version(rn):
    """The packed W1 is reused while the weight is unchanged and made again
    after an in-place update."""
    args = _geglu_args(rn, 200, 64)
    w1 = args[3]
    first = gg.packed_w1(w1)
    assert gg.packed_w1(w1) is first
    got = gg.ln_geglu_residual(*args)
    w1.mul_(0.5)
    assert gg.packed_w1(w1) is not first
    halved = gg.ln_geglu_residual(*args)
    _assert_close_bf16(halved - args[0], gg.ln_geglu_residual_reference(*args) - args[0])
    assert not torch.equal(got, halved)


def test_geglu_wrapper_raises_on_untaken_shapes(rn):
    with pytest.raises(ValueError):
        gg.ln_geglu_residual(*_geglu_args(rn, 10, 96))


# ------------------------------------------------------------------ conv3x3 --

@pytest.fixture
def no_tf32(monkeypatch):
    """The plain versions' f32 convs in full f32 (cuDNN defaults to TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _conv_args(rn, n, h, w, ci, co, pre, silu, post, res):
    x = rn(n, h, w, ci) * 2 + 0.5
    weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5)
    kw = dict(pre_silu=silu)
    if pre:
        kw.update(pre_scale=(1 + 0.2 * rn(n, ci)).float() / 2, pre_shift=0.3 * rn(n, ci).float())
    if post:
        kw["post_shift"] = 0.5 * rn(n, co).float()
    if res:
        kw["residual"] = rn(n, h, w, co)
    return x, weight, 0.1 * rn(co), kw


# (pre, silu, post, res): none, pre, preS, preS+post, preS+res, post+res
_EPILOGUES = [(False, False, False, False), (True, False, False, False),
              (True, True, False, False), (True, True, True, False),
              (True, True, False, True), (False, False, True, True)]


@pytest.mark.parametrize("epi", range(6))
@pytest.mark.parametrize("shape", [(14, 40, 64, 320, 320), (2, 10, 16, 640, 1280),
                                   (4, 5, 8, 2560, 1280), (100, 9, 13, 64, 320),
                                   (2, 9, 5, 8, 40), (14, 40, 64, 8, 320)])
def test_conv3x3_kernel(rn, no_tf32, shape, epi):
    """With each epilogue, on its plan: the UNet's L0 resnet shape at
    training batch, its L2 and L3 shapes at small batch (K split), a W that
    is not a multiple of 64 with Co 320, and Ci 8 (the mma.sync mainloop)
    with a ragged tile (Co 40) and at the conv_in width."""
    x, weight, bias, kw = _conv_args(rn, *shape, *_EPILOGUES[epi])
    n = cv.conv3x3.launches
    got = cv.conv3x3(x, weight, bias, **kw)
    assert cv.conv3x3.launches == n + 1
    ref = cv.conv3x3_fused_reference(x, weight, bias, kw.get("pre_scale"), kw.get("pre_shift"),
                                     kw.get("post_shift"), kw.get("residual"), kw["pre_silu"])
    _assert_close_bf16(got, ref)


@pytest.mark.parametrize("shape", [(2, 20, 32, 64, 128), (3, 5, 8, 320, 640)])
def test_conv3x3_gradients_against_plain(rn, no_tf32, shape):
    """The Function's gradients (dU through the kernel, dW through cuDNN)
    against the f32 plain gradient: finite, and each at most 1.5x the max-abs
    error of the bf16 plain version's gradient on the same inputs."""
    x, weight, bias, kw = _conv_args(rn, *shape, True, True, True, True)
    names = ("pre_scale", "pre_shift", "post_shift", "residual")
    inputs = [x, weight, bias] + [kw[a] for a in names]
    run = lambda x, w, b, sc, sh, post, res: cv.conv3x3(
        x, w, b, pre_scale=sc, pre_shift=sh, pre_silu=True, post_shift=post, residual=res)
    plain = lambda *a: cv.conv3x3_fused_reference(*a, True)
    dy = rn(*shape[:3], shape[4])
    n = cv.conv3x3_input_grad.launches
    _, got = _grads(run, inputs, dy)
    assert cv.conv3x3_input_grad.launches == n + 1
    _, bf = _grads(plain, inputs, dy)
    _, f32 = _grads(plain, [a.float() for a in inputs], dy.float())
    torch.cuda.synchronize()
    for i, (g, p, r) in enumerate(zip(got, bf, f32)):
        err, perr = ((a.float() - r).abs().max().item() for a in (g, p))
        assert bool(torch.isfinite(g).all()) and err <= 1.5 * perr, (i, err, perr)


def test_conv3x3_wrapper_raises_on_untaken_calls(rn):
    with pytest.raises(ValueError):                 # Ci 12: not a multiple of 8
        cv.conv3x3(rn(1, 4, 4, 12), rn(16, 12, 3, 3), rn(16))
    with pytest.raises(ValueError):                 # f32 activations
        cv.conv3x3(rn(1, 4, 4, 16).float(), rn(16, 16, 3, 3), rn(16))
    with pytest.raises(ValueError):                 # residual of the wrong width
        cv.conv3x3(rn(1, 4, 4, 16), rn(16, 16, 3, 3), rn(16), residual=rn(1, 4, 4, 8))


# every distinct (H, W, Ci, Co, epilogue) of the site tables; batch 3 at
# the 5x8 and 10x16 levels, where a 128-row tile spans samples, else 1
_CONV_SITES = sorted({st[:5] for st in sites.UNET_CONV_SITES + sites.VAE_DECODE_SITES
                      + sites.VAE_ENCODE_SITES})
_EPI_FLAGS = {"none": (False, False, False, False), "preS": (True, True, False, False),
              "preS+post": (True, True, True, False), "preS+res": (True, True, False, True)}


def _site_batch(h):
    return 3 if h <= 10 else 1


@pytest.mark.parametrize("site", _CONV_SITES, ids=lambda st: "-".join(map(str, st)))
def test_conv3x3_sites(rn, no_tf32, site):
    """The kernel on its plan at every forward site of the UNet and VAE."""
    h, w, ci, co, epi = site
    x, weight, bias, kw = _conv_args(rn, _site_batch(h), h, w, ci, co, *_EPI_FLAGS[epi])
    got = cv.conv3x3(x, weight, bias, **kw)
    ref = cv.conv3x3_fused_reference(x, weight, bias, kw.get("pre_scale"), kw.get("pre_shift"),
                                     kw.get("post_shift"), kw.get("residual"), kw["pre_silu"])
    _assert_close_bf16(got, ref)


@pytest.mark.parametrize("site", sorted({st[:4] for st in sites.UNET_DGRAD_SITES})
                         + [(40, 64, 320, 8), (40, 64, 8, 512)],
                         ids=lambda st: "-".join(map(str, st)))
def test_conv3x3_input_grad_sites(rn, no_tf32, site):
    """dU at every shape of the train step's backward (dy (H, W, Co) -> Ci),
    and the dU of the Ci 8 (conv_in) and Co 8 (VAE conv_out) convs."""
    h, w, co, ci = site
    dy = rn(_site_batch(h), h, w, co)
    weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5)
    n = cv.conv3x3_input_grad.launches
    got = cv.conv3x3_input_grad(dy, weight)
    assert cv.conv3x3_input_grad.launches == n + 1
    _assert_close_bf16(got, cv.conv3x3_input_grad_reference(dy, weight))


# (bn, k_slices): every tile the TMA mainloop instantiates, and splits
_CONV_TILES = [(8, 1), (8, 3), (128, 1), (128, 4), (160, 3), (160, 5), (256, 1), (256, 2)]


@pytest.mark.parametrize("tile", _CONV_TILES, ids=lambda t: "bn%d-ks%d" % t)
def test_conv3x3_every_tile(rn, no_tf32, tile):
    """The TMA mainloop at each tile width and K split a plan may pick, on a
    ragged shape (M and Co not multiples of the tile; tiles spanning
    samples), against the plain version; on fewer persistent blocks, the
    same bits."""
    bn, k_slices = tile
    co = 8 if bn == 8 else 200
    x, weight, bias, kw = _conv_args(rn, 3, 7, 9, 128, co, True, True, True, True)
    plan = GemmPlan(3 * 7 * 9, co, 18, bn, k_slices, 1)
    args = (x, weight, bias, kw["pre_scale"], kw["pre_shift"], kw["post_shift"],
            kw["residual"], True)
    got = cv._run(*args, plan=plan)
    again = cv._run(*args, plan=dataclasses.replace(plan, grid=min(plan.n_items, 5)))
    _assert_close_bf16(got, cv.conv3x3_fused_reference(*args))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(14, 5, 8, 2560, 1280), (28, 40, 64, 320, 320)])
def test_conv3x3_is_deterministic(rn, no_tf32, shape):
    """Two runs of the plan give the same bits (the 5x8 dU's split included)."""
    x, weight, bias, kw = _conv_args(rn, *shape, True, True, True, True)
    runs = [cv.conv3x3(x, weight, bias, **kw) for _ in range(2)]
    dys = [cv.conv3x3_input_grad(runs[0], weight) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs) and torch.equal(*dys)


def test_conv3x3_refuses_plans_it_does_not_take(rn):
    x, weight, bias, _ = _conv_args(rn, 1, 4, 4, 64, 64, False, False, False, False)
    for plan in (GemmPlan(16, 64, 9, 96, 1, 1), GemmPlan(16, 64, 9, 64, 1, 1),
                 GemmPlan(16, 64, 9, 128, 10, 1), GemmPlan(16, 64, 9, 128, 1, 0)):
        with pytest.raises(RuntimeError):
            cv._run(x, weight, bias, None, None, None, None, False, plan=plan)


@pytest.mark.parametrize("n", [8, 128, 160, 256])
def test_sm90_gemm_wide_forms(rn, n):
    """sm90_gemm.cuh's wgmma m64nNk16 forms on TMA tiles of a 2-D map against
    the same f32 products."""
    from svd_xtend_tpu_torch.ops.kernels._build import library

    a, b = rn(64, 64), rn(n, 64)
    out = torch.empty(64, n, device="cuda")
    assert library().svdx_sm90_gemm_selftest(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                             torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, a.float() @ b.float().T, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("s", [40, 2560])
def test_flash_attention_bshd_kernel(rn, s):
    """The head-major entry point on (B, S, H, 64): the forward kernel on the
    same memory, and its gradients through the dQ and dK/dV kernels."""
    q, k, v = (rn(2, s, 2, 64) for _ in range(3))
    plain = lambda q, k, v: fa.flash_attention_packed_reference(
        q.flatten(2), k.flatten(2), v.flatten(2), num_heads=2, scale=0.125).reshape(q.shape)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, scale=0.125)
    assert fa.flash_attention.launches == n + 1 and got.shape == q.shape
    _assert_close_bf16(got, plain(q, k, v))
    do = rn(2, s, 2, 64)
    _, g = _grads(lambda q, k, v: fa.flash_attention(q, k, v, scale=0.125), (q, k, v), do)
    _, bf = _grads(plain, (q, k, v), do)
    _, f32 = _grads(plain, (q.float(), k.float(), v.float()), do.float())
    for a, p, r in zip(g, bf, f32):
        err, perr = ((x.float() - r).abs().max().item() for x in (a, p))
        assert err <= 1.5 * perr, (err, perr)


# ------------------------------------------------------ the probes' kernels --


@pytest.mark.parametrize("mode", fv.MODES)
@pytest.mark.parametrize("bh,s,t", [(3, 256, 256), (2, 128, 384)])
def test_flash_variants_kernel(rn, mode, bh, s, t):
    """Each softmax organisation against the plain version, within 4 bf16
    ulps of the output's scale. nosoftmax divides by the row sum of the raw
    scores, which normal inputs can bring near 0: it gets positive inputs."""
    q, k, v = rn(bh, s, 64), rn(bh, t, 64), rn(bh, t, 64)
    if mode == "nosoftmax":
        q, k = ((torch.rand(a.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(i))).to(torch.bfloat16) for i, a in enumerate((q, k)))
    n = fv.flash_variants.launches
    got = fv.flash_variants(q, k, v, scale=0.125, mode=mode)
    assert fv.flash_variants.launches == n + 1
    _assert_close_bf16(got, fv.flash_variants_reference(q, k, v, 0.125, mode))


@pytest.mark.parametrize("mode", fv.MODES)
@pytest.mark.parametrize("s", [128, 384, 2560])
def test_flash_variants_ring_lengths(rn, mode, s):
    """An odd B·H at one 128-key stage (128), a ring not filled twice (384:
    three stages) and one turned many times (2560: 20 stages of 3 slots)."""
    bh = 3
    if mode == "nosoftmax":
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k = (torch.rand(bh, s, 64, device="cuda", generator=g).to(torch.bfloat16)
                for _ in range(2))
    else:
        q, k = rn(bh, s, 64), rn(bh, s, 64)
    v = rn(bh, s, 64)
    _assert_close_bf16(fv.flash_variants(q, k, v, scale=0.125, mode=mode),
                       fv.flash_variants_reference(q, k, v, 0.125, mode))


def test_flash_variants_wrapper_raises_on_untaken_calls(rn):
    with pytest.raises(ValueError):                 # S not a multiple of 128
        fv.flash_variants(rn(2, 200, 64), rn(2, 200, 64), rn(2, 200, 64), scale=0.1,
                          mode="base")
    with pytest.raises(ValueError):
        fv.flash_variants(rn(2, 128, 64), rn(2, 128, 64), rn(2, 128, 64), scale=0.1,
                          mode="exp3")


@pytest.mark.parametrize("s", [256, 640])
def test_flash_attention_headsliced(rn, s):
    """The probe's head-sliced entry point: out within 4 bf16 ulps, the f32
    (B, H, S) LSE within 1e-4 of logsumexp of the f32 scores."""
    q, k, v = rn(2, s, 128), rn(2, s, 128), rn(2, s, 128)
    n = fa.flash_attention_headsliced.launches
    o, lse = fa.flash_attention_headsliced(q, k, v, scale=0.125, num_heads=2)
    assert fa.flash_attention_headsliced.launches == n + 1
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, 2, 0.125)
    _assert_close_bf16(o, ref_o)
    assert lse.shape == (2, 2, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


def _chain_inputs(rn, bq, bkm):
    """The probe's recipe: normal bf16 q, kᵀ, v; int8 kᵀ and v = clip(round(20x))."""
    q, kT, v = rn(bq, 64), rn(64, bkm), rn(bkm, 64)
    to8 = lambda a: torch.clamp(torch.round(a.float() * 20), -127, 127).to(torch.int8)
    return q, kT, v, to8(kT), to8(v)


# (bq, bkm, cluster): the probe's tiles at every cluster size whose blocks
# hold their keys (fc.fits), and a small tile
_CHAIN_CASES = [(bq, bkm, k) for bq, bkm in [(128, 128), (640, 640), (1280, 1280), (1024, 1536)]
                for k in (1, 2, 4, 8) if fc.fits(bkm, k, True) and k <= bkm // 64]


@pytest.mark.parametrize("n_inner", [1, 2, 4])
@pytest.mark.parametrize("bq,bkm,cluster", _CHAIN_CASES)
def test_flash_chain_kernels(rn, n_inner, bq, bkm, cluster):
    """chain_bf16 within 4 bf16 ulps of the output's scale, against the plain
    chain and against the plain version of its key split (the kernel and the
    plain versions sum in another order, so a rounding of p or q may differ
    by one ulp); chain_int8_qd equal bit for bit under every split (int32
    sums, the same f32 roundings in the same order), its barrier workspace
    left at zero."""
    q, kT, v, kTi, vi = _chain_inputs(rn, bq, bkm)
    n8 = fc.chain_int8_qd.launches
    got = fc.chain_int8_qd(q, kTi, vi, n_inner, cluster)
    assert fc.chain_int8_qd.launches == n8 + 1
    ref = fc.chain_int8_qd_reference(q, kTi, vi, n_inner)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    assert not fc._workspace(q.device, torch.cuda.current_stream().cuda_stream).any()
    bf = fc.chain_bf16(q, kT, v, n_inner, cluster)
    _assert_close_bf16(bf, fc.chain_bf16_reference(q, kT, v, n_inner))
    _assert_close_bf16(bf, fc.chain_bf16_split_reference(q, kT, v, n_inner, cluster))


def test_flash_chain_wrappers_raise_on_untaken_calls(rn):
    q, kT, v, kTi, vi = _chain_inputs(rn, 128, 128)
    with pytest.raises(ValueError):                 # bq not a multiple of 64
        fc.chain_bf16(rn(100, 64), kT, v)
    with pytest.raises(ValueError):                 # bf16 kᵀ for the int8 chain
        fc.chain_int8_qd(q, kT, vi)
    q, kT, v, kTi, vi = _chain_inputs(rn, 128, 1536)
    with pytest.raises(ValueError):                 # 1536 keys' K and V in one block
        fc.chain_int8_qd(q, kTi, vi, 1, cluster=1)


# ------------------------------------------------------- cache-mode generate --

# a two-level UNet with 64-wide heads, so the flash, frame-attention and
# GEGLU kernels take its sites as well as conv3x3, GroupNorm and the
# temporal resnet
_CARD_UNET = dataclasses.replace(tcfg.TINY_UNET, block_out_channels=(64, 128),
                                 num_attention_heads=(1, 2), cross_attention_dim=64)
_CARD_CLIP = dataclasses.replace(tcfg.TINY_CLIP, projection_dim=64)


def test_cache_mode_generate_on_the_card(rn):
    """DeepCache + CFG cache (n2 k2, 4 steps: full pair, shallow cond-only,
    full pair, shallow cond-only) in bf16 with the kernels on, against the
    port's f32 generate on the host, same weights and noise. bf16 rounds
    every activation to 8 bits, so the bound is relative to the card's own
    bf16 plain path (the kernels off): the kernels' rel-L2 distance to the
    f32 video is at most 1.5x the plain path's, plus 1e-3."""
    g = torch.Generator().manual_seed(0)
    host = tpipe.SVDModels.create(_CARD_UNET, tcfg.TINY_VAE, _CARD_CLIP, device="cpu",
                                  generator=g)
    card = tpipe.SVDModels(*(copy.deepcopy(n).to("cuda", torch.bfloat16)
                             for n in (host.unet, host.vae, host.clip)), host.scheduler)
    cfg = tcfg.PipelineConfig(height=32, width=32, num_frames=3, num_inference_steps=4,
                              decode_chunk_size=2, deep_cache_interval=2,
                              uncond_reuse_interval=2)
    image = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    noise = dict(image_noise=torch.randn(1, 32, 32, 3, generator=g),
                 latent_noise=torch.randn(1, 3, 16, 16, 4, generator=g))
    ref = tpipe.generate(host, image, cfg, **noise)
    on_card = lambda: tpipe.generate(card, image.cuda(), cfg,
                                     **{k: v.cuda() for k, v in noise.items()}).cpu()
    counts = (cv.conv3x3, fa.flash_attention_packed, ta.frame_attention)
    before = [f.launches for f in counts]
    got = on_card()
    assert all(f.launches > n for f, n in zip(counts, before))
    with plain_versions():
        plain = on_card()
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert rel(got) <= 1.5 * rel(plain) + 1e-3, (rel(got), rel(plain))


# ------------------------------------------------------------------- LoRA --

def _lora_pair(g):
    """Host f32 models and their bf16 copy on the card, and an adapter on
    the host UNet with a seeded nonzero B (while B is zero, A's gradient is
    exactly zero)."""
    from svd_xtend_tpu_torch.models import lora

    host = tpipe.SVDModels.create(_CARD_UNET, tcfg.TINY_VAE, _CARD_CLIP, device="cpu",
                                  generator=g)
    card = tpipe.SVDModels(*(copy.deepcopy(n).to("cuda", torch.bfloat16)
                             for n in (host.unet, host.vae, host.clip)), host.scheduler)
    adapter = lora.init(host.unet, generator=g)
    for ab in adapter.values():
        ab["b"].normal_(0.0, 0.1, generator=g)
    return host, card, adapter


def test_lora_step_on_the_card(rn):
    """The LoRA gradient (remat "block") of the bf16 kernels and of the
    card's bf16 plain path against the host's f32: the kernels' rel-L2 at
    most 1.5x the plain path's, plus 1e-3; the flash backward launched; then
    one make_train_step on the card: finite metrics, B changed, every base
    weight bit-identical."""
    from svd_xtend_tpu_torch.diffusion import training as ttrain
    from svd_xtend_tpu_torch.train import state as tstate

    g = torch.Generator().manual_seed(0)
    host, card, adapter = _lora_pair(g)
    cfg = tcfg.TrainConfig(train_mode="lora", height=32, width=32, num_frames=3,
                           encode_chunk_size=2, learning_rate=1e-3)
    pixels = torch.rand(1, 3, 32, 32, 3, generator=g) * 2 - 1
    draws = ttrain.sample_train_draws(host, pixels.shape, cfg, g)

    def grads(models, device):
        st = tstate.create_train_state(cfg, models)
        with torch.no_grad():
            for name, ab in st.lora.items():
                ab["a"].copy_(adapter[name]["a"])
                ab["b"].copy_(adapter[name]["b"])
        _, g_ = tstate.loss_and_grads(models, cfg, st, pixels.to(device),
                                      ttrain.TrainDraws(*(d.to(device) for d in draws)))
        return torch.cat([x.float().flatten().cpu() for x in g_]), st

    ref, _ = grads(host, "cpu")
    n = fa.flash_attention_bwd_dq.launches
    got, st = grads(card, "cuda")
    assert fa.flash_attention_bwd_dq.launches > n
    with plain_versions():
        plain, _ = grads(card, "cuda")
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    assert bool(torch.isfinite(got).all())
    assert rel(got) <= 1.5 * rel(plain) + 1e-3, (rel(got), rel(plain))

    base = {k: v.clone() for net in (card.unet, card.vae, card.clip)
            for k, v in net.state_dict().items()}
    b0 = [ab["b"].clone() for ab in st.lora.values()]
    step = tstate.make_train_step(card, cfg)
    st, m = step(st, pixels.cuda(), generator=torch.Generator("cuda").manual_seed(2))
    assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
    assert any(not torch.equal(ab["b"], b) for ab, b in zip(st.lora.values(), b0))
    after = {k: v for net in (card.unet, card.vae, card.clip) for k, v in net.state_dict().items()}
    assert all(torch.equal(after[k], v) for k, v in base.items())


def test_lora_export_merge_and_generate_on_the_card(rn, tmp_path):
    """The adapter exported, read back bit for bit and merged into the card's
    bf16 UNet; its video against the host's f32 merged video, as the cache
    modes' test holds it (the kernels' rel-L2 at most 1.5x the plain path's,
    plus 1e-3)."""
    from svd_xtend_tpu_torch.io.convert import lora_from_state_dict
    from svd_xtend_tpu_torch.io.safetensors_io import load_file
    from svd_xtend_tpu_torch.models import lora
    from svd_xtend_tpu_torch.train.checkpoint import export_lora_diffusers

    g = torch.Generator().manual_seed(1)
    host, card, adapter = _lora_pair(g)
    on_card = {n: {k: t.cuda() for k, t in ab.items()} for n, ab in adapter.items()}
    path = export_lora_diffusers(on_card, str(tmp_path / "lora"))
    back = lora_from_state_dict(load_file(path), on_card)
    assert all(torch.equal(back[n][k], on_card[n][k]) for n in on_card for k in ("a", "b"))
    lora.merge_(card.unet, back)
    lora.merge_(host.unet, adapter)
    cfg = tcfg.PipelineConfig(height=32, width=32, num_frames=3, num_inference_steps=3,
                              decode_chunk_size=2)
    image = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    noise = dict(image_noise=torch.randn(1, 32, 32, 3, generator=g),
                 latent_noise=torch.randn(1, 3, 16, 16, 4, generator=g))
    ref = tpipe.generate(host, image, cfg, **noise)
    run = lambda: tpipe.generate(card, image.cuda(), cfg,
                                 **{k: v.cuda() for k, v in noise.items()}).cpu()
    n = fa.flash_attention_packed.launches
    got = run()
    assert fa.flash_attention_packed.launches > n
    with plain_versions():
        plain = run()
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert rel(got) <= 1.5 * rel(plain) + 1e-3, (rel(got), rel(plain))


# ------------------------------------------------- the training harness --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training harness on the card")
    return torch.device("cuda")


def test_native_loader_builds_into_the_build_directory(card):
    from svd_xtend_tpu_torch import native
    lib = native.library()
    assert lib._name.startswith(str(native.BUILD_DIR) + "/")
    assert native.decoder() in native.DECODERS
    print("native frame loader:", native.version())


def test_fixture_decode_matches_the_jax_loaders_output(card):
    """The committed window through the port's native loader against the
    JAX package's native output committed beside it: bit for bit, with
    either decoder (libjpeg, or the built-in one where libjpeg is absent)."""
    import numpy as np

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    ref = np.load(fx.REFERENCE)
    got = native.load_clip(fx.reference_paths(), fx.REF_WIDTH, fx.REF_HEIGHT)
    assert got is not None and got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    print(f"decoder {native.decoder()}: max abs error {err:.3g}")
    assert err == 0.0


def test_tiny_cli_resume_on_the_card_is_bit_equal(card, tmp_path):
    """The CLI on the card at the TINY configs over the committed frames: 4
    straight steps against checkpoint-2 resumed to 4, the state file's
    tensors and the data state bit for bit."""
    import json
    import os
    import shutil

    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.train import cli
    from svd_xtend_tpu_torch.train.checkpoint import STATE_FILE

    def argv(out, *extra):
        return ["--base_folder", fx.FRAMES, "--tiny_model", "--width", "64", "--height", "32",
                "--num_frames", "3", "--learning_rate", "1e-3", "--lr_warmup_steps", "0",
                "--output_dir", out, "--checkpointing_steps", "2", "--validation_steps", "4",
                "--num_inference_steps", "2", "--max_train_steps", "4", *extra]

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    cli.main(argv(a))
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "checkpoint-2"), os.path.join(b, "checkpoint-2"))
    cli.main(argv(b, "--resume_from_checkpoint", "latest"))
    sa, sb = (torch.load(os.path.join(d, "checkpoint-4", "state", STATE_FILE),
                         weights_only=True) for d in (a, b))
    assert sa["step"] == sb["step"] == 4 and sa["optimizer"]["count"] == 4
    for n, t in sa["params"].items():
        assert torch.equal(t, sb["params"][n]), n
    for i, s in sa["optimizer"]["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["optimizer"]["adamw"]["state"][i][k]), (i, k)
    for d in (a, b):
        with open(os.path.join(d, "checkpoint-4", "data_state.json")) as f:
            assert json.load(f)["step"] == 4


# --------------------------------------------------------- Tracklet2Video --

# the gated attention's flash calls: visual tokens S against S + 16 box
# tokens at the UNet's four levels of a 512x320 video (generate's CFG batch
# 28, the train step's 14), and at the L0 of a 1024x576 one
_GATED = [(s_q, s_kv, heads) for (s_q, s_kv), heads in zip(
    [k for k in sites.flash_calls_per_pass(320, 512, 16) if k[0] != k[1]], (5, 10, 20, 20))]


@pytest.mark.parametrize("b,s_q,s_kv,heads", [(b, *g) for g in _GATED for b in (28, 14)]
                         + [(28, 9216, 9232, 5)])
def test_flash_forward_gated_attention_shapes(rn, b, s_q, s_kv, heads):
    """The forward with a key count that is not a multiple of 64 (the last
    sub-tile holds 16 keys), at generate's batches 28 and 14 (the 1024x576
    L0 at 28): out on the first two sequences within 4 bf16 ulps of the
    plain version, the LSE within 1e-4 of logsumexp."""
    q, k, v = rn(b, s_q, heads * 64), rn(b, s_kv, heads * 64), rn(b, s_kv, heads * 64)
    o, lse = fa.flash_attention_fwd(q, k, v, heads, 0.125)
    ro, rlse = fa.flash_attention_fwd_reference(q[:2], k[:2], v[:2], heads, 0.125)
    _assert_close_bf16(o[:2], ro)
    assert (lse[:2] - rlse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("s_q,s_kv,heads", _GATED)
def test_flash_backward_gated_attention_shapes(rn, s_q, s_kv, heads):
    """dQ/dK/dV at the gated attention's (S, S + 16) training shapes (batch
    14, cut to 2 sequences for the f32 plain reference): finite and at most
    1.5x the bf16 plain version's error against f32."""
    for kernel_err, plain_err, finite in _flash_grad_errors(rn, 2, s_q, heads, s_kv):
        assert finite and kernel_err <= 1.5 * plain_err, (kernel_err, plain_err)


def test_tracklet_unet_at_gate_zero_equals_the_plain_unet(card):
    """A TINY UNet with the Tracklet2Video branch at gate 0, given boxes, on
    the card: the output of the UNet without the branch, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(0)
    m = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cuda",
                               dtype=torch.bfloat16, generator=g)
    mt = m.with_tracklet(16, heads=2)
    x = torch.randn(2, 3, 8, 8, 8, device="cuda", generator=g)
    ehs = torch.randn(2, 1, tcfg.TINY_UNET.cross_attention_dim, device="cuda", generator=g)
    ids = torch.ones(2, 3, device="cuda")
    boxes = torch.rand(2, 3, 16, 4, device="cuda", generator=g)
    with torch.no_grad():
        plain = m.unet(x, 10.0, ehs, ids)
        got = mt.unet(x, 10.0, ehs, ids, boxes=boxes)
    assert torch.equal(got, plain)


def test_group_norm_at_1024x576_l0(rn):
    """The UNet's L0 GroupNorm sample at 1024x576 (72 x 128 x 320): the
    two-pass path."""
    _gn_check(rn, (2, 72, 128, 320), False, path="two_pass")


def test_conv3x3_at_1024x576_l0(rn, no_tf32):
    """conv3x3 at the UNet's L0 resnet site of a 1024x576 video."""
    x, weight, bias, kw = _conv_args(rn, 2, 72, 128, 320, 320, *_EPI_FLAGS["preS+res"])
    got = cv.conv3x3(x, weight, bias, **kw)
    ref = cv.conv3x3_fused_reference(x, weight, bias, kw.get("pre_scale"), kw.get("pre_shift"),
                                     kw.get("post_shift"), kw.get("residual"), kw["pre_silu"])
    _assert_close_bf16(got, ref)


# ----------------------------------------------- upsample and split concat --

def _upsample_args(rn, n, h, w, c, co=None):
    co = c if co is None else co
    return rn(n, h, w, c), rn(co, c, 3, 3, sc=(9 * c) ** -0.5), 0.1 * rn(co)


# the upsample's inputs (N, H, W, C) on the main paths at 512x320 and at
# 1024x576 (twice each spatial dimension), and generate's in portrait
_UPSAMPLE_SHAPES = sorted({st[:4] for st in sites.UPSAMPLE_SITES}
                          | {(n, 2 * h, 2 * w, c) for n, h, w, c, *_ in sites.UPSAMPLE_SITES}
                          | set(sites.PORTRAIT_UPSAMPLE_SHAPES))


@pytest.mark.parametrize("shape", _UPSAMPLE_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_upsample_kernel_sites(rn, no_tf32, shape):
    """The upsample kernel on its plan at every site of the UNet (CFG and
    training batch) and the VAE decoder (chunks of 8 and 6), at 512x320 and
    1024x576, and of generate at 320 and 576 wide (portrait 512x320 and
    1024x576: W 5-36 in the UNet, 40-288 in the VAE), against its plain
    version; one launch counted."""
    x, weight, bias = _upsample_args(rn, *shape)
    n = uc.upsample_conv.launches
    got = uc.upsample_conv(x, weight, bias)
    assert uc.upsample_conv.launches == n + 1
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    _assert_close_bf16(got, uc.upsample2x_conv3x3_reference(x, weight, bias))


@pytest.mark.parametrize("shape", [(3, 5, 8, 64, 64), (1, 3, 4, 128, 72), (2, 2, 128, 64, 200),
                                   (1, 7, 1, 64, 8), (5, 3, 16, 192, 136), (3, 4, 5, 64, 136),
                                   (2, 3, 9, 128, 64), (2, 5, 12, 64, 200), (1, 3, 100, 64, 64),
                                   (1, 2, 200, 64, 72)],
                         ids=["5x8-ragged-M", "W4-Co72", "W128", "W1", "Ci192-Co136", "W5",
                              "W9", "W12-Co200", "W100", "W200"])
def test_upsample_kernel_small_and_ragged(rn, no_tf32, shape):
    """Rows past the last sample in a parity's last tile (M not a multiple
    of 128), W of 1, 4 and 128, W that neither divides 64 nor is a
    multiple of it (5, 9, 12, 100, 200: several stores a warpgroup), Co not
    a multiple of the tile, against the plain version; also against the
    materialised form in f32 (nearest upsample, then the 3x3 SAME conv)
    within the bf16 bound."""
    import torch.nn.functional as F

    from svd_xtend_tpu_torch.ops import video
    x, weight, bias = _upsample_args(rn, *shape)
    got = uc.upsample_conv(x, weight, bias)
    _assert_close_bf16(got, uc.upsample2x_conv3x3_reference(x, weight, bias))
    up = F.interpolate(video.nchw(x.float()), scale_factor=2.0, mode="nearest")
    naive = video.nhwc(F.conv2d(up, weight.float(), bias.float(), padding=1))
    _assert_close_bf16(got, naive)


# (bn, k_slices): every tile width the source instantiates, and splits
_UPSAMPLE_TILES = [(128, 1), (128, 3), (160, 1), (160, 2), (256, 1), (256, 4)]


@pytest.mark.parametrize("w", [8, 5, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("tile", _UPSAMPLE_TILES, ids=lambda t: "bn%d-ks%d" % t)
def test_upsample_every_tile(rn, no_tf32, tile, w):
    """Each tile width and K split a plan may pick, on a ragged shape (M
    not a multiple of 128, Co not of the tile), at W 8 (one store a
    warpgroup), 5 and 12 (several), against the plain version; on fewer
    persistent blocks, the same bits. A tile width the store at W does not
    take (160 at an odd W) is refused."""
    bn, k_slices = tile
    x, weight, bias = _upsample_args(rn, 3, 5, w, 128, 200)
    m_pad = uc.padded_rows(3, 5, w)
    plan = GemmPlan(4 * m_pad, 200, 4 * 128 // 64, bn, k_slices, 1)
    plan = dataclasses.replace(plan, grid=min(plan.n_items, 132))
    if bn not in uc.tile_widths(w):
        with pytest.raises(RuntimeError):
            uc._launch(x, weight, bias, plan)
        return
    got = uc._launch(x, weight, bias, plan)
    again = uc._launch(x, weight, bias, dataclasses.replace(plan, grid=min(plan.n_items, 5)))
    _assert_close_bf16(got, uc.upsample2x_conv3x3_reference(x, weight, bias))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(3, 5, 8, 128), (2, 10, 16, 64)])
def test_upsample_gradients_and_refusals(rn, no_tf32, shape):
    """The explicit backward (dX through conv3x3's dU kernel, one launch;
    dW, db) against the f32 plain gradient, each within 1.5x the bf16 plain
    version's max-abs error; dX the same bits run to run (the plain
    version's cuDNN VJP is not); the wrapper raises on a call the kernel
    does not take."""
    c = shape[-1]
    x, weight, bias = _upsample_args(rn, *shape)
    dy = rn(shape[0], 2 * shape[1], 2 * shape[2], c)
    inputs = [x, weight, bias]
    n = cv.conv3x3_input_grad.launches
    _, got = _grads(uc.upsample_conv, inputs, dy)
    assert cv.conv3x3_input_grad.launches == n + 1
    _, again = _grads(uc.upsample_conv, inputs, dy)
    plain = uc.upsample2x_conv3x3_reference
    _, bf = _grads(plain, inputs, dy)
    _, f32 = _grads(plain, [a.float() for a in inputs], dy.float())
    torch.cuda.synchronize()
    for i, (g, a, p, r) in enumerate(zip(got, again, bf, f32)):
        err, perr = ((t.float() - r).abs().max().item() for t in (g, p))
        assert i > 0 or torch.equal(g, a)
        assert bool(torch.isfinite(g).all()) and err <= 1.5 * perr, (i, err, perr)
    # Ci 40, f32, a strided x
    for bad in (rn(1, 4, 4, 40), rn(1, 4, 4, 64).float(), rn(1, 4, 12, 128)[..., :64]):
        with pytest.raises(ValueError):
            uc.upsample_conv(bad, rn(64, bad.shape[-1], 3, 3), rn(64))


@pytest.mark.parametrize("site", sorted(set(sites.UP_SPLIT_SITES)),
                         ids=lambda st: "-".join(map(str, st)))
def test_conv3x3_two_sources_at_up_block_sites(rn, no_tf32, site):
    """conv3x3 with a second source (the two-source prologue) at every
    up-block conv1 site, with its epilogue (GN fold + SiLU, the shift),
    against the plain version; and the two-part GroupNorm fold there (the
    960 = 640 + 320 sites' 30-channel groups straddle the parts) against
    its plain version."""
    h, w, c1, c2, co = site
    n = _site_batch(h)
    x, x2 = rn(n, h, w, c1) * 2 + 0.5, rn(n, h, w, c2)
    weight, bias = rn(co, c1 + c2, 3, 3, sc=(9 * (c1 + c2)) ** -0.5), 0.1 * rn(co)
    scale, gbias = 1 + 0.1 * rn(c1 + c2).float(), 0.1 * rn(c1 + c2).float()
    k = gn.group_norm_fold.launches
    sc, sh = gn.group_norm_fold(x, scale, gbias, x2, groups=32, eps=1e-5)
    assert gn.group_norm_fold.launches == k + 1
    for g_, w_ in zip((sc, sh), gn.group_norm_fold_reference(x, scale, gbias, x2, groups=32,
                                                            eps=1e-5)):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
    post = 0.5 * rn(n, co).float()
    k = cv.conv3x3.launches
    got = cv.conv3x3(x, weight, bias, pre_scale=sc, pre_shift=sh, pre_silu=True,
                     post_shift=post, x2=x2)
    assert cv.conv3x3.launches == k + 1
    _assert_close_bf16(got, cv.conv3x3_fused_reference(x, weight, bias, sc, sh, post, None,
                                                       True, x2=x2))


def test_conv3x3_two_sources_gradients_and_refusals(rn, no_tf32):
    """The Function's gradients with a second source against the f32 plain
    gradient (each within 1.5x the bf16 plain version's max-abs error); no
    second source without the prologue."""
    x, x2 = rn(3, 5, 8, 64) * 2 + 0.5, rn(3, 5, 8, 128)
    weight, bias = rn(64, 192, 3, 3, sc=(9 * 192) ** -0.5), 0.1 * rn(64)
    sc, sh = (1 + 0.2 * rn(3, 192).float()) / 2, 0.3 * rn(3, 192).float()
    post = 0.5 * rn(3, 64).float()
    inputs = [x, x2, weight, bias, sc, sh, post]
    run = lambda x, x2, w, b, sc, sh, post: cv.conv3x3(
        x, w, b, pre_scale=sc, pre_shift=sh, pre_silu=True, post_shift=post, x2=x2)
    plain = lambda x, x2, w, b, sc, sh, post: cv.conv3x3_fused_reference(
        x, w, b, sc, sh, post, None, True, x2=x2)
    dy = rn(3, 5, 8, 64)
    _, got = _grads(run, inputs, dy)
    _, bf = _grads(plain, inputs, dy)
    _, f32 = _grads(plain, [a.float() for a in inputs], dy.float())
    torch.cuda.synchronize()
    for i, (g, p, r) in enumerate(zip(got, bf, f32)):
        err, perr = ((a.float() - r).abs().max().item() for a in (g, p))
        assert bool(torch.isfinite(g).all()) and err <= 1.5 * perr, (i, err, perr)
    with pytest.raises(ValueError):
        cv.conv3x3(x, weight, bias, x2=x2)


def test_conv1x1_cat_on_the_card(rn):
    """The up-block shortcut over two parts: both products and the bias
    summed in f32 and rounded once, against the f32 product of the concat
    rounded once (equal but for the f32 summation order), with gradients."""
    from svd_xtend_tpu_torch.models import blocks as tb
    mod = tb.Conv1x1Cat(192, 64).cuda().to(torch.bfloat16)
    x, x2 = rn(3, 5, 8, 64), rn(3, 5, 8, 128)
    got = mod(x, x2)
    w = mod.weight[:, :, 0, 0].float()
    want = (torch.cat([x, x2], -1).float() @ w.T + mod.bias.float()).to(torch.bfloat16)
    _assert_close_bf16(got, want)
    xs = [x.clone().requires_grad_(), x2.clone().requires_grad_()]
    gx, gx2 = torch.autograd.grad(mod(*xs).float().sum(), xs)
    torch.testing.assert_close(gx.float(), torch.ones(3, 5, 8, 64, device="cuda") @ w[:, :64],
                               atol=0.05, rtol=0.02)
    assert gx2.shape == x2.shape and bool(torch.isfinite(gx2).all())


def test_async_checkpoint_snapshot_on_the_card(card, tmp_path):
    """save() on CUDA tensors returns after queueing device-to-host copies
    on a side stream; work the current stream queues next (the next step's
    in-place update) runs after them, so the file holds the values at the
    save; the pinned buffers are reused by the next save."""
    from svd_xtend_tpu_torch.train import checkpoint as tckpt

    class _State:
        def __init__(self):
            self.step = 1
            self.w = torch.arange(1 << 22, device="cuda", dtype=torch.float32)

        def state_dict(self, copy=None):
            return {"step": self.step, "w": self.w.clone().cpu() if copy is None else copy(self.w)}

    st = _State()
    want = st.w.cpu()
    out = str(tmp_path)
    m = tckpt.CheckpointManager(out)
    cfg = tcfg.TrainConfig(output_dir=out)
    m.save(1, st, cfg)
    st.w.mul_(-1.0)                          # the next step, on the current stream
    m.wait()
    got = torch.load(os.path.join(out, "checkpoint-1", "state", tckpt.STATE_FILE))["w"]
    assert torch.equal(got, want)
    pinned = list(m._pinned)
    m.save(2, st, cfg, blocking=True)
    assert [p.data_ptr() for p in m._pinned] == [p.data_ptr() for p in pinned]
    got = torch.load(os.path.join(out, "checkpoint-2", "state", tckpt.STATE_FILE))["w"]
    assert torch.equal(got, -want)
    # the copies' device time: 16 MB at well under PCIe's rate
    assert all(0 < r["copy_seconds"] < 1 for r in m.saves)


# ------------------------------------------------------ the int8 kernels --

from svd_xtend_tpu_torch.ops import quant as qt                    # noqa: E402
from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig        # noqa: E402
from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq       # noqa: E402


def _same_bits(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got.reshape(-1), ref.reshape(-1)), (got.float() - ref.float()).abs().max()


def _pre(rn, n, c, silu=True):
    return ((1 + 0.2 * rn(n, c)).float() / 2, 0.3 * rn(n, c).float(), silu)


@pytest.mark.parametrize("shape,c2,pre", [
    ((28, 40, 64, 320), 0, "preS"), ((2, 10, 16, 1280), 1280, "preS"),
    ((3, 5, 8, 640), 1280, "preS"), ((2, 9, 5, 64), 0, "pre"), ((1, 40, 64, 4), 0, ""),
    ((28, 40, 64, 8), 0, ""), ((71680, 320), 0, ""), ((28, 1024), 0, ""), ((2, 1280), 0, ""),
    ((3, 7, 36), 0, "")])
def test_int8_quantize_kernel(rn, shape, c2, pre):
    """Codes and (amax, scale) bit for bit against the plain version, with
    and without the prologue and the second source; two runs the same."""
    x = rn(*shape) * 3
    x2 = rn(*shape[:-1], c2) if c2 else None
    p = _pre(rn, shape[0], shape[-1] + c2, pre == "preS") if pre else None
    n = iq.quantize.launches
    q, stats = iq.quantize(x, p, x2)
    assert iq.quantize.launches == n + 1
    rq, rstats = iq.quantize_reference(x, p, x2)
    _same_bits(q, rq)
    _same_bits(stats, rstats)
    q2, stats2 = iq.quantize(x, p, x2)
    _same_bits(q2, q)
    _same_bits(stats2, stats)


def _split_site(h, w, ci, co):
    for sh, sw, c1, c2, sco in sites.UP_SPLIT_SITES:
        if (sh, sw, c1 + c2, sco) == (h, w, ci, co):
            return c1, c2
    return None


_QUANT_CONV_SITES = sorted({(28,) + st[:5] for st in sites.INT8_CONV_SITES}
                           | {(8,) + st[:5] for st in sites.INT8_VAE_CONV_SITES})


@pytest.mark.parametrize("site", _QUANT_CONV_SITES, ids=lambda st: "-".join(map(str, st)))
def test_int8_quantize_at_conv_sites(rn, site):
    """The single-launch kernel at every Conv3x3 site of a CFG UNet pass and
    a decode chunk (the GN-fold + SiLU prologue, the up blocks' two sources,
    conv_in's Ci 8 and 4): codes and stats bit for bit the plain version's,
    one launch."""
    n, h, w, ci, co, epi = site
    split = _split_site(h, w, ci, co) if "post" in epi else None
    x = rn(n, h, w, split[0] if split else ci) * 2
    x2 = rn(n, h, w, split[1]) * 2 if split else None
    pre = _pre(rn, n, ci) if epi.startswith("pre") else None
    launches = iq.quantize.launches
    got = iq.quantize(x, pre, x2)
    assert iq.quantize.launches == launches + 1
    for a, b in zip(got, iq.quantize_reference(x, pre, x2)):
        _same_bits(a, b)


@pytest.mark.parametrize("site", sites.INT8_QUANTISE_SITES, ids=lambda st: "-".join(map(str, st)))
def test_int8_quantize_at_dense_and_gate_sites(rn, site):
    """The quantise of every QLinear input of a CFG pass, net.2's with the
    gate (net.0.proj's (rows, 8C) output): bit for bit the plain version's
    and, at the gate, the module path's codes (F.gelu, the product, the
    quantise)."""
    rows, k_in, k = site[:3]
    gate = k_in == 2 * k
    y = rn(rows, k_in) * 2
    launches = iq.quantize.launches
    got = iq.quantize(y, gate=gate)
    assert iq.quantize.launches == launches + 1 and got[0].shape == (rows, k)
    for a, b in zip(got, iq.quantize_reference(y, gate=gate)):
        _same_bits(a, b)
    if gate:
        h, g = y.chunk(2, dim=-1)
        for a, b in zip(got, iq.quantize(h * torch.nn.functional.gelu(g, approximate="tanh"))):
            _same_bits(a, b)


def _residency_edge(width, gate=False):
    """Rows at which every block of the device's plan just keeps all its
    tiles in shared memory (one row more streams a tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = iq.quantize_plan(10 ** 7, (width,), gate, sms=sms)
    budget = iq.MAX_SMEM - iq.HEADER - (iq.LUT_BYTES if gate else 0)
    return sms * min(iq.MAX_SLOTS, budget // plan.slot_bytes) * plan.tile_rows


@pytest.mark.parametrize("width,gate", [(320, False), (1280, False), (2560, True)])
def test_int8_quantize_around_residency(rn, width, gate):
    """Just under and over the shared memory's residency (every tile kept,
    one tile read again after the barrier) and the one-block call's size:
    bit for bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edge = _residency_edge(width, gate)
    tiny = iq.TINY_BYTES // (2 * width)
    for rows in (edge, edge + 1, tiny, tiny + 1):
        plan = iq.quantize_plan(rows, (width,), gate, sms=sms)
        if rows == edge:
            assert plan.kept_tiles == plan.tiles
        if rows == edge + 1:
            assert plan.streamed_tiles > 0
        y = rn(rows, width) * 3
        for a, b in zip(iq.quantize(y, gate=gate), iq.quantize_reference(y, gate=gate)):
            _same_bits(a, b)


def test_int8_quantize_phased_form(rn, monkeypatch):
    """Under an amax group: two launches (the blocks' maxima, then the codes)
    with the partials reduced between them (a group of one here), the
    one-launch codes and stats bit for bit; an empty part launches nothing
    and adds an amax of 0."""
    monkeypatch.setattr(iq, "all_reduce_max_", lambda t, group: t)
    cases = [((28, 40, 64, 320), None, False), ((71680, 320), None, False),
             ((3, 7, 36), None, False), ((17920, 5120), None, True),
             ((2, 10, 16, 1280), "pre", False)]
    for shape, pre, gate in cases:
        x = rn(*shape) * 3
        p = _pre(rn, shape[0], shape[-1]) if pre else None
        want = iq.quantize(x, p, gate=gate)
        with qt.quantized("int8", object()):
            launches = iq.quantize.launches
            got = iq.quantize(x, p, gate=gate)
            assert iq.quantize.launches == launches + 2
            empty = iq.quantize(rn(0, 64))
            assert iq.quantize.launches == launches + 2 and empty[0].shape == (0, 64)
        for a, b in zip(got, want):
            _same_bits(a, b)
        _same_bits(empty[1], torch.tensor([0.0, 1e-12 * qt.INV_QMAX], device="cuda"))


def test_int8_gate_gelu_over_every_bf16_value(rn):
    """The gate's GELU table and product against torch's F.gelu (tanh, bf16)
    and product over all 65536 bf16 gate values, at h = 1 and at random h:
    the same bits (NaN for NaN)."""
    g = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).cuda()
    for h in (torch.ones_like(g), rn(65536) * 4):
        y = torch.cat([h, g]).reshape(1, -1)
        got, ref = iq.gate_values(y), iq.gate_reference(y)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got.view(torch.int16)[~nan], ref.view(torch.int16)[~nan])


def test_int8_quantize_arithmetic_proofs(rn):
    """The quantise's replacements of the IEEE divisions, each over its whole
    domain: the codes (reciprocal and one Newton step) over every bf16 v
    and bf16 amax >= |v|, the SiLU's reciprocal over every f32 |a| <= 16."""
    bad, pairs = iq.code_selftest()
    assert bad == 0 and pairs > 10 ** 9
    bad, values = iq.silu_selftest()
    assert bad == 0 and values == 2 * (0x41800000 + 1)


def test_int8_quantize_in_a_cuda_graph(rn):
    """20 launches captured in a graph and replayed: the grid barrier's
    counter resets itself, every replay gives the same bits."""
    x = rn(71680, 320) * 2
    want = iq.quantize(x)
    outs = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            outs.append(iq.quantize(x))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for q, stats in outs:
            _same_bits(q, want[0])
            _same_bits(stats, want[1])


def test_int8_quantize_raises_on_untaken_calls(rn):
    with pytest.raises(ValueError):                 # the gate over an odd half
        iq.quantize(rn(4, 12), gate=True)
    with pytest.raises(ValueError):                 # the gate with a prologue
        iq.quantize(rn(2, 4, 4, 16), _pre(rn, 2, 8), gate=True)
    with pytest.raises(ValueError):                 # the gate with a second source
        iq.quantize(rn(4, 16), x2=rn(4, 16), gate=True)
    with pytest.raises(ValueError):                 # two rows do not fit a block
        iq.quantize(rn(2, 60000))
    with pytest.raises(ValueError):                 # a part not on the card
        iq.quantize(rn(4, 16), x2=torch.zeros(4, 16, dtype=torch.bfloat16))


def test_int8_self_attention_shares_codes_on_the_card(rn):
    """Attention in int8 mode on the card: one quantise launch for q, k and v
    (two with to_out), the output the plain versions' bits."""
    from svd_xtend_tpu_torch.models.transformer import Attention
    attn = Attention(64, 2, 32).cuda().to(torch.bfloat16)
    x = rn(2, 40, 64)
    with torch.no_grad(), qt.quantized("int8"):
        launches = iq.quantize.launches
        got = attn(x)
        assert iq.quantize.launches == launches + 2
        with plain_versions():
            ref = attn(x)
    _same_bits(got, ref)


def _int8_conv_inputs(rn, n, h, w, ci, co, epi):
    x = rn(n, h, w, ci) * 2
    xq, stats = iq.quantize(x)
    weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5)
    wq, w_amax = ig.conv_codes(weight)
    post = 0.5 * rn(n, co).float() if "post" in epi else None
    res = rn(n, h, w, co) if "res" in epi else None
    return xq, stats, wq, w_amax, 0.1 * rn(co), post, res


_INT8_CONV_SITES = sorted({st[:5] for st in sites.INT8_CONV_SITES + sites.INT8_VAE_CONV_SITES})


@pytest.mark.parametrize("site", _INT8_CONV_SITES, ids=lambda st: "-".join(map(str, st)))
def test_int8_conv_sites(rn, site):
    """The int8 GEMM's conv at every Conv3x3 site of the UNet and the VAE
    decoder (the edge convs: Ci 8, Co 4, Ci 4, Co 3): bit for bit the plain
    version on the same codes."""
    h, w, ci, co, epi = site
    args = _int8_conv_inputs(rn, _site_batch(h), h, w, ci, co, epi)
    n = ig.int8_conv3x3.launches
    got = ig.int8_conv3x3(*args)
    assert ig.int8_conv3x3.launches == n + 1
    _same_bits(got, ig.conv_reference(*args))


_INT8_DENSE_SHAPES = sorted({st[:3] for st in sites.INT8_DENSE_SITES}
                            | {(130, 320, 320), (28, 1024, 16), (1, 64, 2560)})


@pytest.mark.parametrize("shape", _INT8_DENSE_SHAPES, ids=lambda st: "-".join(map(str, st)))
def test_int8_dense_sites(rn, shape):
    """The int8 GEMM's dense product at every QLinear site of a CFG UNet
    pass (and ragged rows, a thin output, one row): bit for bit the plain
    version on the same codes."""
    rows, k, co = shape
    xq, stats = iq.quantize(rn(rows, k))
    wq, w_amax = ig.dense_codes(rn(co, k, sc=k ** -0.5))
    bias = 0.1 * rn(co)
    n = ig.int8_dense.launches
    got = ig.int8_dense(xq, stats, wq, w_amax, bias)
    assert ig.int8_dense.launches == n + 1
    _same_bits(got, ig.dense_reference(xq, stats, wq, w_amax, bias))
    _same_bits(ig.int8_dense(xq, stats, wq, w_amax), ig.dense_reference(xq, stats, wq, w_amax))


# the wgmma kernels under every plan they take: one conv site per UNet level
# and the VAE's widest, Ci 320 and 960 (taps ending mid-tile at 128-byte K
# tiles), a residual and a shift site each, the 5x8 level at CFG batch 28
# (the model's plan splits K); (batch, H, W, Ci, Co, epilogue)
_INT8_WGMMA_CONVS = [(4, 40, 64, 320, 320, "post"), (4, 40, 64, 320, 320, "res"),
                     (2, 40, 64, 960, 320, "post"), (4, 20, 32, 640, 640, "res"),
                     (4, 10, 16, 1280, 1280, "post"), (28, 5, 8, 1280, 1280, "res"),
                     (28, 5, 8, 2560, 1280, "post"), (2, 40, 64, 512, 512, "none")]


@pytest.mark.parametrize("site", _INT8_WGMMA_CONVS, ids=lambda st: "-".join(map(str, st)))
def test_int8_conv_every_wgmma_plan(rn, site):
    """Every plan of the wgmma kernels (K tiles of 64 and 128 codes, tile
    widths, K slices) bit for bit the plain version; the model's plan is
    one of them."""
    n, h, w, ci, co, epi = site
    args = _int8_conv_inputs(rn, n, h, w, ci, co, epi)
    plans = ig.wgmma_plans(n * h * w, co, ci, 9)
    assert ig.int8_gemm_plan(n * h * w, co, ci, 9) in plans
    ref = ig.conv_reference(*args)
    for plan in plans:
        _same_bits(ig.int8_conv3x3(*args, plan=plan), ref)
    if (n, h, w) == (28, 5, 8):
        assert ig.int8_gemm_plan(n * h * w, co, ci, 9).k_slices > 1


# one dense site per level (the feed-forward's wide output at L0), the split
# 5x8 sites, the CLIP token's 28 and 2 rows, ragged K and rows
_INT8_WGMMA_DENSES = [(71680, 320, 2560), (17920, 640, 640), (4480, 5120, 1280),
                      (1120, 5120, 1280), (1120, 1280, 1280), (28, 1024, 320), (2, 320, 320),
                      (130, 48, 40)]


@pytest.mark.parametrize("shape", _INT8_WGMMA_DENSES, ids=lambda st: "-".join(map(str, st)))
@pytest.mark.parametrize("raw", [False, True])
def test_int8_dense_every_wgmma_plan(rn, shape, raw):
    """Every plan of the wgmma kernels bit for bit the plain version, with
    the epilogue and in the raw form (the exact int32 sums)."""
    rows, k, co = shape
    xq, stats = iq.quantize(rn(rows, k))
    wq, w_amax = ig.dense_codes(rn(co, k, sc=k ** -0.5))
    bias = 0.1 * rn(co)
    if raw:
        ref = qt.dense_accumulate(xq.cpu(), wq.cpu()).to(xq.device)
        run = lambda plan: ig.dense_sums(xq, wq, plan=plan)
    else:
        ref = ig.dense_reference(xq, stats, wq, w_amax, bias)
        run = lambda plan: ig.int8_dense(xq, stats, wq, w_amax, bias, plan=plan)
    for plan in ig.wgmma_plans(rows, co, k):
        _same_bits(run(plan), ref)


@pytest.mark.parametrize("site", [(2, 40, 64, 320, 320, "post"), (2, 5, 8, 1280, 1280, "res")])
def test_int8_mma_kernel_by_explicit_plan(rn, site):
    """The mma.sync kernel still takes the wide sites when its plan is given
    (chip_smoke.py times it beside the wgmma kernels): bit for bit."""
    n, h, w, ci, co, epi = site
    args = _int8_conv_inputs(rn, n, h, w, ci, co, epi)
    _same_bits(ig.int8_conv3x3(*args, plan=ig.mma_plan(n * h * w, co, ci, 9)),
               ig.conv_reference(*args))


@pytest.mark.parametrize("site", sites.UP_SPLIT_SITES[:4] + [(5, 8, 1280, 1280, 1280)],
                         ids=lambda st: "-".join(map(str, st)))
def test_int8_conv3x3_site_two_sources(rn, site):
    """Conv3x3's int8 site with the prologue over two sources and the shift
    (the up blocks' conv1): the kernels against the plain site, bit for bit."""
    h, w, c1, c2, co = site
    n = 2
    x, x2 = rn(n, h, w, c1), rn(n, h, w, c2)
    weight = rn(co, c1 + c2, 3, 3, sc=(9 * (c1 + c2)) ** -0.5)
    bias, post = 0.1 * rn(co), 0.5 * rn(n, co).float()
    pre = _pre(rn, n, c1 + c2)
    got = ig.conv3x3_site(x, weight, bias, pre, post, None, x2)
    with plain_versions():
        ref = ig.conv3x3_site(x, weight, bias, pre, post, None, x2)
    _same_bits(got, ref)


def test_int8_modules_on_the_card(rn):
    """Conv3x3 and QLinear in int8 mode go through the kernels: one quantise
    and one GEMM launch a call, the outputs the plain sites' bits."""
    from svd_xtend_tpu_torch.models.blocks import Conv3x3
    from svd_xtend_tpu_torch.models.transformer import QLinear
    conv = Conv3x3(64, 32).cuda().to(torch.bfloat16)
    lin = QLinear(64, 48).cuda().to(torch.bfloat16)
    x, res = rn(2, 5, 8, 64), rn(2, 5, 8, 32)
    before = (iq.quantize.launches, ig.int8_conv3x3.launches, ig.int8_dense.launches)
    with torch.no_grad(), qt.quantized("int8"):
        y, z = conv(x, residual=res), lin(x)
        with plain_versions():
            yp, zp = conv(x, residual=res), lin(x)
    assert (iq.quantize.launches, ig.int8_conv3x3.launches, ig.int8_dense.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    _same_bits(y, yp)
    _same_bits(z, zp)


def test_int8_wrappers_raise_on_untaken_calls(rn):
    with pytest.raises(ValueError):                 # f32 activations
        iq.quantize(rn(4, 64).float())
    with pytest.raises(ValueError):                 # channels not a multiple of 4
        iq.quantize(rn(2, 3, 3, 6))
    xq, stats = iq.quantize(rn(2, 4, 4, 8))
    with pytest.raises(ValueError):                 # Ci 6: not a multiple of 4
        ig.int8_conv3x3(torch.zeros(2, 4, 4, 6, dtype=torch.int8, device="cuda"), stats,
                        torch.zeros(8, 3, 3, 6, dtype=torch.int8, device="cuda"),
                        torch.ones(8, device="cuda"))
    with pytest.raises(ValueError):                 # dense K 24: not a multiple of 16
        ig.int8_dense(torch.zeros(4, 24, dtype=torch.int8, device="cuda"), stats,
                      torch.zeros(8, 24, dtype=torch.int8, device="cuda"),
                      torch.ones(8, device="cuda"))
    wq, w_amax = ig.conv_codes(rn(16, 8, 3, 3))
    with pytest.raises(ValueError):                 # an f32 output
        ig.int8_conv3x3(xq, stats, wq, w_amax, dtype=torch.float32)


# ------------------------------------------- data parallelism on the card --

def _tiny_train(offload="none", zero1=False, world=None, steps=2, scope="full"):
    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)
    world = world or parallel.SINGLE
    cfg = tcfg.TrainConfig(train_mode=scope, use_ema=scope == "full", learning_rate=1e-3,
                           height=32,
                           width=32, num_frames=3, lr_warmup_steps=0, host_offload=offload,
                           zero1=zero1)
    models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    state = create_train_state(cfg, models, world=world)
    cast_frozen_to_compute(models, torch.bfloat16)
    step = make_train_step(models, cfg, world)
    for s in range(steps):
        batch = torch.rand(1, 3, 32, 32, 3, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(s)) * 2 - 1
        state, _ = step(state, batch, generator=torch.Generator("cuda").manual_seed(s))
    torch.cuda.synchronize()
    return models, state


@pytest.mark.parametrize("mode", ["masters", "masters+moments"])
def test_host_offload_on_the_card(rn, mode, monkeypatch):
    """The masters (and the moments) in pinned host memory, the EMA, the
    compute copies on the card; the steps' masters, moments, EMA and
    compute copies bit for bit those without offload, in several chunks."""
    from svd_xtend_tpu_torch.train.optim import ClippedAdamW
    monkeypatch.setattr(ClippedAdamW, "OFFLOAD_CHUNK_VALUES", 200_000)
    m0, plain = _tiny_train()
    m1, off = _tiny_train(mode)
    assert all(p.device.type == "cpu" and p.is_pinned() for p in off.params)
    assert all(e.is_cuda for e in off.ema_params)
    opt = off.optimizer
    moments = [t for i in opt.local for t in opt._moments(i)]
    if mode == "masters":
        assert all(t.is_cuda for t in moments)
    else:
        assert all(t.device.type == "cpu" and t.is_pinned() for t in moments)
    assert len(list(opt._chunks())) > 1 and opt.streamed_bytes > 0
    for a, b in zip(plain.params, off.params):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(plain.ema_params, off.ema_params):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(m0.unet.named_parameters(), m1.unet.named_parameters()):
        assert torch.equal(a, b), n
    sa, sb = plain.optimizer.state_dict()["adamw"], opt.state_dict()["adamw"]
    for i, st in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k].cpu(), sb["state"][i][k].cpu())


@pytest.mark.parametrize("mode", ["masters", "masters+moments"])
def test_host_offload_lora_on_the_card(rn, mode):
    """The 'lora' scope: the adapter's f32 masters in pinned host memory,
    its compute copy on the card; both bit for bit the adapter without
    offload after the steps."""
    from svd_xtend_tpu_torch.io.convert import lora_state_dict
    _, plain = _tiny_train(scope="lora")
    _, off = _tiny_train(mode, scope="lora")
    assert all(p.device.type == "cpu" and p.is_pinned() for p in off.params)
    adapter = list(lora_state_dict(off.lora).values())
    assert all(a.is_cuda for a in adapter) and off.optimizer.streamed_bytes > 0
    for a, b, c in zip(plain.params, off.params, adapter):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


def test_world_of_one_over_nccl(rn, monkeypatch):
    """One rank in an NCCL process group (the gradient all-reduce, ZeRO-1's
    broadcast and gather go through it) steps as the rank without a group,
    bit for bit."""
    import socket

    import torch.distributed as dist

    from svd_xtend_tpu_torch import parallel
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    _, plain = _tiny_train()
    world = parallel.init_world("cuda")
    try:
        assert dist.get_backend() == "nccl" and world.collective
        _, zero = _tiny_train(zero1=True, world=world)
        sd = zero.state_dict()
    finally:
        parallel.close_world(world)
    for a, b in zip(plain.params, zero.params):
        assert torch.equal(a, b)
    for a, b in zip(plain.ema_params, zero.ema_params):
        assert torch.equal(a, b)
    assert len(sd["optimizer"]["adamw"]["state"]) == len(plain.params)


@pytest.mark.parametrize("shape", [(2, 64, 40, 320, 320), (2, 32, 20, 640, 640),
                                   (2, 8, 5, 1280, 1280), (1, 72, 128, 320, 320),
                                   (2, 36, 64, 640, 640), (2, 9, 16, 1280, 1280),
                                   (1, 72, 128, 8, 320), (1, 72, 128, 320, 4),
                                   (1, 576, 1024, 128, 3), (1, 72, 128, 4, 512)],
                         ids=lambda st: "-".join(map(str, st)))
def test_int8_conv_at_other_resolutions(rn, shape):
    """The int8 conv at the 320x512 portrait latents (64x40 and its levels)
    and at 1024x576 (72x128 and its levels; the edge convs there): bit for
    bit the plain version."""
    n, h, w, ci, co = shape
    args = _int8_conv_inputs(rn, n, h, w, ci, co, "post" if ci == co else "none")
    _same_bits(ig.int8_conv3x3(*args), ig.conv_reference(*args))


def test_frames_collectives_over_a_world_of_one(rn, monkeypatch):
    """The frames axis's collectives on card tensors in an NCCL group of one
    (no host staging): the all-to-all pair and the gather are the identity
    with their backward, and the int8 quantiser's two passes with the
    partial amaxes reduced between them (quant.quantized(mode, group)) give
    the one-launch codes and stats bit for bit."""
    import socket

    import torch.distributed as dist

    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.parallel import frames as fr
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    world = parallel.init_world("cuda")
    try:
        shard = fr.FrameShard(dist.group.WORLD, (0,), 0, 14)
        fr.STAGED.reset()
        x = rn(2, 14, 40, 320).requires_grad_(True)
        y = fr.tokens_to_frames(fr.frames_to_tokens(x, shard), shard, 40)
        z = fr.gather_frames(y, shard)
        assert torch.equal(z, x)
        (g,) = torch.autograd.grad(z, x, torch.ones_like(z))
        assert torch.equal(g, torch.ones_like(x)) and fr.STAGED.bytes == 0
        for shape in ((28, 40, 64, 320), (71680, 320), (3, 7, 36)):
            v = rn(*shape) * 3
            q0, s0 = iq.quantize(v)
            with qt.quantized("int8", shard.group):
                q, stats = iq.quantize(v)
            _same_bits(q, q0)
            _same_bits(stats, s0)
    finally:
        parallel.close_world(world)


def test_an_f32_pipeline_runs_on_the_card(rn, monkeypatch):
    """F8: the TINY networks in f32 on the card (as eval_tracklet runs
    them): the GroupNorm fold, the two-source conv3x3 and the upsample,
    whose kernels take bf16 alone, run their plain versions, as the other
    sites do where their ``supports`` say no; the video against the same
    networks on the CPU, from the same noise, at the f32 pipeline tests'
    tolerance (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tcfg.PipelineConfig(height=32, width=32, num_frames=3, num_inference_steps=2,
                              decode_chunk_size=2)
    nets = {d: tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                      device=d, generator=torch.Generator(d).manual_seed(0))
            for d in ("cpu", "cuda")}
    for name in ("unet", "vae", "clip"):
        getattr(nets["cuda"], name).load_state_dict(getattr(nets["cpu"], name).state_dict())
    g = torch.Generator().manual_seed(1)
    image = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    noise = (torch.randn(1, 32, 32, 3, generator=g), torch.randn(1, 3, 16, 16, 4, generator=g))
    n = {k: c.launches for k, c in (("fold", gn.group_norm_fold), ("up", uc.upsample_conv),
                                     ("conv", cv.conv3x3))}
    got = tpipe.generate(nets["cuda"], image.cuda(), cfg, image_noise=noise[0].cuda(),
                         latent_noise=noise[1].cuda()).cpu()
    want = tpipe.generate(nets["cpu"], image, cfg, image_noise=noise[0], latent_noise=noise[1])
    assert (gn.group_norm_fold.launches, uc.upsample_conv.launches, cv.conv3x3.launches) == (
        n["fold"], n["up"], n["conv"])
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
