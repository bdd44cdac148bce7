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
    kernel B within 4 ulps. Returns (h, psum, psq, out)."""
    x, t, k1, b1, k2, b2, sc1, sh1, w = inputs
    b, f, s, c = x.shape
    (wt1, b1f), (wt2, b2f) = tr.packed(k1, b1), tr.packed(k2, b2)
    h = torch.empty_like(x)
    psum = torch.empty((b, gn.stats_slots(f * s), c), device="cuda")
    psq = torch.empty_like(psum)
    tr._launch(x, wt1, b1f, sc1, sh1, t, None, h, psum, psq, True, plans[0])
    rh, rsum, rsq = tr.conv_a_reference(x, k1, b1, sc1, sh1, t)
    _assert_close_bf16(h, rh)
    own = gn.channel_stats_reference(h.reshape(-1, c), f * s)
    for got, ref, mine in ((psum, rsum, own[0]), (psq, rsq, own[1])):
        assert _rel(got.sum(1), ref) <= tr.sums_tolerance(f * s)
        assert _rel(got, mine) <= 1e-5
    out = torch.empty_like(x)
    tr._launch(rh, wt2, b2f, sc1, sh1, x, w, out, None, None, False, plans[1])
    _assert_close_bf16(out, tr.conv_b_reference(rh, k2, b2, sc1, sh1, x, w))
    return h, psum, psq, out


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
    h, psum = torch.empty_like(x), torch.empty(1, gn.stats_slots(16), 64, device="cuda")
    for plan in (GemmPlan(16, 64, 3, 64, 1, 1), GemmPlan(16, 64, 3, 96, 1, 1),
                 GemmPlan(16, 64, 3, 128, 4, 1), GemmPlan(16, 64, 3, 128, 1, 0)):
        with pytest.raises(RuntimeError):
            tr._launch(x, wt, bias, sc, sh, t, None, h, psum, psum.clone(), True, plan)


@pytest.mark.parametrize("shape", [(2, 14, 40, 1280), (3, 7, 9, 64), (28, 40, 64, 320),
                                   (8, 5, 8, 2560)])
def test_group_norm_fold_kernel(rn, shape):
    """The fold's kernels: the statistics partials against their plain
    version slot by slot (1e-5 relative, f32 sums in another order), the
    fold against the plain fold and fold_from_partials against the plain
    fold of the slot sums (1e-4); two runs give the same bits."""
    x = rn(*shape) * 2 + 0.5
    c = shape[-1]
    rows = x.numel() // (shape[0] * c)
    scale, bias = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
    psum = torch.empty(shape[0], gn.stats_slots(rows), c, device="cuda")
    psq = torch.empty_like(psum)
    gn._fold_launch(x, psum, psq, rows, scale, bias, 32, 1e-5)
    for got, r in zip((psum, psq), gn.channel_stats_reference(x.reshape(-1, c), rows)):
        assert ((got - r).abs().max() / r.abs().max()).item() <= 1e-5
    n = gn.group_norm_fold.launches
    got = gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
    assert gn.group_norm_fold.launches == n + 1
    again = gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = gn.group_norm_fold_reference(x, scale, bias, groups=32, eps=1e-5)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
    n = gn.fold_from_partials.launches
    got = gn.fold_from_partials(psum, psq, rows, scale, bias, 32, 1e-5)
    assert gn.fold_from_partials.launches == n + 1
    want = gn.fold_from_channel_sums(psum.sum(1), psq.sum(1), rows, scale, bias, 32, 1e-5)
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


def _flash_grad_errors(rn, b, s, heads):
    """Max-abs error against the f32 plain gradient of (the kernels' dq, dk,
    dv) and (the bf16 plain version's), per input."""
    q, k, v = (rn(b, s, heads * 64) for _ in range(3))
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


@pytest.mark.parametrize("n_inner", [1, 2, 4])
@pytest.mark.parametrize("bq,bkm", [(128, 128), (640, 640), (1024, 1536)])
def test_flash_chain_kernels(rn, n_inner, bq, bkm):
    """chain_bf16 within 4 bf16 ulps of the output's scale (the kernel and the
    plain version sum in another order, so a rounding of p or q may differ by
    one ulp); chain_int8_qd equal bit for bit (int32 sums, the same f32
    roundings in the same order)."""
    q, kT, v, kTi, vi = _chain_inputs(rn, bq, bkm)
    n8 = fc.chain_int8_qd.launches
    got = fc.chain_int8_qd(q, kTi, vi, n_inner)
    assert fc.chain_int8_qd.launches == n8 + 1
    ref = fc.chain_int8_qd_reference(q, kTi, vi, n_inner)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    _assert_close_bf16(fc.chain_bf16(q, kT, v, n_inner),
                       fc.chain_bf16_reference(q, kT, v, n_inner))


def test_flash_chain_wrappers_raise_on_untaken_calls(rn):
    q, kT, v, kTi, vi = _chain_inputs(rn, 128, 128)
    with pytest.raises(ValueError):                 # bq not a multiple of 64
        fc.chain_bf16(rn(100, 64), kT, v)
    with pytest.raises(ValueError):                 # bf16 kᵀ for the int8 chain
        fc.chain_int8_qd(q, kT, vi)


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
