"""Each hand-written kernel's plain PyTorch version against the JAX package:
the Pallas kernels run as the JAX package's own tests run them on the CPU
(interpret mode, or SVDX_PALLAS_TRESNET / SVDX_PALLAS_GEGLU=force), and the
XLA references. Float32; shapes include ragged frame counts (F = 3). Also
the kernels' autograd wiring, with each plain forward injected in place of
the CUDA launch: the gradient through the Function equals the plain
version's.

The CUDA and Triton kernels themselves run only on a GPU: see
tests/test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.ops.attention import _xla_attention
from svd_xtend_tpu.ops.pallas import flash_attention as jfa
from svd_xtend_tpu.ops.pallas import geglu as jgg
from svd_xtend_tpu.ops.pallas import groupnorm as jgn
from svd_xtend_tpu.ops.pallas import temporal_attention as jta
from svd_xtend_tpu.ops.pallas import temporal_resnet as jtr
from svd_xtend_tpu_torch.ops.kernels import conv3x3 as tcv
from svd_xtend_tpu_torch.ops.kernels import flash_attention as tfa
from svd_xtend_tpu_torch.ops.kernels import geglu as tgg
from svd_xtend_tpu_torch.ops.kernels import groupnorm as tgn
from svd_xtend_tpu_torch.ops.kernels import temporal_attention as tta
from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as ttr

torch.set_num_threads(1)

# single kernels in f32 on the CPU: only summation order differs from the
# JAX side (XLA dot vs torch einsum, online vs two-pass softmax); 2e-5
# absolute on O(1) outputs
ATOL = RTOL = 2e-5


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------------ flash --

@pytest.mark.parametrize("b,s,heads", [(2, 128, 2), (1, 256, 3)])
def test_flash_plain_matches_pallas_packed_kernel(b, s, heads):
    rs = np.random.RandomState(s + heads)
    q, k, v = (_rand(rs, b, s, heads * 64) for _ in range(3))
    scale = 64 ** -0.5
    ref = np.asarray(jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), num_heads=heads,
                                                scale=scale))
    got = tfa.flash_attention_packed(_t(q), _t(k), _t(v), num_heads=heads, scale=scale)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,s,t,heads", [(2, 40, 40, 2), (1, 160, 24, 1)])
def test_flash_plain_matches_xla_attention_ragged(b, s, t, heads):
    """Lengths that are not tile multiples (the kernel masks them)."""
    rs = np.random.RandomState(s)
    q = _rand(rs, b, s, heads * 64)
    k, v = _rand(rs, b, t, heads * 64), _rand(rs, b, t, heads * 64)
    split = lambda a: jnp.asarray(a).reshape(a.shape[0], a.shape[1], heads, 64)
    ref = np.asarray(_xla_attention(split(q), split(k), split(v), 0.125)).reshape(b, s, -1)
    got = tfa.flash_attention_packed_reference(_t(q), _t(k), _t(v), num_heads=heads,
                                               scale=0.125)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


# ----------------------------------------------------- temporal attention --

@pytest.mark.parametrize("b,f,s,heads", [(2, 14, 128, 2), (1, 3, 128, 1)])
def test_frame_attention_plain_matches_pallas_kernel(b, f, s, heads):
    rs = np.random.RandomState(f)
    q, k, v = (_rand(rs, b, f, s, heads * 64) for _ in range(3))
    ref = np.asarray(jta._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125))
    got = tta.frame_attention(_t(q), _t(k), _t(v), num_heads=heads, scale=0.125)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,f,s,heads", [(2, 3, 10, 2), (1, 32, 6, 1)])
def test_frame_attention_plain_matches_xla_reference(b, f, s, heads):
    rs = np.random.RandomState(s)
    q, k, v = (_rand(rs, b, f, s, heads * 64) for _ in range(3))
    ref = np.asarray(jta._xla_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 0.125))
    got = tta.frame_attention_reference(_t(q), _t(k), _t(v), num_heads=heads, scale=0.125)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


# -------------------------------------------------------- temporal resnet --

def _tresnet_args(rs, b, f, s, c):
    return [_rand(rs, b, f, s, c), _rand(rs, b, f, c),
            _rand(rs, 3, c, c, scale=0.1), _rand(rs, c, scale=0.1),
            _rand(rs, 3, c, c, scale=0.1), _rand(rs, c, scale=0.1),
            1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
            1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
            np.float32(0.37)]


@pytest.mark.parametrize("b,f,s,c,groups", [(2, 5, 16, 64, 8), (1, 3, 24, 128, 32),
                                            (1, 1, 8, 32, 4)])
def test_temporal_resnet_plain_matches_jax(monkeypatch, b, f, s, c, groups):
    """Against temporal_resnet_reference and the forced Pallas pair
    (kernels A and B in interpret mode)."""
    args = _tresnet_args(np.random.RandomState(f * s), b, f, s, c)
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jtr.temporal_resnet_reference(*jargs, groups, 1e-5))
    monkeypatch.setenv("SVDX_PALLAS_TRESNET", "force")
    forced = np.asarray(jtr.temporal_resnet_block(*jargs, groups=groups, eps=1e-5))
    got = ttr.temporal_resnet_block(*[_t(a) for a in args], groups=groups, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), forced, atol=ATOL, rtol=RTOL)


def test_fold_from_partials_matches_jax():
    """The statistics partials' fold (on the card one kernel) against JAX's
    _fold_from_channel_sums on the same (B, slots, C) partials."""
    rs = np.random.RandomState(4)
    ps, pq = rs.rand(2, 3, 64).astype(np.float32), 2 + rs.rand(2, 3, 64).astype(np.float32)
    scale, bias = 1 + _rand(rs, 64, scale=0.1), _rand(rs, 64, scale=0.1)
    ref = jtr._fold_from_channel_sums(jnp.asarray(ps), jnp.asarray(pq), 100,
                                      jnp.asarray(scale), jnp.asarray(bias), 8, 1e-5)
    got = tgn.fold_from_partials(_t(ps), _t(pq), 100, _t(scale), _t(bias), 8, 1e-5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


def test_fold_from_channel_sums_matches_jax():
    rs = np.random.RandomState(3)
    ps, pq = rs.rand(2, 4, 64).astype(np.float32), 2 + rs.rand(2, 4, 64).astype(np.float32)
    scale, bias = 1 + _rand(rs, 64, scale=0.1), _rand(rs, 64, scale=0.1)
    ref = jtr._fold_from_channel_sums(jnp.asarray(ps), jnp.asarray(pq), 40,
                                      jnp.asarray(scale), jnp.asarray(bias), 8, 1e-5)
    got = tgn.fold_from_channel_sums(_t(ps).sum(1), _t(pq).sum(1), 40, _t(scale),
                                     _t(bias), 8, 1e-5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- GroupNorm --

@pytest.mark.parametrize("shape,groups", [((2, 7, 5, 64), 32), ((3, 40, 96), 32),
                                          ((2, 3, 4, 4, 64), 8)])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_plain_matches_jax(shape, groups, silu):
    rs = np.random.RandomState(len(shape))
    x = _rand(rs, *shape, scale=2.0) + 0.5
    c = shape[-1]
    scale, bias = 1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1)
    ref = np.asarray(jgn.group_norm_silu_reference(jnp.asarray(x), jnp.asarray(scale),
                                                   jnp.asarray(bias), groups, 1e-6, silu))
    got = tgn.group_norm_silu(_t(x), _t(scale), _t(bias), groups=groups, eps=1e-6, silu=silu)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    if silu:
        # the Pallas single-pass kernel in interpret mode computes the same
        pallas = np.asarray(jgn._pallas_forward(jnp.asarray(x), jnp.asarray(scale),
                                                jnp.asarray(bias), groups, 1e-6, silu))
        np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=RTOL)


def test_group_norm_fold_matches_jax():
    rs = np.random.RandomState(9)
    x = _rand(rs, 2, 3, 10, 64) + 1.0
    scale, bias = 1 + _rand(rs, 64, scale=0.1), _rand(rs, 64, scale=0.1)
    ref = jgn.group_norm_fold(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              groups=32, eps=1e-5)
    got = tgn.group_norm_fold(_t(x), _t(scale), _t(bias), groups=32, eps=1e-5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 3, 10, 64), (3, 7, 9, 64), (2, 130, 96), (1, 200, 64),
                                   (4, 5, 7, 64)])
def test_group_norm_fold_from_stats_partials_matches_jax(shape):
    """The fold from the statistics kernel's per-(sample, 64-row chunk)
    partials (their plain version) against JAX's group_norm_fold, at rows
    per sample (30, 63, 130, 200, 35) whose chunks straddle samples. f32 sums
    of the same values in another order: ATOL / RTOL. Slots past a sample's
    last chunk are zero."""
    rs = np.random.RandomState(len(shape) + shape[1])
    x = _rand(rs, *shape, scale=2.0) + 0.5
    c = shape[-1]
    scale, bias = 1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1)
    ref = jgn.group_norm_fold(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              groups=32, eps=1e-5)
    rows = x.size // (shape[0] * c)
    psum, psq = tgn.channel_stats_reference(_t(x).reshape(-1, c), rows)
    assert psum.shape == (shape[0], tgn.stats_slots(rows), c)
    got = tgn.fold_from_channel_sums(psum.sum(1), psq.sum(1), rows, _t(scale), _t(bias),
                                     32, 1e-5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)
    for b in range(shape[0]):
        used = (b * rows + rows - 1) // tgn.STATS_ROWS - b * rows // tgn.STATS_ROWS + 1
        assert not psum[b, used:].any() and not psq[b, used:].any()
        assert psq[b, :used].gt(0).all()


def test_group_norm_fold_differentiates_like_its_plain_version():
    """The fold through its Function (the plain forward injected in place of
    the statistics kernel), both outputs (sc, sh) differentiated: the
    gradients of x, scale and bias equal autograd's of the plain fold."""
    rs = np.random.RandomState(5)
    inputs = [_t(_rand(rs, 2, 5, 6, 64) + 1.0), _t(1 + _rand(rs, 64, scale=0.1)),
              _t(_rand(rs, 64, scale=0.1))]
    douts = [_t(_rand(rs, 2, 64)) for _ in range(2)]
    grads, outs = [], []
    for fold in (lambda *a: tgn.group_norm_fold(*a, groups=8, eps=1e-5,
                                                kernel=tgn.group_norm_fold_reference),
                 lambda *a: tgn.group_norm_fold_reference(*a, groups=8, eps=1e-5)):
        leaves = [a.clone().requires_grad_(True) for a in inputs]
        outs.append(fold(*leaves))
        grads.append(torch.autograd.grad(outs[-1], leaves, douts))
    assert all(type(o.grad_fn).__name__ == "_ReferenceGradBackward" for o in outs[0])
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)


def test_wrappers_raise_on_untaken_cuda_shapes():
    """The structural predicates refuse what the kernels do not take."""
    q = torch.zeros(1, 8, 96)
    assert not tfa.supports(q, q, 2)            # CPU tensor, head_dim 48
    assert not tta.supports(torch.zeros(1, 33, 4, 64), 1)
    assert not ttr.supports(torch.zeros(1, 2, 4, 96))
    assert not tgn.supports(torch.zeros(2, 4, 48), 32)
    assert not tcv.supports(torch.zeros(1, 4, 8, 16), torch.zeros(32, 16, 3, 3))
    assert not tfa.supports_bshd(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64))


def test_kernel_a_b_plain_versions_compose_to_the_block():
    """fold -> conv_a_reference -> fold of its sums -> conv_b_reference with
    the blend weight applied in its epilogue, out = x + w·(conv2 + b2) ==
    temporal_resnet_reference: the plain versions the card's kernels A and B
    are held against."""
    args = [_t(a) for a in _tresnet_args(np.random.RandomState(11), 2, 3, 10, 64)]
    x, t, k1, b1, k2, b2, s1, bi1, s2, bi2, w = args
    sc1, sh1 = tgn.group_norm_fold(x, s1, bi1, groups=8, eps=1e-5)
    h, sum_c, sq_c = ttr.conv_a_reference(x, k1, b1, sc1, sh1, t)
    sc2, sh2 = tgn.fold_from_channel_sums(sum_c, sq_c, 30, s2, bi2, 8, 1e-5)
    got = ttr.conv_b_reference(h, k2, b2, sc2, sh2, x, w)
    ref = ttr.temporal_resnet_reference(*args, 8, 1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------- GEGLU --

def _geglu_args(rs, t, c):
    """x, LN scale/bias, w1 (C, 8C), b1, w2 (4C, C), b2 in the JAX layouts."""
    return [_rand(rs, *t, c), 1 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1),
            _rand(rs, c, 8 * c, scale=c ** -0.5), _rand(rs, 8 * c, scale=0.1),
            _rand(rs, 4 * c, c, scale=(4 * c) ** -0.5), _rand(rs, c, scale=0.1)]


def _geglu_port_args(args):
    """The port's nn.Linear layouts: w1 (8C, C), w2 (C, 4C)."""
    x, ls, lb, w1, b1, w2, b2 = args
    return [_t(x), _t(ls), _t(lb), _t(w1.T), _t(b1), _t(w2.T), _t(b2)]


@pytest.mark.parametrize("t,c", [((2, 40), 64), ((160,), 128), ((2, 4, 10), 64)])
def test_geglu_plain_matches_jax(monkeypatch, t, c):
    """Against geglu._reference and the Pallas kernel in interpret mode
    (SVDX_PALLAS_GEGLU=force; ln_geglu_residual itself, not the TPU gate)."""
    args = _geglu_args(np.random.RandomState(c + len(t)), t, c)
    jargs = [jnp.asarray(a) for a in args]
    x2 = jargs[0].reshape(-1, c)
    ref = np.asarray(jgg._reference(x2, *jargs[1:])).reshape(args[0].shape)
    monkeypatch.setenv("SVDX_PALLAS_GEGLU", "force")
    pallas = np.asarray(jgg.ln_geglu_residual(*jargs))
    got = tgg.ln_geglu_residual(*_geglu_port_args(args)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_geglu_split_follows_the_module_layout():
    """w1 rows [:inner] are the value half and [inner:] the gate half, as
    FeedForward's proj(x).chunk(2, -1) splits them: the plain version equals
    the transformer's LayerNorm + FeedForward modules."""
    from svd_xtend_tpu_torch.models.transformer import FeedForward
    torch.manual_seed(0)
    ln, ff = torch.nn.LayerNorm(64, eps=1e-5), FeedForward(64)
    with torch.no_grad():
        ln.weight.normal_(1.0, 0.1)
        ln.bias.normal_(0.0, 0.1)
    x = torch.randn(3, 20, 64)
    with torch.no_grad():
        ref = x + ff(ln(x))
        got = tgg.ln_geglu_residual(x, ln.weight, ln.bias, ff.net[0].proj.weight,
                                    ff.net[0].proj.bias, ff.net[2].weight, ff.net[2].bias)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


# --------------------------------------------------------- flash backward --

@pytest.mark.parametrize("b,s,heads", [(2, 128, 2), (1, 256, 3)])
def test_flash_plain_backward_matches_pallas_vjp(b, s, heads):
    """flash_attention_bwd_reference (with the LSE of
    flash_attention_fwd_reference) against jax.vjp of the packed flash,
    whose backward runs the Pallas dQ and dK/dV kernels in interpret mode.
    Gradients are sums over 128-256 keys of O(1) terms: 5e-5."""
    rs = np.random.RandomState(s + b)
    q, k, v, do = (_rand(rs, b, s, heads * 64) for _ in range(4))
    scale = 64 ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_packed(
        q, k, v, num_heads=heads, scale=scale), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    o, lse = tfa.flash_attention_fwd_reference(_t(q), _t(k), _t(v), heads, scale)
    got = tfa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), o, lse, _t(do), heads, scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5, rtol=5e-5)
    # the LSE against the f32 log-sum-exp of the scores
    logits = np.einsum("bshd,bthd->bhst", q.reshape(b, s, heads, 64),
                       k.reshape(b, s, heads, 64)) * scale
    m = logits.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(), (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0],
                               atol=ATOL, rtol=RTOL)


# ----------------------------------------------- autograd wiring (F1) --

def _wiring_cases(rs):
    """(name, call through the Function with the plain forward injected,
    plain call, inputs)."""
    q, k, v = (_t(_rand(rs, 2, 40, 128)) for _ in range(3))
    fq, fk, fv = (_t(_rand(rs, 2, 3, 10, 128)) for _ in range(3))
    plain_fa = (tfa.flash_attention_fwd_reference, tfa.flash_attention_bwd_reference)
    return [
        ("flash_attention_packed",
         lambda q, k, v: tfa.flash_attention_packed(q, k, v, num_heads=2, scale=0.125,
                                                    kernels=plain_fa),
         lambda q, k, v: tfa.flash_attention_packed_reference(q, k, v, num_heads=2,
                                                              scale=0.125),
         [q, k, v]),
        ("frame_attention",
         lambda q, k, v: tta.frame_attention(q, k, v, num_heads=2, scale=0.125,
                                             kernel=tta.frame_attention_reference),
         lambda q, k, v: tta.frame_attention_reference(q, k, v, num_heads=2, scale=0.125),
         [fq, fk, fv]),
        ("temporal_resnet_block",
         lambda *a: ttr.temporal_resnet_block(*a, groups=8, eps=1e-5,
                                              kernel=ttr.temporal_resnet_reference),
         lambda *a: ttr.temporal_resnet_reference(*a, 8, 1e-5),
         [_t(a) for a in _tresnet_args(rs, 2, 3, 10, 64)]),
        ("group_norm_silu",
         lambda x, w, b: tgn.group_norm_silu(x, w, b, groups=8, eps=1e-6,
                                             kernel=tgn.group_norm_silu_reference),
         lambda x, w, b: tgn.group_norm_silu_reference(x, w, b, 8, 1e-6),
         [_t(_rand(rs, 2, 5, 6, 64)), _t(1 + _rand(rs, 64, scale=0.1)),
          _t(_rand(rs, 64, scale=0.1))]),
        ("ln_geglu_residual",
         lambda *a: tgg.ln_geglu_residual(*a, kernel=tgg.ln_geglu_residual_reference),
         tgg.ln_geglu_residual_reference,
         _geglu_port_args(_geglu_args(rs, (2, 20), 32))),
        ("conv3x3",
         lambda x, w, b, sc, sh, post, res: tcv.conv3x3(
             x, w, b, pre_scale=sc, pre_shift=sh, pre_silu=True, post_shift=post,
             residual=res, kernel=tcv.conv3x3_fused_reference),
         lambda x, w, b, sc, sh, post, res: tcv.conv3x3_fused_reference(
             x, w, b, sc, sh, post, res, True),
         [_t(_rand(rs, 2, 5, 6, 16)), _t(_rand(rs, 24, 16, 3, 3, scale=0.1)),
          _t(_rand(rs, 24, scale=0.1)), _t(1 + _rand(rs, 2, 16, scale=0.3)),
          _t(_rand(rs, 2, 16, scale=0.3)), _t(_rand(rs, 2, 24, scale=0.2)),
          _t(_rand(rs, 2, 5, 6, 24))]),
        ("flash_attention",
         lambda q, k, v: tfa.flash_attention(q, k, v, scale=0.125, kernels=plain_fa),
         lambda q, k, v: tfa.flash_attention_packed_reference(
             q.flatten(2), k.flatten(2), v.flatten(2), num_heads=2,
             scale=0.125).reshape(q.shape),
         [_t(_rand(rs, 2, 40, 2, 64)) for _ in range(3)]),
    ]


@pytest.mark.parametrize("case", range(7))
def test_kernel_functions_differentiate_like_their_plain_versions(case):
    """Every input requires grad (the blend weight w of the temporal resnet
    included): the output carries the Function's grad_fn, and its gradients
    equal autograd's of the plain version. The same f32 ops run in both
    (the reference recomputed), except the flash backward's explicit
    formulas: 1e-5. Without grad, no Function is recorded."""
    name, through, plain, inputs = _wiring_cases(np.random.RandomState(case))[case]
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    out = through(*leaves)
    assert out.grad_fn is not None and "Backward" in type(out.grad_fn).__name__, name
    dout = torch.from_numpy(np.random.RandomState(9).randn(*out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [x.clone().requires_grad_(True) for x in inputs]
    ref = torch.autograd.grad(plain(*ref_leaves), ref_leaves, dout)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert through(*leaves).grad_fn is None
