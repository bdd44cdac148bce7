"""The port's split-concat up-block resnet against the JAX package's default
form (SVDX_SPLIT_CAT_CONV on): the two-part GroupNorm fold against
``group_norm_fold_cat`` (groups straddling the parts), conv3x3 with a second
source against ``_conv3x3_split_cat``, ``Conv1x1Cat`` against
``_Conv1x1Cat``, and ``ResnetBlock2D(skip_cat=)`` against JAX's, forward
and gradients (against jax.vjp), in f32 on the CPU from numpy seeds; and
that no concat is built in the UNet's up blocks (an aten.cat spy at the
dispatcher). The CUDA kernels run only on a GPU: tests/test_torch_port_cuda.py
and chip_smoke.py."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import blocks as jb
from svd_xtend_tpu.ops.pallas import groupnorm as jgn
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.io.convert import diffusers_state_dict
from svd_xtend_tpu_torch.models import blocks as tb
from svd_xtend_tpu_torch.models import unet as tunet
from svd_xtend_tpu_torch.ops.kernels import conv3x3 as tcv
from svd_xtend_tpu_torch.ops.kernels import groupnorm as tgn
from svd_xtend_tpu_torch.scripts import sites

torch.set_num_threads(1)

# f32, one conv or fold: only the summation order differs
TOL = dict(atol=1e-5, rtol=1e-5)
# a whole resnet (two convs and two folds in sequence) and the gradients
# (sums over every position), O(1-10) values
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# C1 + C2 = 96 in 32 groups of 3: 40 % 3 != 0, so group 13 straddles the parts
C1, C2, GROUPS = 40, 56, 32


def test_two_part_fold_matches_group_norm_fold_cat():
    rs = np.random.RandomState(0)
    x, x2 = _rand(rs, 2, 3, 5, C1) + 0.5, _rand(rs, 2, 3, 5, C2, scale=2.0)
    scale, bias = 1 + _rand(rs, C1 + C2, scale=0.2), _rand(rs, C1 + C2, scale=0.2)
    jsc, jsh = jgn.group_norm_fold_cat([jnp.asarray(x), jnp.asarray(x2)], jnp.asarray(scale),
                                       jnp.asarray(bias), groups=GROUPS, eps=1e-5)
    sc, sh = tgn.group_norm_fold(_t(x), _t(scale), _t(bias), _t(x2), groups=GROUPS, eps=1e-5)
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), **TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), **TOL)
    # the straddling group has one mean and one variance across the parts
    whole = tgn.group_norm_fold_reference(torch.cat([_t(x), _t(x2)], -1), _t(scale), _t(bias),
                                          groups=GROUPS, eps=1e-5)
    np.testing.assert_allclose(sc.numpy(), whole[0].numpy(), **TOL)
    np.testing.assert_allclose(sh.numpy(), whole[1].numpy(), **TOL)


def test_two_part_fold_gradients_match_jax_vjp():
    """The fold's autograd wiring (the plain version as its kernel): the
    gradients with respect to both parts and the affine."""
    rs = np.random.RandomState(1)
    x, x2 = _rand(rs, 2, 4, C1) + 0.5, _rand(rs, 2, 4, C2)
    scale, bias = 1 + _rand(rs, C1 + C2, scale=0.2), _rand(rs, C1 + C2, scale=0.2)
    gsc, gsh = _rand(rs, 2, C1 + C2), _rand(rs, 2, C1 + C2)
    fn = lambda a, b, s, h: jgn.group_norm_fold_cat([a, b], s, h, groups=GROUPS, eps=1e-5)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, x2, scale, bias)))
    want = vjp((jnp.asarray(gsc), jnp.asarray(gsh)))
    leaves = [_t(a).requires_grad_() for a in (x, x2, scale, bias)]
    out = tgn.group_norm_fold(leaves[0], leaves[2], leaves[3], leaves[1], groups=GROUPS,
                              eps=1e-5, kernel=tgn.group_norm_fold_reference)
    got = torch.autograd.grad(out, leaves, (_t(gsc), _t(gsh)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODULE_TOL)


def _conv_inputs(seed):
    rs = np.random.RandomState(seed)
    return (_rand(rs, 2, 5, 6, C1), _rand(rs, 2, 5, 6, C2), _rand(rs, 3, 3, C1 + C2, 24,
                                                                    scale=0.1),
            _rand(rs, 24, scale=0.1), 1 + _rand(rs, 2, C1 + C2, scale=0.3),
            _rand(rs, 2, C1 + C2, scale=0.3), _rand(rs, 2, 24, scale=0.2))


def _oihw(k):
    return _t(k.transpose(3, 2, 0, 1))


def test_two_source_conv_matches_split_cat_conv():
    """conv3x3 with x2 (the plain version and the explicit backward's
    forward) against JAX's _conv3x3_split_cat with the GN-fold prologue and
    the time-embedding shift."""
    x, x2, k, b, sc, sh, post = _conv_inputs(2)
    ref = np.asarray(jb._conv3x3_split_cat(
        jnp.asarray(x), jnp.asarray(x2), jnp.asarray(k), jnp.asarray(b),
        pre=(jnp.asarray(sc), jnp.asarray(sh), True), post_shift=jnp.asarray(post)))
    kw = dict(pre_scale=_t(sc), pre_shift=_t(sh), pre_silu=True, post_shift=_t(post), x2=_t(x2))
    got = tcv.conv3x3(_t(x), _oihw(k), _t(b), **kw)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    wired = tcv.conv3x3(_t(x), _oihw(k), _t(b), kernel=tcv.conv3x3_fused_reference, **kw)
    np.testing.assert_allclose(wired.numpy(), ref, **TOL)


def test_two_source_conv_gradients_match_jax_vjp():
    """_Conv3x3Function's backward with a second source (the plain version
    as the kernel and as dU): dx, dx2, dW, db, dsc, dsh and dpost against
    jax.vjp of _conv3x3_split_cat."""
    x, x2, k, b, sc, sh, post = _conv_inputs(3)
    dy = _rand(np.random.RandomState(4), 2, 5, 6, 24)

    def fn(x, x2, k, b, sc, sh, post):
        return jb._conv3x3_split_cat(x, x2, k, b, pre=(sc, sh, True), post_shift=post)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, x2, k, b, sc, sh, post)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    want[2] = want[2].transpose(3, 2, 0, 1)
    leaves = [_t(a).requires_grad_() for a in (x, x2)] + [_oihw(k).requires_grad_()] + [
        _t(a).requires_grad_() for a in (b, sc, sh, post)]
    y = tcv.conv3x3(leaves[0], leaves[2], leaves[3], pre_scale=leaves[4], pre_shift=leaves[5],
                    pre_silu=True, post_shift=leaves[6], x2=leaves[1],
                    kernel=tcv.conv3x3_fused_reference)
    got = torch.autograd.grad(y, leaves, _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **MODULE_TOL)


def test_conv1x1_cat_matches_jax_forward_and_vjp():
    rs = np.random.RandomState(5)
    x, x2 = _rand(rs, 2, 3, 4, C1), _rand(rs, 2, 3, 4, C2)
    jmod = jb._Conv1x1Cat(features=16)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x2))["params"]
    params = {"kernel": params["kernel"], "bias": params["bias"] + 0.1}
    fn = lambda p, a, c: jmod.apply({"params": p}, a, c)
    ref, vjp = jax.vjp(fn, params, jnp.asarray(x), jnp.asarray(x2))
    tmod = tb.Conv1x1Cat(C1 + C2, 16)
    tmod.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    xs = [_t(a).requires_grad_() for a in (x, x2)]
    got = tmod(*xs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    dy = _rand(rs, 2, 3, 4, 16)
    jp, jdx, jdx2 = vjp(jnp.asarray(dy))
    gx, gx2, gw, gb = torch.autograd.grad(got, xs + [tmod.weight, tmod.bias], _t(dy))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jdx), **MODULE_TOL)
    np.testing.assert_allclose(gx2.numpy(), np.asarray(jdx2), **MODULE_TOL)
    np.testing.assert_allclose(gw[:, :, 0, 0].numpy(), np.asarray(jp["kernel"])[0, 0].T,
                               **MODULE_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jp["bias"]), **MODULE_TOL)
    # one part: the module is the plain 1x1 conv it replaces
    one = tb.Conv1x1Cat(C1, 16)
    assert torch.equal(one(_t(x)), tb.Conv2d.forward(one, _t(x)))


@pytest.mark.parametrize("temb", [None, 24], ids=["no-temb", "temb"])
def test_resnet_block_with_skip_cat_matches_jax(temb):
    """ResnetBlock2D(skip_cat=) against JAX's, the parameters converted and
    loaded strictly; then the gradients with respect to x, the skip and
    every parameter against jax.vjp."""
    rs = np.random.RandomState(6 + (temb or 0))
    x, skip = _rand(rs, 2, 4, 6, C1), _rand(rs, 2, 4, 6, C2)
    t = _rand(rs, 2, temb) if temb else None
    jt = None if t is None else jnp.asarray(t)
    jmod = jb.ResnetBlock2D(out_channels=32)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jt,
                       skip_cat=jnp.asarray(skip))["params"]
    fn = lambda p, a, s: jmod.apply({"params": p}, a, jt, skip_cat=s)
    ref, vjp = jax.vjp(fn, params, jnp.asarray(x), jnp.asarray(skip))
    tmod = tb.ResnetBlock2D(C1 + C2, 32, temb)
    tmod.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    xs = [_t(a).requires_grad_() for a in (x, skip)]
    got = tmod(xs[0], None if t is None else _t(t), skip_cat=xs[1])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **MODULE_TOL)
    dy = _rand(rs, *got.shape)
    jp, jdx, jdskip = vjp(jnp.asarray(dy))
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(got, xs + list(tmod.parameters()), _t(dy))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), **MODULE_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jdskip), **MODULE_TOL)
    want = diffusers_state_dict(jconv.flatten(jp))
    for name, g in zip(names, grads[2:]):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **MODULE_TOL)


def test_up_split_sites_are_the_up_blocks_conv1_sites():
    """The 12 up-block conv1 sites of UP_SPLIT_SITES, with Ci = C1 + C2,
    are the up blocks' "preS+post" sites of UNET_CONV_SITES, launch for
    launch."""
    split = collections.Counter((h, w, c1 + c2, co) for h, w, c1, c2, co in
                                sites.UP_SPLIT_SITES)
    assert len(sites.UP_SPLIT_SITES) == 12
    conv = {(h, w, ci, co): n for h, w, ci, co, epi, n in sites.UNET_CONV_SITES
            if epi == "preS+post" and ci > co}
    assert split == conv


class _CatSpy(TorchDispatchMode):
    """Counts aten.cat at the dispatcher while `armed` (forward and backward
    ops alike)."""

    def __init__(self):
        super().__init__()
        self.armed, self.cats = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.armed and func.overloadpacket is torch.ops.aten.cat:
            self.cats.append(tuple(args[0][0].shape))
        return func(*args, **(kwargs or {}))


def test_up_blocks_build_no_concat():
    """A TINY UNet forward: no aten.cat runs inside the up blocks' spatial
    resnets (which read the skip as a second part) or upsamplers (the plain
    temporal resnet pads its frame axis with one, which the card's kernel
    does not); a ResnetBlock2D with a skip runs none in its forward and
    backward either. The spy sees cats elsewhere, so it is live."""
    torch.manual_seed(0)
    unet = tunet.UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).eval()
    spy = _CatSpy()

    def arm(*_):
        spy.armed += 1

    def disarm(*_):
        spy.armed -= 1

    for block in unet.up_blocks:
        for m in [*(r.spatial_res_block for r in block.resnets), *(block.upsamplers or [])]:
            m.register_forward_pre_hook(arm)
            m.register_forward_hook(disarm)
    x = torch.randn(1, 2, 8, 8, tcfg.TINY_UNET.in_channels)
    ehs = torch.randn(1, 1, tcfg.TINY_UNET.cross_attention_dim)
    with torch.no_grad(), spy:
        unet(x, 10.0, ehs, torch.ones(1, 3))
    assert spy.armed == 0 and spy.cats == []
    spy.armed = 1
    with torch.no_grad(), spy:
        torch.cat([x, x], -1)
    assert spy.cats, "the spy saw no cat"

    block = tb.ResnetBlock2D(C1 + C2, 32, 8)
    xs = [torch.randn(2, 3, 4, c, requires_grad=True) for c in (C1, C2)]
    spy = _CatSpy()
    spy.armed = 1
    with spy:
        y = block(xs[0], torch.randn(2, 8), skip_cat=xs[1])
        torch.autograd.grad(y.sum(), xs + list(block.parameters()))
    assert spy.cats == []
