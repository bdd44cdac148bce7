"""The port's parity-decomposed upsample (ops/upsample.py, the wrapper
ops/kernels/upsample_conv.py, models/blocks.py::Upsample2D) against the JAX
package's default form (svd_xtend_tpu/ops/upsample.py::upsample2x_conv3x3 and
its Upsample2D), in f32 on the CPU from numpy seeds; the gradients against
jax.vjp; and the upsample kernel's launch plans at every site of the main
paths. The CUDA kernel itself runs only on a GPU:
tests/test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import blocks as jb
from svd_xtend_tpu.ops import upsample as jup
from svd_xtend_tpu_torch.io.convert import diffusers_state_dict
from svd_xtend_tpu_torch.models import blocks as tb
from svd_xtend_tpu_torch.ops import upsample as tup
from svd_xtend_tpu_torch.ops import video
from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uck
from svd_xtend_tpu_torch.ops.kernels.gemm_plan import K_TILE, MAX_BOX, SM_COUNT
from svd_xtend_tpu_torch.scripts import sites
from test_torch_port_plan import _check_cover, _source_widths

torch.set_num_threads(1)

# f32: the two forms differ only in the order of the tap sums and the
# conv's 4·Ci products (XLA's conv against torch's CPU conv)
TOL = dict(atol=1e-5, rtol=1e-5)
# gradients: sums over every output pixel (dW, db), O(1-10) values
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", [(2, 4, 6, 16, 24), (1, 5, 7, 8, 8), (3, 1, 1, 4, 12)],
                         ids=["even", "odd", "one-pixel"])
def test_reference_matches_jax_upsample(shape):
    """upsample2x_conv3x3_reference against JAX's upsample2x_conv3x3, odd H
    and W included, and against the materialised form (nearest upsample,
    then the 3x3 SAME conv)."""
    n, h, w, ci, co = shape
    rs = np.random.RandomState(sum(shape))
    x, k, b = _rand(rs, n, h, w, ci), _rand(rs, 3, 3, ci, co, scale=0.2), _rand(rs, co)
    ref = np.asarray(jup.upsample2x_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = tup.upsample2x_conv3x3_reference(torch.from_numpy(x), _oihw(k), torch.from_numpy(b))
    assert got.shape == (n, 2 * h, 2 * w, co)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    up = F.interpolate(video.nchw(torch.from_numpy(x)), scale_factor=2.0, mode="nearest")
    naive = video.nhwc(F.conv2d(up, _oihw(k), torch.from_numpy(b), padding=1))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **TOL)


def test_tap_sums_are_summed_in_the_activation_dtype():
    """The parity kernels are sums of the weight cast to the activation
    dtype first (JAX's order): in bf16 they equal JAX's bit for bit."""
    rs = np.random.RandomState(3)
    k = _rand(rs, 3, 3, 8, 4)
    kk = tup.tap_sums(_oihw(k), torch.bfloat16)
    assert kk.shape == (4, 4, 2, 2, 8) and kk.dtype == torch.bfloat16
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    rows = {0: jnp.stack([kb[0], kb[1] + kb[2]]), 1: jnp.stack([kb[0] + kb[1], kb[2]])}
    for di in (0, 1):
        r = rows[di]
        cols = {0: jnp.stack([r[:, 0], r[:, 1] + r[:, 2]], axis=1),
                1: jnp.stack([r[:, 0] + r[:, 1], r[:, 2]], axis=1)}
        for dj in (0, 1):
            want = np.asarray(cols[dj].astype(jnp.float32)).transpose(3, 0, 1, 2)  # (Co, 2, 2, Ci)
            np.testing.assert_array_equal(kk[2 * di + dj].float().numpy(), want)


def test_upsample2d_module_matches_jax():
    """The port's Upsample2D (diffusers keys conv.weight / conv.bias, loaded
    strictly from the JAX module's converted parameters) against JAX's
    Upsample2D at its default (the parity form)."""
    rs = np.random.RandomState(7)
    x = _rand(rs, 2, 3, 5, 32)
    jmod = jb.Upsample2D(out_channels=32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tb.Upsample2D(32)
    tmod.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_upsample_gradients_match_jax_vjp():
    """The wrapper's explicit backward (the plain versions as its kernels,
    the CUDA launch's wiring: dX the 2x2 sums of conv3x3's dU, dW the 3x3
    conv's weight gradient over the upsampled x, db): dX, dW and db against
    jax.vjp of JAX's upsample2x_conv3x3."""
    rs = np.random.RandomState(11)
    x, k, b = _rand(rs, 2, 3, 4, 8), _rand(rs, 3, 3, 8, 6, scale=0.3), _rand(rs, 6)
    dy = _rand(rs, 2, 6, 8, 6)
    _, vjp = jax.vjp(jup.upsample2x_conv3x3, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    jdx, jdk, jdb = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _oihw(k).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = uck.upsample_conv(xt, wt, bt, kernel=tup.upsample2x_conv3x3_reference)
    assert y.grad_fn is not None
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), jdk.transpose(3, 2, 0, 1), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), jdb, **GRAD_TOL)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    rs = np.random.RandomState(2)
    x, k, b = _rand(rs, 1, 2, 2, 64), _rand(rs, 3, 3, 64, 8), _rand(rs, 8)
    before = uck.upsample_conv.launches
    got = uck.upsample_conv(torch.from_numpy(x), _oihw(k), torch.from_numpy(b))
    ref = tup.upsample2x_conv3x3_reference(torch.from_numpy(x), _oihw(k), torch.from_numpy(b))
    assert torch.equal(got, ref)
    assert uck.upsample_conv.launches == before
    assert not uck.supports(torch.from_numpy(x).bfloat16(), _oihw(k))   # not on a card


# ------------------------------------------------------------- launch plans --

def _upsample_sites():
    """(n, h, w, c) of every upsample launch of the main paths: the UNet's
    three at CFG batch 28 and training batch 14, the VAE decoder's three per
    chunk of 8 frames and the last chunk of 6, and each at 1024x576 (twice
    each spatial dimension); and generate's in portrait, 512x320 and
    1024x576."""
    out = set(sites.PORTRAIT_UPSAMPLE_SHAPES)
    for n, h, w, c, _, _ in sites.UPSAMPLE_SITES:
        out |= {(n, h, w, c), (n, 2 * h, 2 * w, c)}
    return sorted(out)


def test_upsample_sites_follow_the_configs():
    """UPSAMPLE_SITES: the UNet's upsamplers (levels 3, 2, 1 at CFG batch 28
    and training batch 14) and the VAE decoder's (levels 0-2 of a decode
    chunk of 8 and the last of 6) at 512x320; launches per exact video 81
    (25 passes x 3 + 2 chunks x 3), per train step 6 (the forward and the
    remat recompute of the up blocks)."""
    assert sites.UPSAMPLE_SITES == [
        (28, 5, 8, 1280, 25, 0), (28, 10, 16, 1280, 25, 0), (28, 20, 32, 640, 25, 0),
        (14, 5, 8, 1280, 0, 2), (14, 10, 16, 1280, 0, 2), (14, 20, 32, 640, 0, 2),
        (8, 40, 64, 512, 1, 0), (8, 80, 128, 512, 1, 0), (8, 160, 256, 256, 1, 0),
        (6, 40, 64, 512, 1, 0), (6, 80, 128, 512, 1, 0), (6, 160, 256, 256, 1, 0)]
    assert sum(st[4] for st in sites.UPSAMPLE_SITES) == 81
    assert sum(st[5] for st in sites.UPSAMPLE_SITES) == 6


@pytest.mark.parametrize("site", _upsample_sites(), ids=lambda s: "-".join(map(str, s)))
def test_upsample_plan_at_site(site):
    """A TMA plan at a width the source instantiates and the store at W
    takes, K = 4·Ci in tiles of 64, covering the four parities' padded rows
    once."""
    n, h, w, c = site
    assert uck.UPSAMPLE_TILE_N == _source_widths("SVDX_UPSAMPLE_TILE_N")
    plan = uck.upsample_plan(n, h, w, c, c)
    assert plan.mainloop == "tma" and plan.bn in uck.tile_widths(w) and plan.bm == 128
    m_pad = uck.padded_rows(n, h, w)
    assert m_pad % 128 == 0 and m_pad - 128 < n * h * w <= m_pad
    assert (plan.m, plan.n, plan.k_tiles) == (4 * m_pad, c, 4 * c // K_TILE)
    assert all(1 <= d <= MAX_BOX for d in (*plan.a_box, *plan.b_box))
    _check_cover(plan)
    assert 1 <= plan.grid <= min(plan.n_items, SM_COUNT)
    assert uck.upsample_plan(n, h, w, c, c) is plan


@pytest.mark.parametrize("w", [1, 2, 5, 8, 9, 10, 12, 18, 20, 36, 40, 64, 72, 80, 100, 128,
                               144, 160, 288])
def test_upsample_epilogue_stores_cover_every_row_once(w):
    """The epilogue's stores at image width W (csrc/upsample_conv.cu's
    store_run and store_tile, modelled here): a consumer warpgroup's 64
    rows go out in boxes of `run` pixels of one image row (or, where W
    divides 64, of 64/W whole rows), each row exactly once, each box's
    first row at a 128-byte boundary of the shared-memory tile for every
    tile width the plan may pick."""
    run = uck.store_run(w)
    assert uck.tile_widths(w) and set(uck.tile_widths(w)) <= set(uck.UPSAMPLE_TILE_N)
    for local in range(0, 4 * max(w, 64), 64):     # a warpgroup's first row
        step = run if run < w else 64
        seen = []
        for p in range(0, 64, step):
            rows = 64 if run == w else run         # pixels the box covers
            r0, j0 = divmod(local + p, w)
            assert run == w or j0 + run <= w       # within one image row
            assert run != w or j0 == 0             # whole image rows
            seen += range(local + p, local + p + min(rows, 64 - p))
            for bn in uck.tile_widths(w):
                assert p == 0 or p * bn * 2 % 128 == 0
        assert seen == list(range(local, local + 64))
