"""The GroupNorm fold without launches of its own, on the CPU.

- The temporal resnet block's wiring (``temporal_resnet._launch_block``) with
  CPU stand-ins for its launches: one fold (norm1), kernel A, whose (sc2,
  sh2) go to kernel B as they are, and no ``fold_from_partials``; against
  ``temporal_resnet_reference`` and the JAX package's
  ``temporal_resnet_block``.
- The fold's order (``groupnorm.fold_order_reference``, the f32 sums of
  csrc/gn_stats.cuh's ``fold_phase``, the order of the fold launch it
  replaced): at every fold site of ``scripts/sites.py`` (group_norm_fold's,
  kernel A's norm2 and group_norm_silu's two-pass samples) within f32
  rounding of the exact sums, and where small bit for bit a literal loop of
  the kernel's.
- The constants the kernels and their wrappers share.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.ops.pallas import temporal_resnet as jtr
from svd_xtend_tpu_torch.ops.kernels import flash_chain as tfc
from svd_xtend_tpu_torch.ops.kernels import groupnorm as tgn
from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as ttr
from svd_xtend_tpu_torch.scripts import sites

CSRC = Path(ttr.__file__).resolve().parents[2] / "csrc"
ATOL = RTOL = 2e-5


def _tresnet_args(rs, b, f, s, c):
    r = lambda *sh, sc=1.0: (rs.randn(*sh) * sc).astype(np.float32)
    return [r(b, f, s, c), r(b, f, c), r(3, c, c, sc=0.1), r(c, sc=0.1), r(3, c, c, sc=0.1),
            r(c, sc=0.1), 1 + r(c, sc=0.1), r(c, sc=0.1), 1 + r(c, sc=0.1), r(c, sc=0.1),
            np.float32(0.37)]


@pytest.mark.parametrize("b,f,s,c,groups", [(2, 5, 16, 64, 8), (1, 3, 24, 128, 32)])
def test_block_wiring_one_fold_and_a_folds_norm2(monkeypatch, b, f, s, c, groups):
    args = _tresnet_args(np.random.RandomState(b * f + s), b, f, s, c)
    calls = []

    def fold(x, scale, bias, x2=None, *, groups, eps):
        calls.append("fold")
        return tgn.group_norm_fold_reference(x, scale, bias, x2, groups=groups, eps=eps)

    handed = {}

    def conv_a(x, k, bias, sc, sh, t, scale2, bias2, groups, eps, plan=None):
        calls.append("conv_a")
        h = ttr.conv_a_reference(x, k, bias, sc, sh, t)[0]
        psum, psq = tgn.channel_stats_reference(h.reshape(-1, h.shape[-1]), f * s)
        handed["a"] = ttr.norm2_fold_reference(h, scale2, bias2, groups, eps)
        return (h, psum, psq, *handed["a"])

    def conv_b(h, k, bias, sc, sh, res, w):
        calls.append("conv_b")
        handed["b"] = (sc, sh)
        return ttr.conv_b_reference(h, k, bias, sc, sh, res, w)

    def no_launch(*a, **k):
        raise AssertionError("fold_from_partials launched on the block's path")

    monkeypatch.setattr(ttr, "_validate", lambda *a: None)
    monkeypatch.setattr(ttr, "packed", lambda k, bias: (k, bias))   # the taps as they are
    monkeypatch.setattr(ttr, "group_norm_fold", fold)
    monkeypatch.setattr(ttr, "conv_a", conv_a)
    monkeypatch.setattr(ttr, "conv_b", conv_b)
    monkeypatch.setattr(tgn, "fold_from_partials", no_launch)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = ttr._launch_block(*targs, groups=groups, eps=1e-5)
    assert calls == ["fold", "conv_a", "conv_b"]
    assert all(x is y for x, y in zip(handed["a"], handed["b"]))
    ref = ttr.temporal_resnet_reference(*targs, groups, 1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    jax_out = np.asarray(jtr.temporal_resnet_block(*[jnp.asarray(a) for a in args],
                                                   groups=groups, eps=1e-5))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=ATOL, rtol=RTOL)


def _check_order(n, rows, c, groups=32, seed=0):
    """fold_order_reference on seeded partials of the shape: within f32
    rounding of the float64 sums, and, where the shape is small, bit for
    bit a literal loop of the kernel's order (thread t the values t, t +
    256, ... of the group in (slot, channel) order, then the tree)."""
    slots, gs = tgn.stats_slots(rows), c // groups
    rs = np.random.RandomState(seed)
    psum = torch.from_numpy(rs.randn(n, slots, c).astype(np.float32))
    psq = torch.from_numpy(rs.rand(n, slots, c).astype(np.float32))
    got = tgn.fold_order_reference(psum, psq, groups)
    for part, sums in zip((psum, psq), got):
        want = part.double().reshape(n, slots, groups, gs).sum((1, 3))
        scale = part.double().abs().reshape(n, slots, groups, gs).sum((1, 3))
        assert sums.shape == (n, groups)
        assert ((sums.double() - want).abs() <= 1e-6 * scale + 1e-30).all()
    if slots * gs * n * groups > 40000:
        return
    for b in range(n):
        for g in range(groups):
            vals = [psum[b, i // gs, g * gs + i % gs].numpy() for i in range(slots * gs)]
            red = [np.float32(0)] * tgn.FOLD_THREADS
            for i, v in enumerate(vals):
                red[i % tgn.FOLD_THREADS] = np.float32(red[i % tgn.FOLD_THREADS] + v)
            h = tgn.FOLD_THREADS // 2
            while h:
                red[:h] = [np.float32(red[t] + red[t + h]) for t in range(h)]
                h //= 2
            assert got[0][b, g].numpy() == red[0]


@pytest.mark.parametrize("site", sites.FOLD_SITES, ids=lambda st: "-".join(map(str, st[0])))
def test_fold_order_group_norm_fold_sites(site):
    """group_norm_fold's order at every shape an exact video folds."""
    shape = site[0]
    _check_order(shape[0], math.prod(shape[1:-1]), shape[-1])


@pytest.mark.parametrize("site", sites.TRESNET_SITES, ids=lambda st: "-".join(map(str, st[:4])))
def test_fold_order_kernel_a_sites(site):
    """Kernel A's norm2 fold at every temporal resnet shape of the paths."""
    b, f, s, c = site[:4]
    _check_order(b, f * s, c)


@pytest.mark.parametrize("site", [st for st in sites.GN_SITES
                                  if tgn.group_norm_plan(st[0], torch.bfloat16, 32).path
                                  == "two_pass"], ids=lambda st: "-".join(map(str, st[0])))
def test_fold_order_two_pass_group_norm(site):
    """group_norm_silu's two-pass samples (the VAE's)."""
    shape = site[0]
    _check_order(shape[0], math.prod(shape[1:-1]), shape[-1])


@pytest.mark.parametrize("rows,n,c,groups", [(40, 3, 320, 32), (1, 5, 64, 32), (64, 2, 128, 32),
                                             (65, 4, 2560, 32), (560, 2, 1280, 32),
                                             (100, 3, 8, 4), (900, 1, 64, 1)])
def test_fold_order_small_and_ragged(rows, n, c, groups):
    """Samples shorter than a chunk, exactly one, a row past it, a group of
    more than 256 values, one group: bit for bit the kernel's loop."""
    _check_order(n, rows, c, groups)


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def test_shared_constants():
    """The wrappers' constants are the kernels' (csrc/gn_stats.cuh,
    csrc/flash_chain.cu)."""
    stats = (CSRC / "gn_stats.cuh").read_text()
    assert _constant(stats, "kChunkRows") == tgn.STATS_ROWS
    assert _constant(stats, "kFoldThreads") == tgn.FOLD_THREADS
    words = re.search(r"constexpr int kArrive = (\d+), kExit = (\d+);", stats)
    assert int(words.group(1)) < int(words.group(2)) < tgn.BARRIER_WORDS
    chain = (CSRC / "flash_chain.cu").read_text()
    assert _constant(chain, "kRows") == tfc.ROWS
    words = re.search(r"constexpr int kArrive = 0, kExit = (\d+), kMax = (\d+);", chain)
    assert int(words.group(2)) + 2 * 32 < tfc.WS_WORDS       # three maxima slots
    assert _constant(chain, "kMaxCluster") >= max(tfc.CLUSTER, tfc.CLUSTER_INT8)


@pytest.mark.parametrize("bkm,cluster", [(640, 4), (1280, 4), (1536, 4), (128, 4), (64, 2)])
def test_chain_key_slices(bkm, cluster):
    """The cluster's key split covers the keys once, in 64-key blocks."""
    k = tfc.cluster_size(bkm, cluster)
    slices = tfc.key_slices(bkm, k)
    assert k <= cluster and k <= bkm // 64 and slices[0][0] == 0 and slices[-1][1] == bkm
    assert all(a < b and a % 64 == 0 for a, b in slices)
    assert all(b == n for (_, b), (n, _) in zip(slices, slices[1:]))
