"""The port's evaluation and profiling utilities (utils/metrics.py,
utils/profiling.py) against the JAX package's (svd_xtend_tpu/utils/), on
the CPU: every metric on TINY_CLIP with the JAX tower's weights converted
into the port's, from numpy seeds, in f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models.clip import CLIPVisionModelWithProjection as JC
from svd_xtend_tpu.utils import metrics as jm
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.io.convert import clip_state_dict
from svd_xtend_tpu_torch.models.clip import CLIPVisionModelWithProjection as TC
from svd_xtend_tpu_torch.utils import metrics as tm
from svd_xtend_tpu_torch.utils import profiling as tp

torch.set_num_threads(1)

# f32 CLIP towers (summation order only) and cosines of their embeddings
TOL = dict(atol=1e-5, rtol=1e-5)
# the Fréchet distance: a difference of traces and eigenvalue square roots
# in f32, O(1) with O(1) terms cancelling
FVD_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def towers():
    """JAX's TINY_CLIP parameters, and the port's tower holding them."""
    px = jnp.zeros((1, jcfg.TINY_CLIP.image_size, jcfg.TINY_CLIP.image_size, 3))
    params = JC(jcfg.TINY_CLIP, dtype=jnp.float32).init(jax.random.PRNGKey(0), px)["params"]
    clip = TC(tcfg.TINY_CLIP)
    clip.load_state_dict(clip_state_dict(jconv.flatten(params), tcfg.TINY_CLIP.patch_size),
                         strict=True)
    return params, clip.eval()


def _videos(seed, b=2, f=3, h=20, w=24):
    rs = np.random.RandomState(seed)
    video = np.clip(rs.randn(b, f, h, w, 3) * 0.5, -1, 1).astype(np.float32)
    cond = np.clip(rs.randn(b, h, w, 3) * 0.5, -1, 1).astype(np.float32)
    return video, cond


def _np(t):
    return t.detach().numpy()


def test_clip_metrics_match_jax(towers):
    params, clip = towers
    video, cond = _videos(0)
    jv, jc = jnp.asarray(video), jnp.asarray(cond)
    tv, tcnd = torch.from_numpy(video), torch.from_numpy(cond)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tm.clip_frame_similarity(clip, tcnd, tv)), np.asarray(
            jm.clip_frame_similarity(params, jcfg.TINY_CLIP, jc, jv)), **TOL)
        np.testing.assert_allclose(_np(tm.temporal_consistency(clip, tv)), np.asarray(
            jm.temporal_consistency(params, jcfg.TINY_CLIP, jv)), **TOL)
        got = tm.video_report(clip, tcnd, tv)
        want = jm.video_report(params, jcfg.TINY_CLIP, jc, jv)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(_np(tm.clip_video_features(clip, tv)), np.asarray(
            jm.clip_video_features(params, jcfg.TINY_CLIP, jv)), **TOL)


def test_pixel_metrics_match_jax():
    video, _ = _videos(1)
    other = np.clip(video + 0.05 * np.random.RandomState(2).randn(*video.shape), -1,
                    1).astype(np.float32)
    tv, to = torch.from_numpy(video), torch.from_numpy(other)
    np.testing.assert_allclose(_np(tm.psnr(tv, to)), np.asarray(
        jm.psnr(jnp.asarray(video), jnp.asarray(other))), **TOL)
    np.testing.assert_allclose(_np(tm.psnr(tv, tv)), np.asarray(
        jm.psnr(jnp.asarray(video), jnp.asarray(video))), **TOL)      # mse floored at 1e-12
    np.testing.assert_allclose(_np(tm.flicker(tv)), np.asarray(jm.flicker(jnp.asarray(video))),
                               **TOL)
    for scale in (2400.0, 1e5):
        got = tm.estimate_motion_bucket(tv, scale=scale)
        want = np.asarray(jm.estimate_motion_bucket(jnp.asarray(video), scale=scale))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_frechet_distance_matches_jax():
    rs = np.random.RandomState(3)
    a = rs.randn(40, 12).astype(np.float32)
    b = (rs.randn(40, 12) * 1.3 + 0.2).astype(np.float32)
    ja, jb_ = jm.gaussian_stats(jnp.asarray(a)), jm.gaussian_stats(jnp.asarray(b))
    ta, tb_ = tm.gaussian_stats(torch.from_numpy(a)), tm.gaussian_stats(torch.from_numpy(b))
    for g, w in zip((*ta, *tb_), (*ja, *jb_)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    got = tm.frechet_distance(*ta, *tb_)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(jm.frechet_distance(*ja, *jb_)), **FVD_TOL)
    same = tm.frechet_distance(*ta, *ta)
    assert abs(float(same)) < 1e-2


def test_clip_fvd_matches_jax(towers):
    params, clip = towers
    real, _ = _videos(4, b=4)
    fake, _ = _videos(5, b=4)
    with torch.no_grad():
        got = tm.clip_fvd(clip, torch.from_numpy(real), torch.from_numpy(fake))
    want = jm.clip_fvd(params, jcfg.TINY_CLIP, jnp.asarray(real), jnp.asarray(fake))
    np.testing.assert_allclose(_np(got), np.asarray(want), **FVD_TOL)


def test_profiling_trace_and_block_on(tmp_path):
    with tp.trace(str(tmp_path)):
        y = torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert tp.block_on(y) == 512.0 and tp.block_on(3) == 3.0
