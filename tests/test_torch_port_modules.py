"""The port's modules against their JAX modules, at small widths in float32,
with the JAX-initialised weights carried by the port's converter and loaded
strictly: every module that holds a kernel (GroupNormSiLU,
SpatioTemporalResBlock/TemporalResnetBlock, Attention, FrameAxisAttention,
TransformerSpatioTemporalModel) and the whole models (UNet, VAE encode and
decode, CLIP) at the TINY configs, plus the full-width UNet (``slow``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import blocks as jb
from svd_xtend_tpu.models import transformer as jt
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.io.convert import clip_state_dict, diffusers_state_dict
from svd_xtend_tpu_torch.models import blocks as tb
from svd_xtend_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

# modules in f32: only summation order differs (XLA vs torch CPU kernels);
# outputs are O(1-10), so 1e-4 absolute/relative
TOL = dict(atol=1e-4, rtol=1e-4)


def _init(jmod, *args):
    params = jmod.init(jax.random.PRNGKey(0), *[jnp.asarray(a) if a is not None else None
                                                for a in args])["params"]
    out = np.asarray(jmod.apply({"params": params},
                                *[jnp.asarray(a) if a is not None else None for a in args]))
    return params, out


def _load(tmod, params, clip=False):
    flat = jconv.flatten(params)
    sd = clip_state_dict(flat, tcfg.TINY_CLIP.patch_size) if clip else diffusers_state_dict(flat)
    tmod.load_state_dict(sd, strict=True)
    return tmod.eval()


def _run(tmod, *args, **kw):
    with torch.no_grad():
        return tmod(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                      for a in args], **kw).numpy()


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_group_norm_silu_module(silu, eps):
    x = _rand(0, 2, 5, 6, 64) + 0.3
    params, ref = _init(jb.GroupNormSiLU(groups=32, eps=eps, silu=silu), x)
    got = _run(_load(tb.GroupNormSiLU(64, 32, eps, silu), params), x)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("cin,cout,temb,skip", [(64, 64, 32, 0), (32, 64, 32, 0),
                                                (64, 64, None, 0), (64, 64, 32, 32)])
def test_spatio_temporal_res_block(cin, cout, temb, skip):
    """Spatial resnet + temporal resnet (collapsed blend); the VAE form has
    no temb, merge_factor 0 and temporal eps 1e-5; skip > 0 is the up-block
    concat."""
    f = 3
    x = _rand(1, 2 * f, 4, 4, cin)
    t = _rand(2, 2 * f, temb) if temb else None
    s = _rand(3, 2 * f, 4, 4, skip) if skip else None
    kw = dict(merge_factor=0.0, temporal_eps=1e-5, eps=1e-6) if temb is None else {}
    jmod = jb.SpatioTemporalResBlock(cout, num_frames=f, **kw)
    args = (jnp.asarray(x), None if t is None else jnp.asarray(t))
    params = jmod.init(jax.random.PRNGKey(0), *args,
                       skip_cat=None if s is None else jnp.asarray(s))["params"]
    ref = np.asarray(jmod.apply({"params": params}, *args,
                                skip_cat=None if s is None else jnp.asarray(s)))
    tmod = _load(tb.SpatioTemporalResBlock(cin + skip, cout, temb, **kw), params)
    xin = x if s is None else np.concatenate([x, s], -1)
    got = _run(tmod, xin, None if t is None else torch.from_numpy(t), num_frames=f)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_module(cross):
    x = _rand(4, 2, 40, 128)
    ctx = _rand(5, 2, 1, 32) if cross else None
    params, ref = _init(jt.Attention(2, 64), x, ctx)
    got = _run(_load(tt.Attention(128, 2, 64, context_dim=32 if cross else None), params),
               x, None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("f,cross", [(3, False), (14, False), (3, True)])
def test_frame_axis_attention_module(f, cross):
    x = _rand(6, 2, f, 10, 128)
    ctx = _rand(7, 2, 1, 32) if cross else None
    params, ref = _init(jt.FrameAxisAttention(2, 64), x, ctx)
    got = _run(_load(tt.FrameAxisAttention(128, 2, 64, context_dim=32 if cross else None),
                     params), x, None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("temporal", [False, True])
def test_transformer_blocks_with_geglu_on(monkeypatch, temporal):
    """BasicTransformerBlock and TemporalBasicTransformerBlock with the JAX
    package's fused GEGLU forced on (the Pallas kernel in interpret mode,
    SVDX_PALLAS_GEGLU=force) against the port's blocks, whose feed-forwards
    go through ln_geglu_residual (its plain version on the CPU)."""
    monkeypatch.setenv("SVDX_PALLAS_GEGLU", "force")
    shape = (2, 4, 10, 64) if temporal else (2, 40, 64)
    x = _rand(10, *shape)
    ctx = _rand(11, 2, 1, 32)
    jcls = jt.TemporalBasicTransformerBlock if temporal else jt.BasicTransformerBlock
    tcls = tt.TemporalBasicTransformerBlock if temporal else tt.BasicTransformerBlock
    params, ref = _init(jcls(1, 64), x, ctx)
    got = _run(_load(tcls(64, 1, 64, 32), params), x, torch.from_numpy(ctx))
    np.testing.assert_allclose(got, ref, **TOL)


def test_transformer_spatio_temporal_model():
    f, b = 3, 2
    x = _rand(8, b * f, 4, 5, 64)
    ehs = _rand(9, b * f, 1, 32)
    jmod = jt.TransformerSpatioTemporalModel(1, 64, num_layers=1, num_frames=f)
    params, ref = _init(jmod, x, ehs)
    tmod = _load(tt.TransformerSpatioTemporalModel(64, 1, 64, 32, 1), params)
    got = _run(tmod, x, torch.from_numpy(ehs), num_frames=f)
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------- whole models --

def _unet_pair(jc, tc, b, f, h, w, seed):
    from svd_xtend_tpu.models.unet import UNetSpatioTemporalConditionModel as JU
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel as TU
    rs = np.random.RandomState(seed)
    sample = rs.randn(b, f, h, w, jc.in_channels).astype(np.float32)
    ehs = rs.randn(b, 1, jc.cross_attention_dim).astype(np.float32)
    ids = np.tile(np.array([[6.0, 127.0, 0.02]], np.float32), (b, 1))
    t = np.float32(0.25 * np.log(37.0))
    jm = JU(jc, dtype=jnp.float32)
    args = (jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ehs), jnp.asarray(ids))
    params = jm.init(jax.random.PRNGKey(seed), *args)["params"]
    ref = np.asarray(jm.apply({"params": params}, *args))
    tm = _load(TU(tc), params)
    del params
    got = _run(tm, sample, torch.tensor(t), torch.from_numpy(ehs), torch.from_numpy(ids))
    return got, ref


def test_unet_matches_jax_tiny():
    got, ref = _unet_pair(jcfg.TINY_UNET, tcfg.TINY_UNET, 2, 3, 8, 8, 1)
    assert got.shape == ref.shape == (2, 3, 8, 8, 4)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)


@pytest.mark.slow
def test_unet_matches_jax_full_width():
    """UNetConfig() widths (320/640/1280/1280, heads 5/10/20/20, context
    1024) on a 16x16 latent with 2 frames; f32 through the full depth."""
    got, ref = _unet_pair(jcfg.UNetConfig(), tcfg.UNetConfig(), 1, 2, 16, 16, 2)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_vae_encode_decode_match_jax_tiny():
    from svd_xtend_tpu.models.vae import AutoencoderKLTemporalDecoder as JV
    from svd_xtend_tpu_torch.models.vae import AutoencoderKLTemporalDecoder as TV
    img = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = _rand(4, 1, 3, 16, 16, 4)
    jm = JV(jcfg.TINY_VAE, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img), jax.random.PRNGKey(1))["params"]
    ref_mode = np.asarray(jm.apply({"params": params}, jnp.asarray(img), method=jm.encode).mode())
    ref_dec = np.asarray(jm.apply({"params": params}, jnp.asarray(z), method=jm.decode))
    tm = _load(TV(tcfg.TINY_VAE), params)
    with torch.no_grad():
        got_mode = tm.encode(torch.from_numpy(img)).mode().numpy()
        got_dec = tm.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got_mode, ref_mode, **TOL)
    np.testing.assert_allclose(got_dec, ref_dec, **TOL)


def test_clip_matches_jax_tiny():
    from svd_xtend_tpu.models.clip import CLIPVisionModelWithProjection as JC
    from svd_xtend_tpu_torch.models.clip import CLIPVisionModelWithProjection as TC
    px = _rand(5, 2, 28, 28, 3)
    params, ref = _init(JC(jcfg.TINY_CLIP, dtype=jnp.float32), px)
    got = _run(_load(TC(tcfg.TINY_CLIP), params, clip=True), px)
    np.testing.assert_allclose(got, ref, **TOL)
