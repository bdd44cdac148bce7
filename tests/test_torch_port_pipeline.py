"""The port's slice end to end: exact img2vid ``generate`` against the JAX
package's ``generate`` at TINY sizes in float32, with the JAX package's
random draws fed to the port as explicit noise tensors, and the weights
carried by ``state_dict_from_jax``. 3 frames with decode chunks of 2
exercise the ragged last decode chunk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io.convert import state_dict_from_jax

torch.set_num_threads(1)

CFG_KW = dict(height=32, width=32, num_frames=3, num_inference_steps=2,
              decode_chunk_size=2)


@pytest.fixture(scope="module")
def pair():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                device="cpu")
    sds = state_dict_from_jax(jconv.flatten(params))
    tm.unet.load_state_dict(sds["unet"], strict=True)
    tm.vae.load_state_dict(sds["vae"], strict=True)
    tm.clip.load_state_dict(sds["clip"], strict=True)
    return jm, params, tm


def _jax_noise(rng, image_shape, latent_shape):
    """The draws of JAX generate: k_cond, k_init = split(rng); the aug noise
    from split(k_cond)[0]; the latent noise (before * sigma_max) from k_init."""
    k_cond, k_init = jax.random.split(rng)
    k_aug, _ = jax.random.split(k_cond)
    return (np.array(jax.random.normal(k_aug, image_shape, jnp.float32)),
            np.array(jax.random.normal(k_init, latent_shape, jnp.float32)))


def test_generate_matches_jax(pair):
    jm, params, tm = pair
    image = np.random.RandomState(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    ref = np.asarray(jpipe.generate(jm, params, jnp.asarray(image), rng,
                                    jcfg.PipelineConfig(**CFG_KW)))
    h8 = 32 // jcfg.TINY_VAE.downsample_factor
    img_noise, lat_noise = _jax_noise(rng, image.shape, (1, 3, h8, h8, 4))
    got = tpipe.generate(tm, torch.from_numpy(image), tcfg.PipelineConfig(**CFG_KW),
                         image_noise=torch.from_numpy(img_noise),
                         latent_noise=torch.from_numpy(lat_noise)).numpy()
    assert got.shape == ref.shape == (1, 3, 32, 32, 3)
    assert np.isfinite(got).all() and got.min() >= -1.0 and got.max() <= 1.0
    # whole slice in f32: two 700-sigma Euler steps, CLIP, encoder, chunked
    # temporal decode; summation-order differences between XLA and torch
    # stay far below 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_encode_conditioning_and_add_time_ids_match_jax(pair):
    jm, params, tm = pair
    image = np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    k_aug, _ = jax.random.split(rng)
    noise = np.array(jax.random.normal(k_aug, image.shape, jnp.float32))
    j_emb, j_lat = jpipe.encode_conditioning(jm, params, jnp.asarray(image),
                                             jnp.float32(0.02), rng)
    t_emb, t_lat = tpipe.encode_conditioning(tm, torch.from_numpy(image), 0.02,
                                             torch.from_numpy(noise))
    # CLIP and the KL encoder in f32: 1e-4 covers summation order
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        tpipe.get_add_time_ids(6.0, 127.0, 0.02, 2).numpy(),
        np.asarray(jpipe.get_add_time_ids(6.0, 127.0, jnp.float32(0.02), 2)))


@pytest.mark.parametrize("frames,chunk", [(3, 2), (4, 8)])
def test_decode_latents_chunked_matches_jax(pair, frames, chunk):
    jm, params, tm = pair
    lat = np.random.RandomState(frames).randn(1, frames, 4, 4, 4).astype(np.float32) * 0.5
    ref = np.asarray(jpipe.decode_latents_chunked(jm, params, jnp.asarray(lat), chunk))
    got = tpipe.decode_latents_chunked(tm, torch.from_numpy(lat), chunk).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_generate_refuses_unported_modes(pair):
    """An unknown quantisation mode (UNet or VAE) is refused by generate;
    the int8 modes (test_torch_port_quant.py), the cache modes
    (test_torch_port_cache.py) and the Tracklet2Video branch
    (test_torch_port_tracklet.py) are ported: a tracklet UNet builds."""
    _, _, tm = pair
    image = torch.zeros(1, 32, 32, 3)
    for kw in (dict(unet_quant="int4"), dict(vae_quant="int4")):
        with pytest.raises(ValueError, match="unknown quant mode"):
            tpipe.generate(tm, image, tcfg.PipelineConfig(**CFG_KW, **kw))
    built = tpipe.SVDModels.create(dataclasses.replace(tcfg.TINY_UNET, tracklet_dim=8),
                                   tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    assert built.unet.tracklet_conditioner is not None


def test_generate_is_seeded_by_generator(pair):
    _, _, tm = pair
    image = torch.from_numpy(
        np.random.RandomState(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    cfg = tcfg.PipelineConfig(**CFG_KW)
    a = tpipe.generate(tm, image, cfg, generator=torch.Generator().manual_seed(5))
    b = tpipe.generate(tm, image, cfg, generator=torch.Generator().manual_seed(5))
    c = tpipe.generate(tm, image, cfg, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-6


def test_create_builds_on_the_card_by_default():
    """SVDModels.create without `device` builds on the CUDA device where there
    is one, and raises where there is none rather than returning modules on
    the CPU (the CPU tests pass device="cpu")."""
    if torch.cuda.is_available():
        m = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP)
        assert all(p.is_cuda for net in (m.unet, m.vae, m.clip) for p in net.parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP)


def test_generate_frames_uint8_matches_jax(monkeypatch):
    """``generate_frames_uint8``: the same float video (each package's
    ``generate`` stubbed to return it; values past [-1, 1] and on the
    rounding edges of the scale by 255) gives JAX's uint8 frames of row 0
    bit for bit: f32 numpy, clipped, truncated."""
    rs = np.random.RandomState(9)
    video = rs.uniform(-1.1, 1.1, (2, 3, 8, 6, 3)).astype(np.float32)
    video[0, 0, 0, :, 0] = np.array([-1, 1, 0, 1 / 255, 2 / 255 - 1, 1 - 1 / 255],
                                    np.float32)
    monkeypatch.setattr(jpipe, "generate", lambda *a, **k: jnp.asarray(video))
    monkeypatch.setattr(tpipe, "generate", lambda *a, **k: torch.from_numpy(video))
    want = jpipe.generate_frames_uint8(None, None, None, None)
    got = tpipe.generate_frames_uint8(None, None)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == (8, 6, 3)
        np.testing.assert_array_equal(a, b)
