"""The cache modes of the port's ``generate`` (the CFG cache and DeepCache,
alone and composed) against the JAX package's ``generate`` at TINY sizes in
float32, with the JAX draws fed to the port as explicit noise, and the
DeepCache split of the port's UNet: ``shallow(x, full(x).deep) == full(x)``
and its argument checks. The configurations are those of
``tests/test_pipeline.py``'s cache-mode tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
from test_torch_port_pipeline import _jax_noise, pair  # noqa: F401  (the module fixture)

torch.set_num_threads(1)

CFG_KW = dict(height=32, width=32, num_frames=2, num_inference_steps=4,
              decode_chunk_size=2)


@pytest.mark.parametrize("knobs", [dict(uncond_reuse_interval=2),
                                   dict(deep_cache_interval=2),
                                   dict(deep_cache_interval=2, uncond_reuse_interval=2),
                                   dict(deep_cache_interval=4)],
                         ids=["k2", "n2", "n2k2", "n4"])
def test_cache_mode_generate_matches_jax(pair, knobs):
    """Four Euler steps: k2 alternates pair and cond-only steps; n2 full and
    shallow pairs; n2k2 the composed schedule (full pair on the uncond
    refreshes, shallow cond-only passes between); n4 one full pair, then
    three shallow ones."""
    jm, params, tm = pair
    image = np.random.RandomState(3).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    ref = np.asarray(jpipe.generate(jm, params, jnp.asarray(image), rng,
                                    jcfg.PipelineConfig(**CFG_KW, **knobs)))
    h8 = 32 // jcfg.TINY_VAE.downsample_factor
    img_noise, lat_noise = _jax_noise(rng, image.shape, (1, 2, h8, h8, 4))
    got = tpipe.generate(tm, torch.from_numpy(image),
                         tcfg.PipelineConfig(**CFG_KW, **knobs),
                         image_noise=torch.from_numpy(img_noise),
                         latent_noise=torch.from_numpy(lat_noise)).numpy()
    assert got.shape == ref.shape == (1, 2, 32, 32, 3)
    assert np.isfinite(got).all()
    # the exact path's tolerance (test_torch_port_pipeline.py): f32 throughout,
    # XLA and torch differ only in summation order
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def _unet_inputs(cfg, frames=2, size=16, seed=0):
    rs = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    return (t(1, frames, size, size, cfg.in_channels), torch.tensor(0.7),
            t(1, 1, cfg.cross_attention_dim), torch.tensor([[6.0, 127.0, 0.02]]))


def _four_level_unet():
    cfg = tcfg.UNetConfig(
        sample_size=16, block_out_channels=(32, 32, 64, 64),
        down_block_types=("CrossAttnDownBlockSpatioTemporal",) * 3
        + ("DownBlockSpatioTemporal",),
        up_block_types=("UpBlockSpatioTemporal",)
        + ("CrossAttnUpBlockSpatioTemporal",) * 3,
        layers_per_block=1, transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(2, 2, 4, 4), cross_attention_dim=32,
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
        num_frames=2)
    g = torch.Generator().manual_seed(1)
    return tpipe.init_random_(UNetSpatioTemporalConditionModel(cfg), g).eval(), cfg


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_shallow_forward_equals_full(depth):
    """DeepCache contract at every cache depth of a 4-level UNet (the SVD
    topology): the full forward with ``return_deep`` returns the plain output
    and the input of up block n_up - depth; the shallow forward on that deep
    feature equals the full output bit for bit (the same operations on the
    same tensors), so its skips are exactly those the retained up blocks pop."""
    unet, cfg = _four_level_unet()
    args = _unet_inputs(cfg)
    with torch.no_grad():
        full = unet(*args)
        out, deep = unet(*args, return_deep=True, cache_depth=depth)
        shallow = unet(*args, cached_deep=deep, cache_depth=depth)
    assert torch.equal(out, full) and torch.equal(shallow, full)
    side = 16 // 2 ** (depth - 1)
    assert deep.shape == (1, 2, side, side, tuple(reversed(cfg.block_out_channels))[-depth - 1])


def test_split_forward_argument_checks():
    unet, cfg = _four_level_unet()
    args = _unet_inputs(cfg)
    with torch.no_grad():
        for depth in (0, 4):
            with pytest.raises(ValueError, match="cache_depth"):
                unet(*args, return_deep=True, cache_depth=depth)
        deep = torch.zeros(1, 2, 16, 16, 32)
        with pytest.raises(ValueError, match="exclusive"):
            unet(*args, cached_deep=deep, return_deep=True)
