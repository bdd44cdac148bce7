"""The PyTorch port's foundations against the JAX package: config copies,
import hygiene, EDM/scheduler/embedding math, the CLIP resize operators, and
the JAX -> port state-dict converter (keys and values against
flax_to_diffusers / clip_flax_to_transformers, strict loads).

Inputs come from numpy seeds and go through both packages in float32."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.core import edm as jedm
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.core import edm as tedm
from svd_xtend_tpu_torch.io import convert as tconv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["UNetConfig", "VAEConfig", "CLIPVisionConfig",
                                  "SchedulerConfig", "PipelineConfig"])
def test_config_copy_matches_jax_fields(name):
    """Same field names, order and defaults as the JAX dataclass."""
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert tf == jf


@pytest.mark.parametrize("name", ["TINY_UNET", "TINY_VAE", "TINY_CLIP"])
def test_tiny_configs_match_jax(name):
    assert (dataclasses.asdict(getattr(tcfg, name))
            == dataclasses.asdict(getattr(jcfg, name)))


def test_derived_config_properties_match_jax():
    for j, t in ((jcfg.UNetConfig(), tcfg.UNetConfig()), (jcfg.TINY_UNET, tcfg.TINY_UNET)):
        assert t.time_embed_dim == j.time_embed_dim
    for j, t in ((jcfg.VAEConfig(), tcfg.VAEConfig()), (jcfg.TINY_VAE, tcfg.TINY_VAE)):
        assert t.downsample_factor == j.downsample_factor
    with pytest.raises(ValueError):
        tcfg.UNetConfig(block_out_channels=(320, 640))


def test_package_imports_no_jax():
    """Importing every port module (the evaluation entry points among them)
    leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import svd_xtend_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'svd_xtend_tpu_torch.scripts.eval_approx',\n"
        "        'svd_xtend_tpu_torch.scripts.eval_tracklet'} <= set(sys.modules)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'svd_xtend_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_sources_never_import_jax():
    root = os.path.join(REPO, "svd_xtend_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), (fn, s)


# ---------------------------------------------------------------- EDM math --
# f32 elementwise math; 1e-6 relative covers last-ulp differences of
# log/rsqrt/pow between XLA and torch on the CPU.

def test_edm_functions_match_jax():
    rs = np.random.RandomState(0)
    sigma = np.float32(3.7)
    x = rs.randn(2, 3, 4, 4, 4).astype(np.float32)
    d = rs.randn(2, 3, 4, 4, 4).astype(np.float32)
    np.testing.assert_allclose(tedm.sigma_to_t(sigma).numpy(),
                               np.asarray(jedm.sigma_to_t(sigma)), rtol=1e-6)
    for a, b in zip(tedm.edm_scalings(sigma), jedm.edm_scalings(sigma)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    tx, td = torch.from_numpy(x), torch.from_numpy(d)
    np.testing.assert_allclose(tedm.denoise(td, tx, sigma).numpy(),
                               np.asarray(jedm.denoise(d, x, sigma)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tedm.precondition_inputs(tx, sigma).numpy(),
                               np.asarray(jedm.precondition_inputs(x, sigma)), rtol=1e-6)
    np.testing.assert_allclose(
        tedm.euler_step(tx, td, sigma, np.float32(2.1)).numpy(),
        np.asarray(jedm.euler_step(x, d, sigma, np.float32(2.1))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [2, 25])
def test_karras_sigmas_and_scheduler_match_jax(steps):
    from svd_xtend_tpu.diffusion.scheduler import EulerDiscreteScheduler as JS
    from svd_xtend_tpu_torch.diffusion.scheduler import EulerDiscreteScheduler as TS
    # linspace and the base of x**7 may differ in the last f32 ulp between
    # XLA and torch; the power amplifies that 7x: rtol 1e-5
    np.testing.assert_allclose(TS().sigmas(steps).numpy(), np.asarray(JS().sigmas(steps)),
                               rtol=1e-5)
    assert TS().init_noise_sigma() == JS().init_noise_sigma()


def test_sinusoidal_embedding_and_mlp_match_jax():
    from svd_xtend_tpu.models.embeddings import TimestepEmbedding as JTE
    from svd_xtend_tpu.models.embeddings import sinusoidal_embedding as jsin
    from svd_xtend_tpu_torch.models.embeddings import TimestepEmbedding as TTE
    from svd_xtend_tpu_torch.models.embeddings import sinusoidal_embedding as tsin
    t = np.array([0.0, 1.3, 37.0, 999.0], np.float32)
    # arguments reach t·freq ~ 1e3 rad, whose f32 ulp is 6e-5: a last-ulp
    # difference in exp(freq) between XLA and torch moves sin/cos by ~1e-4
    for dim in (8, 33, 320):
        np.testing.assert_allclose(tsin(torch.from_numpy(t), dim).numpy(),
                                   np.asarray(jsin(jnp.asarray(t), dim)), atol=2e-4)
    x = np.random.RandomState(1).randn(3, 16).astype(np.float32)
    jm = JTE(24, hidden_dim=40)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = TTE(16, 24, hidden_dim=40)
    tm.load_state_dict(tconv.diffusers_state_dict(jconv.flatten(params)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)),
                               atol=1e-5, rtol=1e-5)


def test_resize_and_clip_preprocess_match_jax():
    from svd_xtend_tpu.models.clip import preprocess_for_clip as jpre
    from svd_xtend_tpu_torch.models.clip import preprocess_for_clip as tpre
    img = np.random.RandomState(2).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
    got = tpre(torch.from_numpy(img), tcfg.TINY_CLIP).numpy()
    ref = np.asarray(jpre(jnp.asarray(img), jcfg.TINY_CLIP))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- converter --

@pytest.fixture(scope="module")
def tiny_jax_params():
    from svd_xtend_tpu.diffusion.pipeline import SVDModels, init_pipeline_params
    models = SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                       clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    return init_pipeline_params(models, jax.random.PRNGKey(0))


def _same(sd_t, sd_np):
    assert sorted(sd_t) == sorted(sd_np)
    for k, v in sd_np.items():
        assert tuple(sd_t[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(sd_t[k].numpy(), np.asarray(v), err_msg=k)


def test_converter_matches_flax_to_diffusers_and_loads(tiny_jax_params):
    from svd_xtend_tpu_torch.models.clip import CLIPVisionModelWithProjection
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
    sds = tconv.state_dict_from_jax(jconv.flatten(tiny_jax_params))
    assert set(sds) == {"unet", "vae", "clip"}
    _same(sds["unet"], jconv.flax_to_diffusers(tiny_jax_params["unet"]))
    _same(sds["vae"], jconv.flax_to_diffusers(tiny_jax_params["vae"]))
    _same(sds["clip"], jconv.clip_flax_to_transformers(
        tiny_jax_params["clip"], patch_size=tcfg.TINY_CLIP.patch_size))
    UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).load_state_dict(sds["unet"], strict=True)
    AutoencoderKLTemporalDecoder(tcfg.TINY_VAE).load_state_dict(sds["vae"], strict=True)
    CLIPVisionModelWithProjection(tcfg.TINY_CLIP).load_state_dict(sds["clip"], strict=True)


def test_converter_rejects_unknown_component():
    with pytest.raises(ValueError):
        tconv.state_dict_from_jax({"text_encoder/w/kernel": np.zeros((2, 2))})


def test_seeded_init_follows_flax_laws():
    """init_random_: lecun-normal kernels (std 1/sqrt(fan_in), truncated at
    2 std), zero biases, unit norm scales, mix_factor untouched."""
    from svd_xtend_tpu_torch.diffusion.pipeline import init_random_
    from svd_xtend_tpu_torch.models.blocks import SpatioTemporalResBlock
    m = SpatioTemporalResBlock(64, 64, 32)
    init_random_(m, torch.Generator().manual_seed(0))
    w = m.spatial_res_block.conv1.weight
    fan_in = 64 * 9
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    assert torch.all(m.spatial_res_block.conv1.bias == 0)
    assert torch.all(m.spatial_res_block.norm1.weight == 1)
    assert m.time_mixer.mix_factor.item() == 0.5
    a = init_random_(SpatioTemporalResBlock(64, 64, 32), torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.state_dict(), m.state_dict(), rtol=0, atol=0)
