"""The port's training slice against the JAX package on the CPU, in float32:
the configs, the EDM loss math, the frozen-encoder stage with the JAX
package's draws (chunked VAE encode with a ragged remainder), conditioning
dropout, the schedules, the f32 clip and AdamW against optax, the trainable
scopes and EMA, and whole train steps at the TINY configs for the
'temporal', 'full' and 'lora' scopes, with and without gradient
accumulation.

Weights go from the JAX package to the port through ``state_dict_from_jax``;
random draws are made with the JAX package's key splits and handed to the
port as ``TrainDraws``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.core import edm as jedm
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.diffusion import training as jtrain
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.train import optim as joptim
from svd_xtend_tpu.train import state as jstate
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.core import edm as tedm
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.diffusion import training as ttrain
from svd_xtend_tpu_torch.io.convert import (diffusers_state_dict, lora_from_jax,
                                            lora_state_dict, state_dict_from_jax)
from svd_xtend_tpu_torch.train import optim as toptim
from svd_xtend_tpu_torch.train import state as tstate

torch.set_num_threads(1)

H = W = 32
F = 3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ----------------------------------------------------------------- configs --

@pytest.mark.parametrize("name", ["TrainConfig", "MeshConfig"])
def test_train_config_copy_matches_jax_fields(name):
    """Same field names, order, defaults (and default factories)."""
    def fields(mod):
        return [(f.name, f.default if f.default_factory is dataclasses.MISSING
                 else dataclasses.asdict(f.default_factory()))
                for f in dataclasses.fields(getattr(mod, name))]
    assert fields(tcfg) == fields(jcfg)


@pytest.mark.parametrize("kw", [dict(zero1=True, mesh=tcfg.MeshConfig(model=2)),
                                dict(mesh=tcfg.MeshConfig(frames=2), num_frames=3),
                                dict(host_offload="masters", train_mode="lora",
                                     mesh=tcfg.MeshConfig(model=2)),
                                dict(grad_dtype="fp16"), dict(train_mode="encoder"),
                                dict(host_offload="moments", tracklet_dim=8),
                                dict(remat_policy="full")])
def test_unported_train_options_are_refused(kw):
    """A 'model' axis takes ZeRO-1, and the 'lora' scope with host offload;
    the rest are refused."""
    cfg = tcfg.TrainConfig(**kw)
    if cfg.mesh.model == 2:
        opt = toptim.make_optimizer(cfg, [torch.zeros(2)])
        assert opt.zero1 == cfg.zero1 and opt.offload == cfg.host_offload
        return
    with pytest.raises(ValueError):
        toptim.make_optimizer(cfg, [torch.zeros(2)])


def test_lora_scope_passes_check_ported():
    cfg = tcfg.TrainConfig(train_mode="lora")
    cfg.check_ported()
    assert toptim.make_optimizer(cfg, [torch.zeros(2)]).params


# ---------------------------------------------------------------- EDM loss --

def test_rand_log_normal_distribution_and_seeding():
    g = torch.Generator().manual_seed(0)
    s = tedm.rand_log_normal((200000,), 0.7, 1.6, generator=g)
    assert s.shape == (200000,) and s.dtype == torch.float32 and bool((s > 0).all())
    # log σ ~ N(0.7, 1.6²): mean and std of 2e5 samples within ~5 standard errors
    assert abs(s.log().mean().item() - 0.7) < 0.02
    assert abs(s.log().std().item() - 1.6) < 0.02
    a = tedm.rand_log_normal((4, 2), -3.0, 0.5, generator=torch.Generator().manual_seed(1))
    b = tedm.rand_log_normal((4, 2), -3.0, 0.5, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loss_weight_and_weighted_denoising_loss_match_jax():
    rs = np.random.RandomState(0)
    den, tgt = rs.randn(3, 2, 4, 4, 4).astype(np.float32), rs.randn(3, 2, 4, 4, 4).astype(np.float32)
    sigma = np.exp(rs.randn(3)).astype(np.float32).reshape(3, 1, 1, 1, 1)
    # f32 elementwise math and one mean: last-ulp differences only
    np.testing.assert_allclose(tedm.loss_weight(_t(sigma)).numpy(),
                               np.asarray(jedm.loss_weight(sigma)), rtol=1e-6)
    np.testing.assert_allclose(
        tedm.weighted_denoising_loss(_t(den), _t(tgt), _t(sigma)).item(),
        float(jedm.weighted_denoising_loss(den, tgt, sigma)), rtol=1e-5)


def test_conditioning_dropout_bands_match_jax():
    rs = np.random.RandomState(1)
    enc = jtrain.TrainBatchEncodings(
        latents=jnp.zeros((64, F, 4, 4, 4)), cond_latents=jnp.asarray(rs.randn(64, 4, 4, 4), jnp.float32),
        image_embeds=jnp.asarray(rs.randn(64, 1, 8), jnp.float32), noise_aug=jnp.zeros(64))
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (64,)))
    ref = jtrain.conditioning_dropout(enc, key, 0.1)
    tenc = ttrain.TrainBatchEncodings(*(_t(a) for a in enc))
    got = ttrain.conditioning_dropout(tenc, _t(u), 0.1)
    np.testing.assert_array_equal(got.image_embeds.numpy(), np.asarray(ref.image_embeds))
    np.testing.assert_array_equal(got.cond_latents.numpy(), np.asarray(ref.cond_latents))
    # the bands themselves: CLIP dropped below 2p, the image in [p, 3p)
    one = ttrain.TrainBatchEncodings(torch.zeros(4, 1), torch.ones(4, 1, 1, 1),
                                     torch.ones(4, 1, 1), torch.zeros(4))
    out = ttrain.conditioning_dropout(one, torch.tensor([0.05, 0.15, 0.25, 0.5]), 0.1)
    assert out.image_embeds.flatten().tolist() == [0.0, 0.0, 1.0, 1.0]
    assert out.cond_latents.flatten().tolist() == [1.0, 0.0, 0.0, 1.0]


# ------------------------------------------------------ models and draws --

@pytest.fixture(scope="module")
def pair():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    return jm, params, state_dict_from_jax(jconv.flatten(params))


def _port_models(sds):
    tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                device="cpu")
    for name in ("unet", "vae", "clip"):
        getattr(tm, name).load_state_dict(sds[name], strict=True)
    return tm


def jax_draws(rng, pixel_shape, cfg) -> ttrain.TrainDraws:
    """The draws of the JAX package's training_loss for one micro-batch,
    from its key splits (training.py:51, :71, :84-90, :113, :130-134)."""
    b, f, h, w, _ = pixel_shape
    ds = jcfg.TINY_VAE.downsample_factor
    lat = (h // ds, w // ds, jcfg.TINY_VAE.latent_channels)
    k_enc, k_drop, _, k_loss = jax.random.split(rng, 4)
    k_lat, k_aug, k_cond = jax.random.split(k_enc, 3)
    bf = b * f
    cap = min(cfg.encode_chunk_size or bf, bf)
    n_full, rem = bf // cap, bf % cap
    keys = jax.random.split(k_lat, n_full + 1)
    parts = [jax.random.normal(keys[i], (cap,) + lat, jnp.float32) for i in range(n_full)]
    if rem:
        parts.append(jax.random.normal(keys[n_full], (rem,) + lat, jnp.float32))
    k_sigma, k_noise = jax.random.split(k_loss)
    draws = dict(
        latent_noise=jnp.concatenate(parts),
        cond_sigma=jedm.rand_log_normal(k_aug, (b,), cfg.cond_aug_loc, cfg.cond_aug_std),
        cond_pixel_noise=jax.random.normal(k_cond, (b, h, w, 3), jnp.float32),
        cond_latent_noise=jax.random.normal(jax.random.fold_in(k_cond, 1), (b,) + lat,
                                            jnp.float32),
        dropout_u=jax.random.uniform(k_drop, (b,)),
        sigma=jedm.rand_log_normal(k_sigma, (b,), cfg.p_mean, cfg.p_std),
        noise=jax.random.normal(k_noise, (b, f) + lat, jnp.float32))
    return ttrain.TrainDraws(**{k: _t(v) for k, v in draws.items()})


@pytest.mark.parametrize("b,f,chunk", [(1, 5, 2), (2, 3, 0)])
def test_encode_batch_matches_jax(pair, b, f, chunk):
    """Chunks of 2 over 5 frames leave a ragged remainder of 1; 0 encodes
    all frames at once. The JAX draws are fed to the port."""
    jm, params, sds = pair
    tm = _port_models(sds)
    cfg = jcfg.TrainConfig(encode_chunk_size=chunk)
    pixels = np.random.RandomState(f).uniform(-1, 1, (b, f, H, W, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    k_enc = jax.random.split(rng, 4)[0]
    ref = jtrain.encode_batch(jm, params, jnp.asarray(pixels), k_enc, cfg)
    got = ttrain.encode_batch(tm, _t(pixels), tcfg.TrainConfig(encode_chunk_size=chunk),
                              jax_draws(rng, pixels.shape, cfg))
    # VAE encoder and CLIP in f32: summation order only
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("name", ["linear", "cosine", "cosine_with_restarts", "polynomial",
                                  "constant", "constant_with_warmup"])
def test_schedules_match_jax(name):
    # JAX evaluates the schedules in f32, the port in Python floats: 1e-5
    # relative covers the f32 rounding of the ratios, and 1e-9 absolute
    # (1e-6 of the base rate) the f32 cancellation in 1 + cos near a cycle end
    for warmup in (0, 10):
        j = joptim.get_schedule(name, 1e-3, warmup, 100)
        t = toptim.get_schedule(name, 1e-3, warmup, 100)
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5, atol=1e-9)
    cfg = dict(lr_scheduler=name, scale_lr=True, gradient_accumulation_steps=2,
               per_device_batch_size=3, lr_warmup_steps=4, max_train_steps=40)
    j = joptim.training_schedule(jcfg.TrainConfig(**cfg), num_processes=2)
    t = toptim.training_schedule(tcfg.TrainConfig(**cfg), num_processes=2)
    for step in (0, 3, 8, 30, 79):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5, atol=1e-9)


def _tree(rs, scale):
    return {"a": (rs.randn(7, 3) * scale).astype(np.float32),
            "b": (rs.randn(5) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_global_norm_and_clip_match_jax(scale):
    """Below max_norm (1.0) the gradients are kept; above, scaled to it."""
    g = _tree(np.random.RandomState(2), scale)
    jnorm = float(joptim.global_norm_f32(g))
    tg = [_t(g["a"]), _t(g["b"])]
    np.testing.assert_allclose(toptim.global_norm_f32(tg).item(), jnorm, rtol=1e-6)
    clip = joptim.clip_by_global_norm_f32(1.0)
    ref, _ = clip.update(g, clip.init(g))
    norm = toptim.clip_by_global_norm_f32_(tg, 1.0)
    np.testing.assert_allclose(norm.item(), jnorm, rtol=1e-6)
    assert (jnorm < 1.0) == (scale == 0.01)
    for got, key in zip(tg, ("a", "b")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-7)


def test_adamw_chain_matches_optax_over_three_steps():
    """make_optimizer (clip + AdamW, warmup schedule) against the JAX
    make_optimizer (optax chain) on the same gradients; f32 Adam moments,
    1e-6 relative."""
    kw = dict(learning_rate=1e-2, lr_scheduler="constant_with_warmup", lr_warmup_steps=2,
              max_grad_norm=1.0, adam_weight_decay=0.1)
    rs = np.random.RandomState(4)
    params = _tree(rs, 1.0)
    jopt = joptim.make_optimizer(jcfg.TrainConfig(**kw))
    jstate_ = jopt.init(params)
    masters = [_t(params["a"]), _t(params["b"])]
    topt = toptim.make_optimizer(tcfg.TrainConfig(**kw), masters)
    for i in range(3):
        grads = _tree(rs, 0.3 if i % 2 else 2.0)
        upd, jstate_ = jopt.update(grads, jstate_, params)
        params = optax.apply_updates(params, upd)
        lr, norm = topt.step([_t(grads["a"]), _t(grads["b"])])
        np.testing.assert_allclose(lr, 1e-2 * min(1.0, i / 2), rtol=1e-6)
        np.testing.assert_allclose(norm.item(), float(joptim.global_norm_f32(grads)),
                                   rtol=1e-6)
        for got, key in zip(masters, ("a", "b")):
            np.testing.assert_allclose(got.numpy(), np.asarray(params[key]), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------------- scopes and EMA --

def _jax_names_to_port(flat_mask):
    """JAX flat path -> port parameter name, through the converter."""
    out = {}
    for path, m in flat_mask.items():
        (name,) = diffusers_state_dict({path: np.zeros((1,) * 2 if path.endswith("kernel")
                                                       else (1,))})
        out[name] = m
    return out


@pytest.mark.parametrize("mode", ["full", "temporal"])
def test_trainable_mask_matches_jax(pair, mode):
    _, params, sds = pair
    unet = _port_models(sds).unet
    jmask = jstate.trainable_mask(params["unet"], mode)
    flat = {k: bool(v) for k, v in jconv.flatten(jmask).items()}
    want = _jax_names_to_port(flat)
    got = tstate.trainable_mask(unet, mode)
    assert got == want
    sizes = {k: v.size for k, v in jconv.flatten(params["unet"]).items()}
    named = dict(unet.named_parameters())
    assert (sum(named[n].numel() for n, m in got.items() if m)
            == sum(sizes[k] for k, m in flat.items() if m))
    frozen, trainable = tstate.param_audit(got)
    assert len(frozen) + len(trainable) == len(got)
    if mode == "temporal":
        assert trainable and all("temporal_transformer_block" in n for n in trainable)
        assert not any(s in n for n in trainable
                       for s in ("temporal_res_block", "time_pos_embed", "time_mixer"))


def test_ema_matches_jax():
    rs = np.random.RandomState(5)
    ema, new = _tree(rs, 1.0), _tree(rs, 1.0)
    for step in (1, 7, 100000):
        ref = jstate.ema_update(ema, new, jnp.asarray(step), 0.9999)
        got = [_t(ema["a"]), _t(ema["b"])]
        tstate.ema_update_(got, [_t(new["a"]), _t(new["b"])], step, 0.9999)
        np.testing.assert_allclose(float(tstate.ema_decay_schedule(step)),
                                   float(jstate.ema_decay_schedule(jnp.asarray(step))))
        for g, key in zip(got, ("a", "b")):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref[key]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ train step --

def _flat_unet(tree):
    return _jax_names_to_port_values(jconv.flatten(tree))


def _jax_names_to_port_values(flat):
    sd = diffusers_state_dict(flat)
    return {k: v.numpy() for k, v in sd.items()}


def _seed_lora(jst, opt, seed=13):
    """JAX's adapter with B replaced by a seeded nonzero draw (while B is
    zero, A's gradient is exactly zero and the merged weights are the base
    ones, which would hide a wrong A gradient or a stale recompute)."""
    rs = np.random.RandomState(seed)
    tree = {p: {"a": ab["a"], "b": jnp.asarray(rs.randn(*ab["b"].shape) * 0.1, jnp.float32)}
            for p, ab in jst.params.items()}
    return jst.replace(params=tree, opt_state=opt.init(tree))


@pytest.mark.parametrize("mode,accum,remat", [
    pytest.param("temporal", 1, "block", id="temporal-1"),
    pytest.param("temporal", 2, "block", id="temporal-2"),
    pytest.param("full", 1, "block", id="full-1"), pytest.param("full", 2, "block", id="full-2"),
    pytest.param("lora", 1, "block", id="lora-1"), pytest.param("lora", 2, "block", id="lora-2"),
    pytest.param("lora", 1, "none", id="lora-1-none"),
    pytest.param("lora", 2, "none", id="lora-2-none")])
def test_train_step_matches_jax(pair, mode, accum, remat):
    """Two TINY f32 train steps (remat 'block' unless given, EMA on in the
    full scope): loss, grad_norm and the updated trainable parameters
    against JAX make_train_step with the JAX draws fed in. f32 through
    encoders, UNet forward and backward: summation order only, 1e-4. The
    'lora' scope starts from JAX's A and a seeded nonzero B, and its base
    UNet, VAE and CLIP must come out bit-identical.

    adam_epsilon is 1e-6 here: a bias whose exact gradient is zero (the last
    feed-forward bias of the top temporal block, whose per-channel constant
    conv_norm_out's GroupNorm removes) carries ~1e-9 of float noise on both
    sides, which Adam at eps 1e-8 turns into updates of ~lr/10 of either
    sign; at 1e-6 they stay below 1e-6, and the real gradients (>= 3e-4)
    move by less than 0.3 %."""
    jm, params, sds = pair
    kw = dict(train_mode=mode, gradient_accumulation_steps=accum, learning_rate=1e-3,
              lr_scheduler="constant", use_ema=mode == "full", encode_chunk_size=2,
              remat_policy=remat, adam_epsilon=1e-6)
    jc = jcfg.TrainConfig(**kw)
    opt = joptim.make_optimizer(jc)
    jst = jstate.create_train_state(jc, params["unet"], opt)
    if mode == "lora":
        jst = _seed_lora(jst, opt)
    jstep = jax.jit(jstate.make_train_step(jm, jc, opt, {"vae": params["vae"],
                                                         "clip": params["clip"]}))

    tm = _port_models(sds)
    tc = tcfg.TrainConfig(**kw)
    tst = tstate.create_train_state(tc, tm)
    tstate.cast_frozen_to_compute(tm, torch.float32)
    tstep = tstate.make_train_step(tm, tc)
    if mode == "lora":
        with torch.no_grad():
            start = lora_from_jax(jax.tree.map(np.asarray, jst.params))
            for name, ab in tst.lora.items():
                ab["a"].copy_(start[name]["a"])
                ab["b"].copy_(start[name]["b"])

    shape = (accum, 1, F, H, W, 3) if accum > 1 else (1, F, H, W, 3)
    rng = jax.random.PRNGKey(21)
    for i in range(2):
        batch = np.random.RandomState(30 + i).uniform(-1, 1, shape).astype(np.float32)
        jst, jmet = jstep(jst, jnp.asarray(batch), rng)
        r = jax.random.fold_in(rng, i)
        keys = jax.random.split(r, accum) if accum > 1 else [r]
        draws = [jax_draws(k, shape[-5:], jc) for k in keys]
        tst, tmet = tstep(tst, _t(batch), draws=draws)
        np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]), rtol=1e-4,
                                   atol=1e-5)
        assert tmet["lr"] == pytest.approx(1e-3)
    got = dict(zip(tst.names, tst.params))
    if mode == "lora":
        want = lora_state_dict(lora_from_jax(jax.tree.map(np.asarray, jst.params)))
        assert list(got) == list(want)
        for name, value in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=name)
        for net in ("unet", "vae", "clip"):
            for k, v in getattr(tm, net).state_dict().items():
                torch.testing.assert_close(v, sds[net][k], rtol=0, atol=0, msg=k)
        return
    want = _flat_unet(jstate.unet_params_of(jst, jc))
    assert set(got) == {n for n, m in tstate.trainable_mask(tm.unet, mode).items() if m}
    for name, master in got.items():
        np.testing.assert_allclose(master.numpy(), want[name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    named = dict(tm.unet.named_parameters())
    for name, master in got.items():
        torch.testing.assert_close(named[name].detach(), master, rtol=0, atol=0)
    if mode == "full":
        want_ema = _flat_unet(jst.ema_params)
        for name, e in zip(tst.names, tst.ema_params):
            np.testing.assert_allclose(e.numpy(), want_ema[name], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scope,remat", [
    pytest.param("temporal", "block", id="block"), pytest.param("temporal", "outer", id="outer"),
    pytest.param("lora", "block", id="lora-block"),
    pytest.param("lora", "outer", id="lora-outer")])
def test_remat_policies_keep_loss_and_gradients(pair, scope, remat):
    """Recomputing blocks in the backward changes neither the loss nor the
    gradients (same f32 ops again: bit-identical on the CPU up to 1e-6).
    The 'lora' scope goes through the step's own loss_and_grads, from a
    seeded nonzero B: a recompute that saw the base weights instead of the
    merged ones would change the adapter's gradients."""
    _, _, sds = pair
    tm = _port_models(sds)
    cfg = tcfg.TrainConfig(encode_chunk_size=2)
    pixels = _t(np.random.RandomState(7).uniform(-1, 1, (1, F, H, W, 3)))
    draws = ttrain.sample_train_draws(tm, pixels.shape, cfg, torch.Generator().manual_seed(0))
    if scope == "lora":
        cfg = dataclasses.replace(cfg, train_mode="lora")
        st = tstate.create_train_state(cfg, tm, generator=torch.Generator().manual_seed(1))
        rs = np.random.RandomState(8)
        with torch.no_grad():
            for ab in st.lora.values():
                ab["b"].copy_(_t(rs.randn(*ab["b"].shape) * 0.1))
        out = [tstate.loss_and_grads(tm, dataclasses.replace(cfg, remat_policy=policy), st,
                                     pixels, draws) for policy in ("none", remat)]
        assert out[0][0].item() == pytest.approx(out[1][0].item(), rel=1e-6)
        for a, b in zip(out[0][1], out[1][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        assert sum(g.abs().sum().item() for g in out[0][1][::2]) > 0       # A's gradients
        return
    enc = ttrain.encode_batch(tm, pixels, cfg, draws)
    params = [p for n, p in tm.unet.named_parameters() if "temporal_transformer" in n]
    out = []
    for policy in ("none", remat):
        tm.unet.requires_grad_(True)
        loss = ttrain.edm_denoising_loss(tm, enc, dataclasses.replace(cfg, remat_policy=policy),
                                         draws.sigma, draws.noise)
        out.append((loss.detach(), torch.autograd.grad(loss, params, materialize_grads=True)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
