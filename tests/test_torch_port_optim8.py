"""The port's 8-bit AdamW (train/quant.py) and bf16 gradients against the JAX
package on the CPU: the blockwise int8 codes and scales bit for bit, five
steps of the optimizer on a tree of tensors over and under 4096 values, TINY
train steps with ``use_8bit_adam`` and with ``grad_dtype="bf16"``, the
options ``check_ported`` takes and refuses, and a bit-equal resume of the
quantized moments."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.train import optim as joptim
from svd_xtend_tpu.train import quant as jquant
from svd_xtend_tpu.train import state as jstate
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io.convert import state_dict_from_jax
from svd_xtend_tpu_torch.train import optim as toptim
from svd_xtend_tpu_torch.train import quant
from svd_xtend_tpu_torch.train import state as tstate
from test_torch_port_train import _flat_unet, _t, jax_draws

torch.set_num_threads(1)

H = W = 32
F = 3


# -------------------------------------------------------------- codes --

@pytest.mark.parametrize("shape,scale", [((5000,), 1e-6), ((3, 2048), 1.0), ((70, 33), 3.0),
                                         ((4096,), 1e-2), ((1,), 0.5)])
def test_quantize_codes_and_scales_equal_jax(shape, scale):
    """Codes and scales bit for bit against the jitted JAX functions (the
    form the train step runs; XLA compiles absmax / 127.0 to a product with
    f32(1/127) there, while eager JAX divides), the last block zero-padded,
    and the inverses; an all-zero block keeps scale 0 and codes 0."""
    rs = np.random.RandomState(len(shape))
    x = (rs.randn(*shape) * scale).astype(np.float32)
    x.reshape(-1)[:min(x.size, 2048)] *= 0 if shape == (5000,) else 1
    for jq, tq, jd, td, arr in (
            (jquant.quantize_blockwise, quant.quantize_blockwise, jquant.dequantize_blockwise,
             quant.dequantize_blockwise, x),
            (jquant.quantize_sqrt, quant.quantize_sqrt, jquant.dequantize_sqrt,
             quant.dequantize_sqrt, np.abs(x))):
        ref, got = jax.jit(jq)(jnp.asarray(arr)), tq(_t(arr))
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
        np.testing.assert_array_equal(td(got, shape).numpy(),
                                      np.asarray(jax.jit(jd, static_argnums=1)(ref, shape)))


# ---------------------------------------------------------- optimizer --

# tensors over and under the 4096-value threshold of int8 moments
TREE = {"big": (70, 80), "edge": (4096,), "under": (4095,), "small": (30, 20), "bias": (7,)}


def _grads(rs, step):
    return {k: (rs.randn(*s) * 10.0 ** (-(step % 3) - 1)).astype(np.float32)
            for k, s in TREE.items()}


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
def test_adamw_8bit_matches_jax_over_five_steps(gdt):
    """make_optimizer with use_8bit_adam (the f32 clip, then the 8-bit
    AdamW, a warmup schedule) against the JAX package's chain on the same
    gradients (f32, or bf16 as grad_dtype="bf16" gives them), the JAX
    update jitted as in the train step: the masters within 1e-6 relative;
    the codes equal in all but 1e-3 of the values and those by one code, the
    scales within 1e-5 relative, the f32 moments of the small tensors within
    1e-6 of each tensor's largest value (the global norm that clips the
    gradients is summed in another order: ~1e-7 relative, and a value within
    that of a rounding boundary may take the next code)."""
    kw = dict(learning_rate=1e-2, lr_scheduler="constant_with_warmup", lr_warmup_steps=2,
              max_grad_norm=1.0, adam_weight_decay=0.1, use_8bit_adam=True)
    rs = np.random.RandomState(4)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in TREE.items()}
    jopt = joptim.make_optimizer(jcfg.TrainConfig(**kw))
    jst = jopt.init(params)
    update = jax.jit(jopt.update)
    masters = [_t(params[k]) for k in TREE]
    topt = toptim.make_optimizer(tcfg.TrainConfig(**kw), masters)
    assert topt.adamw8 is not None and topt.adamw is None
    dt = getattr(jnp, gdt)
    for i in range(5):
        g = _grads(rs, i)
        jg = {k: jnp.asarray(v).astype(dt) for k, v in g.items()}
        upd, jst = update(jg, jst, params)
        params = optax.apply_updates(params, upd)
        lr, norm = topt.step([_t(g[k]).to(getattr(torch, gdt)) for k in TREE])
        np.testing.assert_allclose(norm.item(), float(joptim.global_norm_f32(jg)), rtol=1e-6)
    adam = jst[1][0]
    for i, k in enumerate(TREE):
        np.testing.assert_allclose(masters[i].numpy(), np.asarray(params[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        for jm, tm in ((adam.mu[k], topt.adamw8.mu[i]), (adam.nu[k], topt.adamw8.nu[i])):
            if isinstance(tm, quant.Quantized):
                d = np.abs(tm.q.numpy().astype(int) - np.asarray(jm.q).astype(int))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k
                np.testing.assert_allclose(tm.scale.numpy(), np.asarray(jm.scale), rtol=1e-5)
            else:
                assert np.prod(TREE[k]) < 4096
                ref = np.asarray(jm)
                np.testing.assert_allclose(tm.numpy(), ref, rtol=0,
                                           atol=1e-6 * np.abs(ref).max())
    assert isinstance(topt.adamw8.mu[0], quant.Quantized)
    assert isinstance(topt.adamw8.mu[1], quant.Quantized)
    assert not isinstance(topt.adamw8.mu[2], quant.Quantized)
    # int8 codes of 3 and 2 padded blocks and their f32 scales, for both
    # moments; f32 moments for the three small tensors
    assert topt.adamw8.moment_bytes() == 2 * (5 * 2048 + 5 * 4) + 8 * (4095 + 600 + 7)


@pytest.mark.parametrize("kw,ok", [
    (dict(use_8bit_adam=True), True), (dict(grad_dtype="bf16"), True),
    (dict(train_mode="tracklet", tracklet_dim=8), True), (dict(vae_encode_in_loop=False), True),
    (dict(use_8bit_adam=True, grad_dtype="bf16", train_mode="lora"), True),
    (dict(zero1=True, mesh=tcfg.MeshConfig(model=2)), True),
    (dict(host_offload="masters", train_mode="lora", mesh=tcfg.MeshConfig(frames=2),
          num_frames=3), False),
    (dict(host_offload="all", use_8bit_adam=True), False),
    (dict(grad_dtype="fp16"), False), (dict(train_mode="encoder"), False),
    (dict(zero1=True), True), (dict(host_offload="masters"), True),
    (dict(host_offload="masters+moments", use_8bit_adam=True), True),
    (dict(host_offload="masters+moments", train_mode="lora"), True)])
def test_check_ported_takes_and_refuses(kw, ok):
    cfg = tcfg.TrainConfig(**kw)
    if ok:
        cfg.check_ported()
        assert toptim.make_optimizer(cfg, [torch.zeros(2)]).params
    else:
        with pytest.raises(ValueError):
            cfg.check_ported()


# ----------------------------------------------------------- train step --

@pytest.fixture(scope="module")
def pair():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    return jm, params, state_dict_from_jax(jconv.flatten(params))


def _port_models(sds):
    tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    for name in ("unet", "vae", "clip"):
        getattr(tm, name).load_state_dict(sds[name], strict=True)
    return tm


# the rel-L2 of the trained values' change over two steps against JAX's (all
# trained tensors together: a bias whose exact gradient is zero moves by
# float noise alone, test_torch_port_train.py):
# bf16 gradients round f32 ones that XLA and torch sum in other orders, a
# 2^-8 relative step where one lands across a rounding boundary; 8-bit
# moments put such a value a code (absmax / 127 of its block) apart. Adam's
# normalisation amplifies either where a value's moments nearly cancel.
UPDATE_REL_L2 = {"grad_dtype": 2 ** -7, "use_8bit_adam": 2 ** -4}


@pytest.mark.parametrize("option,accum", [(dict(use_8bit_adam=True), 1),
                                          (dict(grad_dtype="bf16"), 1),
                                          (dict(grad_dtype="bf16"), 2)],
                         ids=["8bit", "bf16", "bf16-accum2"])
def test_train_step_matches_jax(pair, option, accum):
    """Two TINY temporal-scope f32 steps against JAX's make_train_step with
    its draws fed in. With grad_dtype="bf16" both differentiate bf16 copies
    of the trained weights (the forward sees them rounded), keep the
    gradients (and their sum over micro-batches) in bf16, and apply them to
    the f32 masters; optax rounds (1 - b1)·g and (1 - b2)·g² to bf16 where
    torch's AdamW reads g as f32; the masters are held as the f32 steps'
    are (1e-4, test_torch_port_train.py), the grad_norm within 1e-2 (a bf16
    gradient one ulp apart where XLA's and torch's f32 gradients round to
    either side). The 8-bit step is f32: its masters are held as the f32
    steps' but for the values whose moment code lands one apart."""
    jm, params, sds = pair
    kw = dict(train_mode="temporal", gradient_accumulation_steps=accum, learning_rate=1e-3,
              lr_scheduler="constant", encode_chunk_size=2, adam_epsilon=1e-6, **option)
    jc = jcfg.TrainConfig(**kw)
    opt = joptim.make_optimizer(jc)
    jst = jstate.create_train_state(jc, params["unet"], opt)
    jstep = jax.jit(jstate.make_train_step(jm, jc, opt, {"vae": params["vae"],
                                                         "clip": params["clip"]}))
    tm = _port_models(sds)
    tc = tcfg.TrainConfig(**kw)
    tst = tstate.create_train_state(tc, tm)
    tstep = tstate.make_train_step(tm, tc)
    shape = (accum, 1, F, H, W, 3) if accum > 1 else (1, F, H, W, 3)
    rng = jax.random.PRNGKey(21)
    bf16 = option.get("grad_dtype") == "bf16"
    for i in range(2):
        batch = np.random.RandomState(30 + i).uniform(-1, 1, shape).astype(np.float32)
        jst, jmet = jstep(jst, jnp.asarray(batch), rng)
        r = jax.random.fold_in(rng, i)
        keys = jax.random.split(r, accum) if accum > 1 else [r]
        tst, tmet = tstep(tst, _t(batch), draws=[jax_draws(k, shape[-5:], jc) for k in keys])
        np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]),
                                   rtol=1e-2 if bf16 else 1e-4, atol=1e-5)
    want = _flat_unet(jstate.unet_params_of(jst, jc))
    start = _flat_unet(params["unet"])
    named = dict(tm.unet.named_parameters())
    err = ref = 0.0
    for name, master in zip(tst.names, tst.params):
        step_jax = want[name] - start[name]
        err += float(np.sum((master.numpy() - start[name] - step_jax) ** 2))
        ref += float(np.sum(step_jax ** 2))
        compute = master.to(torch.bfloat16).float() if bf16 else master
        assert torch.equal(named[name].detach(), compute), name
    rel = (err / ref) ** 0.5
    print(f"relative L2 of the two steps' change: {rel:.3g}")
    assert rel <= UPDATE_REL_L2[next(iter(option))]


def _jax_moments(tree, params):
    """{port parameter name: JAX moment leaf} of an 8-bit moment tree over
    the JAX train params (a Quantized, or an f32 array)."""
    from jax.tree_util import tree_flatten_with_path

    from svd_xtend_tpu.core.mesh import path_str
    from svd_xtend_tpu_torch.io.convert import diffusers_state_dict

    shapes = {path_str(p): v.shape for p, v in tree_flatten_with_path(params)[0]}
    out = {}
    for path, leaf in tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jquant.Quantized))[0]:
        key = path_str(path)
        (name,) = diffusers_state_dict({key: np.zeros(shapes[key], np.float32)})
        out[name] = leaf
    return out


def test_8bit_moments_are_blocked_in_jax_order(pair):
    """One TINY temporal-scope 8-bit step against JAX's make_train_step with
    its draws: every quantised moment's blocks are cut in its JAX leaf's
    flattening order (a Linear's (out, in) as (in, out)), so the codes
    equal JAX's in all but 1e-3 of the values, those by one code, and the
    scales within 1e-5 relative (the bounds of
    test_adamw_8bit_matches_jax_over_five_steps), and the same tensors
    hold int8 moments on both sides. Blocks cut in torch's order would put
    most codes of every 2-D moment elsewhere."""
    jm, params, sds = pair
    kw = dict(train_mode="temporal", learning_rate=1e-3, lr_scheduler="constant",
              encode_chunk_size=2, adam_epsilon=1e-6, use_8bit_adam=True)
    jc = jcfg.TrainConfig(**kw)
    opt = joptim.make_optimizer(jc)
    jst = jstate.create_train_state(jc, params["unet"], opt)
    jstep = jax.jit(jstate.make_train_step(jm, jc, opt, {"vae": params["vae"],
                                                         "clip": params["clip"]}))
    tm = _port_models(sds)
    tc = tcfg.TrainConfig(**kw)
    tst = tstate.create_train_state(tc, tm)
    tstep = tstate.make_train_step(tm, tc)
    batch = np.random.RandomState(30).uniform(-1, 1, (1, F, H, W, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    jst, _ = jstep(jst, jnp.asarray(batch), rng)
    tst, _ = tstep(tst, _t(batch), draws=[jax_draws(jax.random.fold_in(rng, 0),
                                                    batch.shape, jc)])
    adam = jst.opt_state[1][0]
    mus, nus = _jax_moments(adam.mu, jst.params), _jax_moments(adam.nu, jst.params)
    assert sorted(mus) == sorted(tst.names)
    own = tst.optimizer.adamw8
    codes = apart = quantized = 0
    for k, name in enumerate(tst.names):
        for jm_, tm_ in ((mus[name], own.mu[k]), (nus[name], own.nu[k])):
            assert isinstance(tm_, quant.Quantized) == isinstance(jm_, jquant.Quantized), name
            if isinstance(tm_, quant.Quantized):
                quantized += own.axes[k] is not None
                d = np.abs(tm_.q.numpy().astype(int) - np.asarray(jm_.q).astype(int))
                assert d.max() <= 1, name
                codes, apart = codes + d.size, apart + int((d > 0).sum())
                np.testing.assert_allclose(tm_.scale.numpy(), np.asarray(jm_.scale), rtol=1e-5,
                                           err_msg=name)
    print(f"{apart} of {codes} codes one apart; {quantized} permuted int8 moments")
    assert quantized > 0 and apart <= 1e-3 * codes


def test_an_8bit_state_in_torch_block_order_is_refused(pair):
    """A state dict of 8-bit moments without the block-order mark (the form
    the moments had while their blocks were cut in torch's order) raises
    when loaded, rather than loading codes into other blocks; one with the
    mark loads."""
    _, _, sds = pair
    cfg = tcfg.TrainConfig(use_8bit_adam=True, encode_chunk_size=2)
    st = tstate.create_train_state(cfg, _port_models(sds))
    sd = st.state_dict()
    assert sd["optimizer"]["adamw8"]["block_order"] == quant.BLOCK_ORDER
    st.load_state_dict(sd)
    del sd["optimizer"]["adamw8"]["block_order"]
    with pytest.raises(ValueError, match="block order"):
        st.load_state_dict(sd)
    with pytest.raises(ValueError, match="block order"):
        st.optimizer.adamw8.load_state_dict(st.optimizer.adamw8.state_dict() | {
            "block_order": "torch"})


def test_bf16_gradients_are_bf16_and_the_forward_sees_rounded_weights(pair):
    """loss_and_grads with grad_dtype="bf16": bf16 gradients; after the
    state is made, each trained compute copy holds its f32 master rounded
    to bf16 (the JAX package casts the masters at every step)."""
    _, _, sds = pair
    tm = _port_models(sds)
    cfg = tcfg.TrainConfig(grad_dtype="bf16", encode_chunk_size=2)
    st = tstate.create_train_state(cfg, tm)
    named = dict(tm.unet.named_parameters())
    assert any(not torch.equal(m, named[n]) for n, m in zip(st.names, st.params))
    for n, m in zip(st.names, st.params):
        assert torch.equal(named[n].detach(), m.to(torch.bfloat16).float())
    pixels = _t(np.random.RandomState(5).uniform(-1, 1, (1, F, H, W, 3)))
    draws = tstate.sample_train_draws(tm, pixels.shape, cfg, torch.Generator().manual_seed(0))
    _, grads = tstate.loss_and_grads(tm, cfg, st, pixels, draws)
    assert all(g.dtype == torch.bfloat16 for g in grads)


# --------------------------------------------------------------- resume --

def test_resume_of_the_8bit_state_is_bit_equal(pair, tmp_path):
    """Two 8-bit steps, the state saved with torch.save and loaded into a
    fresh state over fresh networks, then one more step on each: masters,
    int8 codes, scales and f32 moments bit for bit. Loading it into an fp32
    AdamW state raises."""
    _, _, sds = pair
    cfg = tcfg.TrainConfig(use_8bit_adam=True, encode_chunk_size=2, learning_rate=1e-3)
    pixels = _t(np.random.RandomState(6).uniform(-1, 1, (1, F, H, W, 3)))

    def run(tm, st, seed):
        return tstate.make_train_step(tm, cfg)(st, pixels,
                                               generator=torch.Generator().manual_seed(seed))[0]

    tm = _port_models(sds)
    st = tstate.create_train_state(cfg, tm)
    for seed in (0, 1):
        st = run(tm, st, seed)
    path = os.path.join(tmp_path, "state.pt")
    torch.save(st.state_dict(), path)
    tm2 = _port_models(sds)
    st2 = tstate.create_train_state(cfg, tm2)
    st2.load_state_dict(torch.load(path, weights_only=True))
    tstate.write_back(tm2, cfg, st2)
    st, st2 = run(tm, st, 2), run(tm2, st2, 2)
    assert st.step == st2.step == 3
    for a, b in zip(st.params, st2.params):
        assert torch.equal(a, b)
    o1, o2 = st.optimizer.adamw8, st2.optimizer.adamw8
    assert o1.count == o2.count == 3
    quantized = 0
    for a, b in zip(o1.mu + o1.nu, o2.mu + o2.nu):
        if isinstance(a, quant.Quantized):
            quantized += 1
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert torch.equal(a, b)
    assert quantized > 0
    fp32 = tstate.create_train_state(dataclasses.replace(cfg, use_8bit_adam=False),
                                     _port_models(sds))
    with pytest.raises(ValueError):
        fp32.load_state_dict(torch.load(path, weights_only=True))
