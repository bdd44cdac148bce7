"""The port's Tracklet2Video branch against the JAX package on the CPU, at
TINY widths in float32 with a 16-wide branch of 2 heads: the five modules
of models/tracklet.py, the UNet with boxes (gate 0: exactly the UNet without
the branch; gate 0.5: against JAX), ``generate`` with boxes in the exact and
cache modes, two 'tracklet' train steps from a nonzero gate, the box
dropout, ``load_boxes_window``, the tracklet weights file both ways, LoRA's
targets over a tracklet UNet, and the CLI's ``--train_mode tracklet`` with
a bit-equal resume.

Weights go from the JAX package to the port through ``state_dict_from_jax``
(which carries the branch); inputs are numpy draws from a seed; the JAX
draws are fed to the port explicitly."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.data.dataset import FrameFolderDataset as JDataset
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.diffusion import training as jtrain
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import lora as jlora
from svd_xtend_tpu.models import tracklet as jtrk
from svd_xtend_tpu.train import optim as joptim
from svd_xtend_tpu.train import state as jstate
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.data.dataset import FrameFolderDataset
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.diffusion import training as ttrain
from svd_xtend_tpu_torch.io import convert
from svd_xtend_tpu_torch.io.safetensors_io import load_file
from svd_xtend_tpu_torch.models import lora, tracklet
from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
from svd_xtend_tpu_torch.train import checkpoint as ckpt
from svd_xtend_tpu_torch.train import state as tstate
from test_torch_port_pipeline import _jax_noise
from test_torch_port_train import _t, jax_draws

torch.set_num_threads(1)

DIM, HEADS, GATE = 16, 2, 0.5
# f32 through the same math: XLA and torch differ in summation order only
TOL = dict(atol=1e-5, rtol=1e-5)
# whole networks and generate (the exact path's tolerance, test_torch_port_pipeline.py)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
GEN_TOL = dict(atol=1e-3, rtol=1e-3)
H = W = 32
F = 3
N = 4


def _boxes(rs, b, f, n):
    a = rs.uniform(0, 1, (b, f, n, 4)).astype(np.float32)
    boxes = np.concatenate([np.minimum(a[..., :2], a[..., 2:]),
                            np.maximum(a[..., :2], a[..., 2:])], -1)
    return boxes, (rs.uniform(0, 1, (b, f, n)) > 0.3).astype(np.float32)


def _load(module, params, prefix=""):
    """JAX params of one branch module into the port's module (strict)."""
    flat = {f"{prefix}{k}": v for k, v in jconv.flatten(params).items()}
    sd = convert.tracklet_state_dict(flat)
    module.load_state_dict({k[len(prefix.replace("/", ".")):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


# ------------------------------------------------------------- modules --

def test_fourier_embed_matches_jax():
    x = np.random.RandomState(0).uniform(0, 1, (2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tracklet.fourier_embed(_t(x)).numpy(),
                               np.asarray(jtrk.fourier_embed(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("ids", [False, True])
def test_box_tokenizer_matches_jax(ids):
    rs = np.random.RandomState(1)
    boxes, mask = _boxes(rs, 2, F, N)
    inst = rs.randint(0, 64, (2, F, N)) if ids else None
    jm = jtrk.BoxTokenizer(DIM)
    args = (jnp.asarray(boxes), jnp.asarray(mask)) + ((jnp.asarray(inst),) if ids else ())
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    # the null token starts at a normal draw; the mask mixes it in
    ref = np.asarray(jm.apply({"params": params}, *args))
    tm = _load(tracklet.BoxTokenizer(DIM), params, "tracklet_conditioner/tokenizer/")
    with torch.no_grad():
        got = tm(_t(boxes), _t(mask), None if inst is None else torch.from_numpy(inst)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_instance_enhancer_matches_jax():
    x = np.random.RandomState(2).randn(2, F, N, DIM).astype(np.float32)
    jm = jtrk.InstanceEnhancer(HEADS)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _load(tracklet.InstanceEnhancer(DIM, HEADS), params, "tracklet_conditioner/enhancer/")
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), ref, **TOL)


def test_gated_self_attention_matches_jax():
    """Queries S = 20 visual tokens against S + N keys; gate 0.5."""
    rs = np.random.RandomState(3)
    x, objs = rs.randn(6, 20, 32).astype(np.float32), rs.randn(6, N, DIM).astype(np.float32)
    jm = jtrk.GatedSelfAttention(2, 16, gate_init=GATE)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(objs))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(objs)))
    prefix = "mid_block/attentions_0/gated_attentions_0/"
    tm = _load(tracklet.GatedSelfAttention(32, 2, 16, DIM), params, prefix)
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x), _t(objs)).numpy(), ref, **TOL)


def test_tracklet_conditioner_matches_jax():
    boxes, mask = _boxes(np.random.RandomState(4), 2, F, N)
    jm = jtrk.TrackletConditioner(DIM, HEADS)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(boxes), jnp.asarray(mask))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(boxes), jnp.asarray(mask)))
    tm = _load(tracklet.TrackletConditioner(DIM, HEADS), params, "tracklet_conditioner/")
    with torch.no_grad():
        got = tm(_t(boxes), _t(mask)).numpy()
    assert got.shape == (2 * F, N, DIM)
    np.testing.assert_allclose(got, ref, **TOL)


# ------------------------------------------------------------ the UNet --

def _unet_inputs(seed=5, b=2):
    rs = np.random.RandomState(seed)
    inputs = (rs.randn(b, F, 8, 8, 8).astype(np.float32), np.full((b,), 10.0, np.float32),
              rs.randn(b, 1, jcfg.TINY_UNET.cross_attention_dim).astype(np.float32),
              np.ones((b, 3), np.float32))
    return inputs, _boxes(rs, b, F, N)


@pytest.fixture(scope="module")
def unet_pair():
    """The JAX TINY UNet with the branch at gate 0.5, its params, and the
    port's UNet with the same weights."""
    cfg = dataclasses.replace(jcfg.TINY_UNET, tracklet_dim=DIM, tracklet_heads=HEADS,
                              tracklet_gate_init=GATE)
    from svd_xtend_tpu.models.unet import UNetSpatioTemporalConditionModel as JUNet
    junet = JUNet(cfg, dtype=jnp.float32)
    inputs, (boxes, mask) = _unet_inputs()
    params = jax.jit(junet.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs),
                                 jnp.asarray(boxes), jnp.asarray(mask))["params"]
    unet = UNetSpatioTemporalConditionModel(
        dataclasses.replace(tcfg.TINY_UNET, tracklet_dim=DIM, tracklet_heads=HEADS,
                            tracklet_gate_init=GATE)).eval()
    sd = convert.state_dict_from_jax({f"unet/{k}": v for k, v in
                                      jconv.flatten(params).items()})["unet"]
    unet.load_state_dict(sd, strict=True)
    return junet, params, unet


def test_unet_with_boxes_matches_jax(unet_pair):
    junet, params, unet = unet_pair
    inputs, (boxes, mask) = _unet_inputs(seed=6)
    ref = np.asarray(junet.apply({"params": params}, *map(jnp.asarray, inputs),
                                 jnp.asarray(boxes), jnp.asarray(mask)))
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, inputs), boxes=_t(boxes), box_mask=_t(mask)).numpy()
        plain = unet(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, ref, **NET_TOL)
    assert np.abs(got - plain).max() > 1e-3         # the boxes act at gate 0.5


def test_unet_at_gate_zero_equals_the_unet_without_the_branch(unet_pair):
    """Gate 0: tanh(0) = 0 times a finite attention is 0, so the output is
    the branch-free UNet's bit for bit, whatever the boxes; a missing mask
    is all ones."""
    _, _, unet = unet_pair
    zero = UNetSpatioTemporalConditionModel(
        dataclasses.replace(unet.config, tracklet_gate_init=0.0)).eval()
    sd = dict(unet.state_dict())
    sd.update({k: torch.zeros(1) for k in sd if k.endswith(("alpha_attn", "alpha_dense"))})
    zero.load_state_dict(sd, strict=True)
    plain = UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).eval()
    convert.load_unet_state(plain, {k: v for k, v in sd.items()
                                    if not convert.is_branch_key(k)})
    inputs, (boxes, mask) = _unet_inputs(seed=7)
    with torch.no_grad():
        ref = plain(*map(torch.from_numpy, inputs))
        for m in (mask, None):
            got = zero(*map(torch.from_numpy, inputs), boxes=_t(boxes),
                       box_mask=None if m is None else _t(m))
            assert torch.equal(got, ref)
        full = unet(*map(torch.from_numpy, inputs), boxes=_t(boxes))
        ones = unet(*map(torch.from_numpy, inputs), boxes=_t(boxes),
                    box_mask=torch.ones(boxes.shape[:3]))
    assert torch.equal(full, ones)


def test_stock_unet_file_loads_into_a_tracklet_unet(unet_pair, tmp_path):
    """A diffusers UNet export (which leaves the branch out, as JAX's
    flax_to_diffusers does) loads into a tracklet UNet with the branch left
    as it was; an unknown key still raises."""
    _, _, unet = unet_pair
    path = ckpt.export_unet_diffusers(unet, str(tmp_path / "unet"))
    sd = load_file(path)
    assert not any(convert.is_branch_key(k) for k in sd)
    fresh = tpipe.init_random_(UNetSpatioTemporalConditionModel(unet.config),
                               torch.Generator().manual_seed(1))
    branch = {k: v.clone() for k, v in fresh.state_dict().items() if convert.is_branch_key(k)}
    convert.load_unet_state(fresh, sd)
    for k, v in fresh.state_dict().items():
        want = branch[k] if k in branch else unet.state_dict()[k]
        assert torch.equal(v, want), k
    with pytest.raises(RuntimeError):
        convert.load_unet_state(fresh, {**sd, "extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError):
        convert.load_unet_state(fresh, {k: v for i, (k, v) in enumerate(sd.items()) if i})


# -------------------------------------------------------------- files --

def test_tracklet_file_written_by_jax_loads_in_the_port(unet_pair, tmp_path):
    _, params, unet = unet_pair
    path = str(tmp_path / "tracklet_weights.safetensors")
    jconv.save_safetensors(path, jconv.tracklet_branch_to_flat(params))
    fresh = tpipe.init_random_(UNetSpatioTemporalConditionModel(unet.config),
                               torch.Generator().manual_seed(2))
    convert.tracklet_branch_into_unet(load_file(path), fresh)
    for k, v in unet.state_dict().items():
        if convert.is_branch_key(k):
            assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(ValueError):
        convert.tracklet_branch_into_unet({"tracklet_conditioner/nope/kernel": np.zeros(2)},
                                          fresh)


def test_tracklet_file_written_by_the_port_loads_in_jax(unet_pair, tmp_path):
    """export_tracklet's file read with JAX's load_safetensors and merged
    with tracklet_branch_into_tree equals the JAX params bit for bit."""
    _, params, unet = unet_pair
    path = ckpt.export_tracklet(unet, str(tmp_path))
    assert os.path.basename(path) == ckpt.TRACKLET_FILE
    flat = jconv.load_safetensors(path)
    assert flat.keys() == jconv.tracklet_branch_to_flat(params).keys()
    zeroed = jax.tree.map(jnp.zeros_like, params)
    merged = jconv.flatten(jconv.tracklet_branch_into_tree(flat, zeroed))
    for p, a in jconv.tracklet_branch_to_flat(params).items():
        np.testing.assert_array_equal(merged[p], a, err_msg=p)


def test_lora_targets_over_a_tracklet_unet_follow_jax_order(unet_pair):
    _, params, unet = unet_pair
    want = [(convert._module_key(path[: -len("/kernel")]), tuple(reversed(shape)))
            for path, shape in jlora.target_paths(params)]
    assert lora.targets(unet) == want
    assert any("gated_attentions" in n for n, _ in want)
    assert any(n.startswith("tracklet_conditioner.enhancer") for n, _ in want)


# ------------------------------------------------------------ generate --

@pytest.fixture(scope="module")
def pair():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32).with_tracklet(
        DIM, heads=HEADS, gate_init=GATE)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    sds = convert.state_dict_from_jax(jconv.flatten(params))
    tm = tpipe.SVDModels.create(jm.unet_config, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    for name in ("unet", "vae", "clip"):
        getattr(tm, name).load_state_dict(sds[name], strict=True)
    return jm, params, tm


CFG_KW = dict(height=H, width=W, num_frames=2, num_inference_steps=4, decode_chunk_size=2)


@pytest.mark.parametrize("knobs", [{}, dict(uncond_reuse_interval=3),
                                   dict(deep_cache_interval=3, uncond_reuse_interval=3)],
                         ids=["exact", "k3", "n3k3"])
def test_generate_with_boxes_matches_jax(pair, knobs):
    """Zero boxes and a zero mask in every stacked pair's uncond half, the
    boxes alone in a cond-only pass; the noise is JAX's, given explicitly."""
    jm, params, tm = pair
    rs = np.random.RandomState(8)
    image = rs.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    boxes, mask = _boxes(rs, 1, 2, N)
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jpipe.generate(jm, params, jnp.asarray(image), rng,
                                    jcfg.PipelineConfig(**CFG_KW, **knobs),
                                    jnp.asarray(boxes), jnp.asarray(mask)))
    h8 = H // jcfg.TINY_VAE.downsample_factor
    img_noise, lat_noise = _jax_noise(rng, image.shape, (1, 2, h8, h8, 4))
    got = tpipe.generate(tm, _t(image), tcfg.PipelineConfig(**CFG_KW, **knobs),
                         image_noise=_t(img_noise), latent_noise=_t(lat_noise),
                         boxes=_t(boxes), box_mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, ref, **GEN_TOL)


def test_with_tracklet_keeps_the_weights_and_the_video_at_gate_zero(pair):
    """with_tracklet(gate 0) copies every UNet weight and adds a branch that
    leaves the video as it was, bit for bit, with boxes."""
    _, _, tm = pair
    # frozen as SVDModels.create leaves a network: the CPU's linear takes
    # another kernel for a weight that requires grad, even under no_grad
    plain = tpipe.SVDModels(
        UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).eval().requires_grad_(False),
        tm.vae, tm.clip)
    convert.load_unet_state(plain.unet, {k: v for k, v in tm.unet.state_dict().items()
                                         if not convert.is_branch_key(k)})
    zero = plain.with_tracklet(DIM, heads=HEADS, gate_init=0.0)
    assert zero.unet.config.tracklet_gate_init == 0.0
    for k, v in plain.unet.state_dict().items():
        assert torch.equal(zero.unet.state_dict()[k], v), k
    rs = np.random.RandomState(10)
    image = _t(rs.uniform(-1, 1, (1, H, W, 3)))
    boxes, mask = _boxes(rs, 1, 2, N)
    cfg = tcfg.PipelineConfig(**CFG_KW)
    a = tpipe.generate(plain, image, cfg, generator=torch.Generator().manual_seed(0))
    b = tpipe.generate(zero, image, cfg, generator=torch.Generator().manual_seed(0),
                       boxes=_t(boxes), box_mask=_t(mask))
    assert torch.equal(a, b)


# ------------------------------------------------------------ training --

def _draws(rng, shape, cfg):
    """jax_draws plus the box-dropout uniform from training_loss's k_box."""
    d = jax_draws(rng, shape, cfg)
    u = jax.random.uniform(jax.random.split(rng, 4)[2], (shape[0],))
    return d._replace(box_dropout_u=_t(u))


def test_trainable_names_match_jax_param_audit(pair):
    _, params, tm = pair
    jmask = jstate.trainable_mask(params["unet"], "tracklet")
    jfrozen, jtrain_names = jstate.param_audit(params["unet"], jmask)
    flat = jconv.flatten(params["unet"])
    want = convert.tracklet_state_dict({p: flat[p] for p in jtrain_names})
    frozen, names = tstate.param_audit(tstate.trainable_mask(tm.unet, "tracklet"))
    assert len(want) == len(jtrain_names) and set(names) == set(want)
    assert len(frozen) == len(jfrozen)
    assert all(convert.is_branch_key(n) for n in names)


@pytest.mark.parametrize("prob", [0.1, 0.6])
def test_box_dropout_in_the_loss_matches_jax(pair, prob):
    """training_loss with boxes at batch 2: the sample whose box uniform is
    below conditioning_dropout_prob trains on an all-zero mask (at 0.6 one
    of the two samples does, for this key); loss against JAX's."""
    jm, params, tm = pair
    rs = np.random.RandomState(11)
    pixels = rs.uniform(-1, 1, (2, 2, H, W, 3)).astype(np.float32)
    boxes, mask = _boxes(rs, 2, 2, N)
    jc = jcfg.TrainConfig(conditioning_dropout_prob=prob, encode_chunk_size=2)
    rng = jax.random.PRNGKey(12)
    draws = _draws(rng, pixels.shape, jc)
    dropped = (draws.box_dropout_u < prob).tolist()
    assert dropped == ([False, False] if prob == 0.1 else [False, True])
    ref = float(jtrain.training_loss(jm, params["unet"], {"vae": params["vae"],
                                                          "clip": params["clip"]},
                                     jnp.asarray(pixels), rng, jc, jnp.asarray(boxes),
                                     jnp.asarray(mask)))
    tc = tcfg.TrainConfig(conditioning_dropout_prob=prob, encode_chunk_size=2)
    with torch.no_grad():
        got = ttrain.training_loss(tm, _t(pixels), tc, draws, _t(boxes), _t(mask)).item()
    np.testing.assert_allclose(got, ref, **NET_TOL)
    kept = ttrain.box_dropout(_t(boxes), _t(mask), draws.box_dropout_u, prob)
    for i, d in enumerate(dropped):
        assert torch.equal(kept[i], torch.zeros_like(kept[i]) if d else _t(mask)[i])
    assert torch.equal(ttrain.box_dropout(_t(boxes), None, draws.box_dropout_u, 0.0),
                       torch.ones(2, 2, N))


def test_tracklet_train_steps_match_jax(pair):
    """Two 'tracklet' steps from gate 0.5 (at gate 0 the tokenizer's and
    enhancer's gradients are exactly zero and would hide a wrong one), remat
    block: loss, grad_norm and the updated branch against JAX's step with
    its draws fed in; every other UNet weight, the VAE and CLIP
    bit-identical. adam_epsilon 1e-6 as in test_torch_port_train.py."""
    jm, params, _ = pair
    kw = dict(train_mode="tracklet", tracklet_dim=DIM, tracklet_gate_init=GATE,
              learning_rate=1e-3, lr_scheduler="constant", encode_chunk_size=2,
              adam_epsilon=1e-6, conditioning_dropout_prob=0.3)
    jc = jcfg.TrainConfig(**kw)
    opt = joptim.make_optimizer(jc)
    jst = jstate.create_train_state(jc, params["unet"], opt)
    jstep = jax.jit(jstate.make_train_step(jm, jc, opt, {"vae": params["vae"],
                                                         "clip": params["clip"]}))
    sds = convert.state_dict_from_jax(jconv.flatten(params))
    tm = tpipe.SVDModels.create(jm.unet_config, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    for name in ("unet", "vae", "clip"):
        getattr(tm, name).load_state_dict(sds[name], strict=True)
    tc = tcfg.TrainConfig(**kw)
    tst = tstate.create_train_state(tc, tm)
    tstep = tstate.make_train_step(tm, tc)
    rng = jax.random.PRNGKey(21)
    for i in range(2):
        rs = np.random.RandomState(30 + i)
        pixels = rs.uniform(-1, 1, (1, F, H, W, 3)).astype(np.float32)
        boxes, mask = _boxes(rs, 1, F, N)
        jbatch = {"pixel_values": jnp.asarray(pixels), "boxes": jnp.asarray(boxes),
                  "box_mask": jnp.asarray(mask)}
        jst, jmet = jstep(jst, jbatch, rng)
        draws = _draws(jax.random.fold_in(rng, i), pixels.shape, jc)
        tst, tmet = tstep(tst, {"pixel_values": _t(pixels), "boxes": _t(boxes),
                                "box_mask": _t(mask)}, draws=draws)
        np.testing.assert_allclose(tmet["loss"], float(jmet["loss"]), **NET_TOL)
        np.testing.assert_allclose(tmet["grad_norm"], float(jmet["grad_norm"]), **NET_TOL)
    want = {k: v.numpy() for k, v in convert.state_dict_from_jax(
        {f"unet/{p}": a for p, a in jconv.flatten(jstate.unet_params_of(jst, jc)).items()}
    )["unet"].items()}
    for name, master in zip(tst.names, tst.params):
        np.testing.assert_allclose(master.numpy(), want[name], err_msg=name, **NET_TOL)
    trained = set(tst.names)
    for name, v in tm.unet.state_dict().items():
        if name not in trained:
            assert torch.equal(v, sds["unet"][name]), name
    for net in ("vae", "clip"):
        for k, v in getattr(tm, net).state_dict().items():
            assert torch.equal(v, sds[net][k]), k


def test_tracklet_scope_needs_the_branch():
    tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    with pytest.raises(ValueError):
        tstate.create_train_state(tcfg.TrainConfig(train_mode="tracklet"), tm)


# ------------------------------------------------------------- dataset --

def _video_dir(root, name, frames=6, boxes=None, mask=None):
    from PIL import Image
    folder = os.path.join(root, name)
    os.makedirs(folder)
    for i in range(frames):
        Image.new("RGB", (16, 8), (10 * i, 20, 30)).save(os.path.join(folder, f"{i:03d}.png"))
    if boxes is not None:
        extra = {} if mask is None else {"mask": mask}
        np.savez(os.path.join(folder, "boxes.npz"), boxes=boxes, **extra)


@pytest.mark.parametrize("max_boxes", [3, 8], ids=["truncate", "pad"])
def test_load_boxes_window_matches_jax(tmp_path, max_boxes):
    """Videos with a mask, without one (a box is live where it has positive
    area) and without a file (zero boxes, zero mask); windows at several
    starts, truncated or padded to max_boxes."""
    rs = np.random.RandomState(13)
    boxes = rs.uniform(0, 1, (6, 5, 4)).astype(np.float32)
    boxes[:, 1, 2] = boxes[:, 1, 0]                 # zero-area boxes: dead without a mask
    _video_dir(str(tmp_path), "a_mask", boxes=boxes,
               mask=(rs.uniform(0, 1, (6, 5)) > 0.5).astype(np.float32))
    _video_dir(str(tmp_path), "b_no_mask", boxes=boxes)
    _video_dir(str(tmp_path), "c_no_file")
    kw = dict(width=16, height=8, sample_frames=4, use_native=False, max_boxes=max_boxes)
    jd, td = JDataset(str(tmp_path), **kw), FrameFolderDataset(str(tmp_path), **kw)
    for vid in range(3):
        for start in (0, 2):
            want, got = jd.load_boxes_window(vid, start), td.load_boxes_window(vid, start)
            for w, g in zip(want, got):
                assert g.dtype == np.float32 and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    assert not td.load_boxes_window(2, 0)[1].any()
    sample, jsample = td.get(0, 1, 0), jd.get(0, 1, 0)
    assert sorted(sample) == sorted(jsample) == ["box_mask", "boxes", "pixel_values"]
    for k in sample:
        np.testing.assert_allclose(sample[k], jsample[k], atol=1e-6)


# ---------------------------------------------------------------- CLI --

def test_cli_tracklet_resume_is_bit_equal_and_writes_the_file(tmp_path):
    """``train.cli --train_mode tracklet`` at the TINY configs over the
    committed frames with a seeded boxes.npz: 4 straight steps against
    checkpoint-2 resumed to 4, the state bit for bit; the branch file in
    the JAX package's paths equals the final masters; the diffusers UNet
    export leaves the branch out."""
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.train import cli

    frames = str(tmp_path / "frames")
    shutil.copytree(fx.FRAMES, frames)
    rs = np.random.RandomState(14)
    for i, video in enumerate(sorted(os.listdir(frames))):
        n = len([x for x in os.listdir(os.path.join(frames, video)) if x.endswith(".jpg")])
        boxes, mask = _boxes(rs, 1, n, 3)
        extra = {"mask": mask[0]} if i else {}
        np.savez(os.path.join(frames, video, "boxes.npz"), boxes=boxes[0], **extra)

    def argv(out, *extra):
        return ["--base_folder", frames, "--device", "cpu", "--tiny_model", "--width", "64",
                "--height", "32", "--num_frames", "3", "--num_inference_steps", "2",
                "--learning_rate", "1e-3", "--lr_warmup_steps", "0", "--train_mode", "tracklet",
                "--tracklet_dim", str(DIM), "--max_boxes", "4", "--tracklet_gate_init", "0.5",
                "--output_dir", out, "--checkpointing_steps", "2", "--validation_steps", "4",
                "--max_train_steps", "4", *extra]

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    cli.main(argv(a))
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "checkpoint-2"), os.path.join(b, "checkpoint-2"))
    cli.main(argv(b, "--resume_from_checkpoint", "latest"))
    sa, sb = (torch.load(os.path.join(d, "checkpoint-4", "state", ckpt.STATE_FILE),
                         weights_only=True) for d in (a, b))
    assert sa["step"] == sb["step"] == 4
    assert list(sa["params"]) and all(convert.is_branch_key(n) for n in sa["params"])
    for n, t in sa["params"].items():
        assert torch.equal(t, sb["params"][n]), n
    for i, s in sa["optimizer"]["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["optimizer"]["adamw"]["state"][i][k]), (i, k)
    flat = load_file(os.path.join(a, ckpt.TRACKLET_FILE))
    assert all("/" in k for k in flat)
    sd = convert.tracklet_state_dict(flat)
    assert set(sd) == set(sa["params"])
    for n, t in sa["params"].items():
        assert torch.equal(sd[n], t), n
    unet = load_file(os.path.join(a, "unet", "diffusion_pytorch_model.safetensors"))
    assert unet and not any(convert.is_branch_key(k) for k in unet)
    with open(os.path.join(a, "params_train.txt")) as f:
        assert f.read().split("\n") == list(sa["params"])
    with open(os.path.join(a, "logs", "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line).get("train_loss", 0.0)) for line in f)
