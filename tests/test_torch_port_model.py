"""The port's tensor parallelism over the 'model' mesh axis
(``parallel/tensor.py``) and the int8 amax over every rank of a call, on
the CPU: pools of two and of four gloo ranks, spawned once for the module,
run the jobs the tests send them (the pattern of test_torch_port_frames.py);
the JAX references and one-rank runs are computed while the ranks work.

  - (a) int8 under data parallelism: every activation amax is the global
    batch's, as GSPMD's in the JAX package. Two data ranks, one image at
    half contrast (the rows' amaxes differ): in float64 the ranks' rows are
    the one-rank video of the whole batch to rel-L2 1e-12, the bound of
    test_torch_port_frames.py (e) (0 measured); in f32 the video is held
    against JAX's ``make_sharded_generate`` over data 2 in int8
    (SVDX_INT8_FORCE=1) at JAX's own quantisation noise (NOISE_RATIO of
    test_torch_port_quant.py, against the distance of JAX's int8 video from
    the port's exact one), as the one-rank int8 videos are;
  - (b) train steps at (data 1, model 2) and at (2, 2), with a UNet of odd
    head counts (1 and 3 heads: a rank without a head, a 2 / 1 split; the
    JAX references of this module all use it), against JAX's
    ``make_sharded_train_step`` over the same meshes with JAX's draws: loss
    rtol 2e-4, grad_norm rtol 2e-3 (test_sharding.py:89-92);
  - (c) ``generate_rows`` at model 2 and at (1, 2, 2) over model and frames
    against ``make_sharded_generate`` within 2e-3 (test_sharding.py:185);
  - (d) every mode (exact, boxes, int8) over (data 2, model 2) with odd
    heads in float64 against the one-rank video of the whole batch (1e-12);
  - (e) two steps over (2, 2) in the temporal, full+EMA and tracklet scopes,
    and over (1, 2, 2) model and frames, against one rank: loss and
    grad_norm within 1e-5 relative, the masters' change within ``DP_REL``;
  - (f) ZeRO-1 under model equals no ZeRO-1 bit for bit;
  - (g) a ZeRO-1 checkpoint saved at (2, 2) holds the one-rank files and
    tensors and restores on one rank, which goes on as the ranks do;
  - (h) the CLI's ``--mesh_model 2`` over two ranks: steps, a checkpoint, the
    validation video (every rank) and the export, which loads into a
    one-rank UNet;
  - (i) the GEGLU partial form's plain version summed over the ranks, plus
    b2 and x, is ``ln_geglu_residual_reference``;
  - (j) ``shard_state_dict``'s rules against JAX's ``param_pspec`` on every
    UNet leaf; the layout of the world and its groups;
  - (k) what a 'model' axis took last: 8-bit AdamW (the ranks' codes and
    scales are the one-rank ones bit for bit on the same gradients, with
    and without ZeRO-1; the gathered state is the one-rank state), the
    'lora' scope, host offload (bit for bit no offload) and an attention
    processor that mixes heads (the one-rank UNet to 1e-12 in float64, and
    steps through its gathers' backward); steps of each against one rank
    as (e), 'lora' and 8-bit against JAX's ``make_sharded_train_step`` as
    (b), and their checkpoints saved at (2, 2) restored on one rank as (g).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from svd_xtend_tpu_torch import parallel
from svd_xtend_tpu_torch.core.config import (TINY_CLIP, TINY_UNET, TINY_VAE, MeshConfig,
                                             PipelineConfig, TrainConfig)
from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
from svd_xtend_tpu_torch.models import attn_processor
from svd_xtend_tpu_torch.ops.kernels import geglu as gg
from svd_xtend_tpu_torch.parallel import tensor as tpl
from svd_xtend_tpu_torch.train import checkpoint as ckpt_lib
from svd_xtend_tpu_torch.train import quant as q8
from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                             make_train_step, write_back)

from test_torch_port_frames import Pool
from test_torch_port_parallel import DP_REL, _rel, _same

torch.set_num_threads(1)

ROWS = 2
F = 4
# a UNet whose levels hold 1 and 3 heads of 32: at model 2 one rank has no
# head at level 0 and level 1 splits 2 / 1
ODD_UNET = dataclasses.replace(TINY_UNET, block_out_channels=(32, 96),
                               num_attention_heads=(1, 3))
GEN_KW = dict(height=32, width=32, num_frames=F, num_inference_steps=2, decode_chunk_size=3)


# ------------------------------------------------------------ the jobs --

def _models(ucfg=TINY_UNET, sds=None, dtype=torch.float32, tracklet=False, tp=None):
    models = SVDModels.create(ucfg, TINY_VAE, TINY_CLIP, device="cpu", tp=tp,
                              generator=None if sds else torch.Generator().manual_seed(0))
    if sds is not None:
        models.load_unet_whole(sds["unet"])
        models.vae.load_state_dict(sds["vae"], strict=True)
        models.clip.load_state_dict(sds["clip"], strict=True)
    if tracklet:
        models = models.with_tracklet(16, heads=2, gate_init=0.5)
    for net in (models.unet, models.vae, models.clip):
        net.to(dtype)
    return models


def _cfg(scope_kw, mesh=MeshConfig(), **kw):
    return TrainConfig(**{**dict(train_mode="temporal", learning_rate=1e-3, height=32,
                                 width=32, num_frames=F, lr_warmup_steps=0, mesh=mesh),
                          **scope_kw, **kw})


def _batch(step, tracklet=False):
    g = torch.Generator().manual_seed(100 + step)
    pixels = torch.rand(ROWS, F, 32, 32, 3, generator=g) * 2 - 1
    if not tracklet:
        return pixels
    return {"pixel_values": pixels, "boxes": torch.rand(ROWS, F, 3, 4, generator=g),
            "box_mask": (torch.rand(ROWS, F, 3, generator=g) > 0.3).float()}


def _rows_of(batch, world):
    mine = parallel.rows(ROWS // world.data, world)
    if isinstance(batch, dict):
        return {k: v[mine] for k, v in batch.items()}
    return batch[mine]


def _run(scope_kw, world, steps, mesh=MeshConfig(), state=None, models=None, start=0):
    """(models, state, metrics) after `steps` steps of this rank's rows."""
    cfg = _cfg(scope_kw, mesh)
    tracklet = cfg.train_mode == "tracklet"
    if models is None:
        models = _models(tracklet=tracklet, tp=world.tensor_shard())
        state = create_train_state(cfg, models, world=world)
        cast_frozen_to_compute(models, torch.float32)
    step_fn = make_train_step(models, cfg, world)
    metrics = []
    for s in range(start, start + steps):
        batch = _rows_of(_batch(s, tracklet), world)
        state, m = step_fn(state, batch, generator=torch.Generator().manual_seed(s))
        metrics.append(m)
    return models, state, metrics


def _masters(state):
    return [p.detach().clone() for p in state.params]


def _world(base, mesh_kw):
    return parallel.mesh_world(base, MeshConfig(**mesh_kw))


def job_generate(base, mesh_kw, ucfg, sds, dtype, images, cfg_kw, noise, tracklet=False,
                 boxes=None):
    world = _world(base, mesh_kw)
    models = _models(ucfg, sds, dtype, tracklet, world.tensor_shard())
    kw = dict(image_noise=noise[0].to(dtype), latent_noise=noise[1].to(dtype))
    if boxes is not None:
        kw.update(boxes=boxes[0], box_mask=boxes[1])
    return parallel.generate_rows(models, images.to(dtype), PipelineConfig(**cfg_kw), world,
                                  **kw)


def job_jax_step(base, mesh_kw, ucfg, sds, kw, batches, draws, lora=None):
    """Steps from the JAX weights with JAX's draws (the global batch's; each
    rank keeps its rows); in the 'lora' scope from JAX's `lora` adapter (the
    port's form, whole)."""
    world = _world(base, mesh_kw)
    models = _models(ucfg, sds, tp=world.tensor_shard())
    cfg = TrainConfig(**kw, mesh=MeshConfig(**mesh_kw))
    state = create_train_state(cfg, models, world=world)
    if lora is not None:
        with torch.no_grad():
            for name, ab in state.lora.items():
                ab["a"].copy_(lora[name]["a"])
                ab["b"].copy_(lora[name]["b"])
    cast_frozen_to_compute(models, torch.float32)
    step = make_train_step(models, cfg, world)
    out = []
    b = batches[0].shape[0] // world.data
    for batch, d in zip(batches, draws):
        state, m = step(state, batch[parallel.rows(b, world)],
                        draws=parallel.local_draws(d, world, b))
        out.append(m)
    return out


def job_steps(base, mesh_kw, scope_kw):
    """Two steps; the metrics, and the whole masters on rank 0."""
    world = _world(base, mesh_kw)
    _, state, metrics = _run(scope_kw, world, 2, MeshConfig(**mesh_kw))
    sd = state.state_dict()
    return metrics, None if sd is None else list(sd["params"].values())


def job_zero1(base, mesh_kw, scope_kw):
    world = _world(base, mesh_kw)
    mesh = MeshConfig(**mesh_kw)
    _, plain, _ = _run(scope_kw, world, 2, mesh)
    _, zero, _ = _run({**scope_kw, "zero1": True}, world, 2, mesh)
    ema = [e for e in zero.ema_params if e is not None]
    return _masters(plain), _masters(zero), zero.optimizer.local, len(ema)


def job_save(base, mesh_kw, scope_kw, out, steps):
    """`steps` steps, a save by every rank (rank 0 writes), one step more;
    the whole masters (rank 0) then."""
    world = _world(base, mesh_kw)
    mesh = MeshConfig(**mesh_kw)
    models, state, _ = _run(scope_kw, world, steps, mesh)
    manager = ckpt_lib.CheckpointManager(out, 3, world=world)
    manager.save(steps, state, _cfg(scope_kw, mesh), {"step": steps}, blocking=True)
    manager.wait()
    _, state, _ = _run(scope_kw, world, 1, mesh, state, models, start=steps)
    sd = state.state_dict()
    return None if sd is None else list(sd["params"].values())


def job_codes(base, mesh_kw, scope_kw, grads):
    """Two 8-bit updates on the whole gradients `grads` (by trainable
    tensor; each rank takes its parts), without the clip: this rank's
    moments by tensor index, the optimizer's parts and axes, and the
    gathered state's optimizer (rank 0)."""
    world = _world(base, mesh_kw)
    models = _models(tp=world.tensor_shard())
    state = create_train_state(_cfg(scope_kw, MeshConfig(**mesh_kw), max_grad_norm=0.0), models,
                               world=world)
    opt = state.optimizer
    local = [g if lay is None else lay.shard(g, world.model_index)
             for g, lay in zip(grads, state.layouts)]
    for _ in range(2):
        opt.step([g.clone() for g in local])
    sd = state.state_dict()
    return (opt._local_entries(), opt.parts, opt.axes,
            None if sd is None else sd["optimizer"])


def job_variant(base, mesh_kw, scope_kw, extra_kw):
    """Two steps in `scope_kw`, then two from the same start with
    `extra_kw` added: both runs' masters."""
    world = _world(base, mesh_kw)
    mesh = MeshConfig(**mesh_kw)
    _, plain, _ = _run(scope_kw, world, 2, mesh)
    _, other, _ = _run({**scope_kw, **extra_kw}, world, 2, mesh)
    return _masters(plain), _masters(other)


def mix_heads(q, k, v, *, num_heads, scale, site):
    """An attention processor that mixes heads: each head's queries plus the
    previous head's, then softmax attention per head (plain torch)."""
    heads = lambda x: x.reshape(x.shape[:2] + (num_heads, -1)).transpose(1, 2)
    qh = heads(q)
    w = torch.softmax((qh + qh.roll(1, dims=1)) @ heads(k).transpose(-1, -2) * scale, dim=-1)
    return (w @ heads(v)).transpose(1, 2).reshape(q.shape[:2] + (-1,))


def job_processor(base, mesh_kw, inputs):
    """Under ``mix_heads`` at every site: the ODD_UNET's output in float64
    on `inputs`, and two temporal-scope steps (f32)."""
    world = _world(base, mesh_kw)
    models = _models(ODD_UNET, dtype=torch.float64, tp=world.tensor_shard())
    with attn_processor.processors(mix_heads):
        with torch.no_grad():
            out = models.unet(*inputs)
        _, _, metrics = _run(dict(), world, 2, MeshConfig(**mesh_kw))
    return out, metrics


def job_save_lora(base, mesh_kw, scope_kw, out, steps):
    """`job_save`, then the adapter file written by rank 0."""
    world = _world(base, mesh_kw)
    mesh = MeshConfig(**mesh_kw)
    models, state, _ = _run(scope_kw, world, steps, mesh)
    manager = ckpt_lib.CheckpointManager(out, 3, world=world)
    manager.save(steps, state, _cfg(scope_kw, mesh), {"step": steps}, blocking=True)
    manager.wait()
    if world.main and state.lora is not None:
        ckpt_lib.export_lora_diffusers(state.lora, out)
    _, state, _ = _run(scope_kw, world, 1, mesh, state, models, start=steps)
    sd = state.state_dict()
    return None if sd is None else list(sd["params"].values())


def job_cli(base, argv):
    from svd_xtend_tpu_torch.train import cli as tcli
    stats = tcli.main(argv)
    return stats["world_size"], len(stats["step_seconds"]), len(stats["validation_seconds"])


JOBS = {"generate": job_generate, "jax_step": job_jax_step, "steps": job_steps,
        "zero1": job_zero1, "save": job_save, "cli": job_cli, "codes": job_codes,
        "variant": job_variant, "processor": job_processor, "save_lora": job_save_lora}


@pytest.fixture(scope="module")
def two():
    pool = Pool(2, JOBS)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def four():
    pool = Pool(4, JOBS)
    yield pool
    pool.close()


# --------------------------------------------------------- JAX references --

def _jax_config(ucfg):
    from svd_xtend_tpu.core import config as jcfg
    return jcfg.UNetConfig(**dataclasses.asdict(ucfg))


def _jax_models(ucfg):
    """The JAX pipeline of UNet config `ucfg` (the port's, copied), its
    weights, and the port's state dicts of them."""
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.diffusion import pipeline as jpipe
    from svd_xtend_tpu.io import convert as jconv
    from svd_xtend_tpu_torch.io.convert import state_dict_from_jax

    jm = jpipe.SVDModels(unet_config=_jax_config(ucfg), vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    return jm, params, state_dict_from_jax(jconv.flatten(params))


@pytest.fixture(scope="module")
def jax_odd():
    return _jax_models(ODD_UNET)


def _jax_mesh(data, model, frames=1):
    import jax

    from svd_xtend_tpu.core.config import MeshConfig as JMesh
    from svd_xtend_tpu.core.mesh import create_mesh
    return create_mesh(JMesh(data=data, model=model, frames=frames),
                       jax.devices()[:data * model * frames])


def _jax_video(jm, params, images, rng, mesh, cfg_kw):
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.parallel.sharding import make_sharded_generate
    gen, place_params, place_images = make_sharded_generate(jm, mesh)
    return np.asarray(gen(place_params(params), place_images(jnp.asarray(images)), rng,
                          jcfg.PipelineConfig(**cfg_kw)))


def _noise_of(rng, b, h8=16):
    from test_torch_port_pipeline import _jax_noise
    return tuple(map(torch.from_numpy, _jax_noise(rng, (b, 32, 32, 3), (b, F, h8, h8, 4))))


# ---------------------------------------------------------------- (a) F6 --

def test_int8_amax_spans_the_data_axis(two, jax_odd, monkeypatch):
    """(a): two data ranks in int8, rows of different contrast."""
    import jax

    from test_torch_port_quant import _close_by_noise

    jm, params, sds = jax_odd
    rs = np.random.RandomState(5)
    images = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    images[1] *= 0.5
    rng = jax.random.PRNGKey(4)
    noise = _noise_of(rng, 2)
    cfg_kw = {**GEN_KW, "unet_quant": "int8", "vae_quant": "int8"}
    timages = torch.from_numpy(images)
    two.submit("generate", dict(data=2), ODD_UNET, None, torch.float64, timages, cfg_kw,
               noise)
    models = _models(ODD_UNET, dtype=torch.float64)
    whole = generate(models, timages.double(), PipelineConfig(**cfg_kw),
                     image_noise=noise[0].double(), latent_noise=noise[1].double())
    got = two.collect("generate")
    for rank in range(2):
        assert _rel([got[rank]], [whole[rank:rank + 1]]) <= 1e-12

    two.submit("generate", dict(data=2), ODD_UNET, sds, torch.float32, timages, cfg_kw, noise)
    monkeypatch.setenv("SVDX_INT8_FORCE", "1")
    ref = _jax_video(jm, params, images, rng, _jax_mesh(2, 1), cfg_kw)
    exact = generate(_models(ODD_UNET, sds=sds), timages, PipelineConfig(**GEN_KW),
                     image_noise=noise[0], latent_noise=noise[1]).numpy()
    got = two.collect("generate")
    video = np.concatenate([got[0].numpy(), got[1].numpy()])
    _close_by_noise(video, ref, exact, "int8 over data 2")


# ------------------------------------------------------ (b), (c) with JAX --

@pytest.mark.parametrize("mesh_kw", [dict(data=1, model=2), dict(data=2, model=2)],
                         ids=["model2-odd", "data2-model2"])
def test_train_step_over_model_matches_jax(two, four, jax_odd, mesh_kw):
    """(b): two steps of two videos of 4 frames, odd heads."""
    _steps_match_jax(two if mesh_kw["data"] == 1 else four, jax_odd, mesh_kw, {})


@pytest.mark.parametrize("scope_kw", [dict(train_mode="lora"), dict(use_8bit_adam=True)],
                         ids=["lora", "8bit"])
def test_lora_and_8bit_over_model_match_jax(two, jax_odd, scope_kw):
    """(k): (b) at (data 1, model 2) in the 'lora' scope (JAX's A, a seeded
    nonzero B: test_torch_port_train.py's start) and with 8-bit AdamW."""
    _steps_match_jax(two, jax_odd, dict(data=1, model=2), scope_kw)


def _steps_match_jax(pool, jax_odd, mesh_kw, scope_kw):
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.parallel import make_sharded_train_step
    from svd_xtend_tpu.train import optim as joptim
    from svd_xtend_tpu.train import state as jstate
    from svd_xtend_tpu_torch.io.convert import lora_from_jax
    from test_torch_port_train import _seed_lora, jax_draws

    jm, params, sds = jax_odd
    ucfg = ODD_UNET
    kw = {**dict(train_mode="temporal", learning_rate=1e-3, lr_scheduler="constant",
                 height=32, width=32, num_frames=F), **scope_kw}
    jc = jcfg.TrainConfig(**kw)
    rng = jax.random.PRNGKey(3)
    batches = [np.random.RandomState(40 + i).uniform(-1, 1, (2, F, 32, 32, 3))
               .astype(np.float32) for i in range(2)]
    draws = [jax_draws(jax.random.fold_in(rng, i), batches[i].shape, jc) for i in range(2)]
    opt = joptim.make_optimizer(jc)
    state = jstate.create_train_state(jc, jax.tree.map(lambda x: x.copy(), params["unet"]),
                                      opt)
    lora = None
    if jc.train_mode == "lora":
        state = _seed_lora(state, opt)
        lora = lora_from_jax(jax.tree.map(np.asarray, state.params))
    pool.submit("jax_step", mesh_kw, ucfg, sds, kw, [torch.from_numpy(b) for b in batches],
                draws, lora)

    mesh = _jax_mesh(mesh_kw["data"], mesh_kw["model"])
    step, place_state, place_batch = make_sharded_train_step(
        jm, jc, opt, {"vae": params["vae"], "clip": params["clip"]}, mesh)
    want = []
    with mesh:
        state = place_state(state)
        for b in batches:
            state, m = step(state, place_batch(jnp.asarray(b)), rng)
            want.append(m)
    got = pool.collect("jax_step")
    for rank in range(pool.size):
        for g, w in zip(got[rank], want):
            np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=2e-4)
            np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]), rtol=2e-3)
        assert got[rank] == got[0]


@pytest.mark.parametrize("mesh_kw", [dict(data=1, model=2), dict(data=1, model=2, frames=2)],
                         ids=["model2-odd", "model2-frames2"])
def test_generate_over_model_matches_jax(two, four, jax_odd, mesh_kw):
    """(c): two images; chunks of 3 over 4 frames; odd heads."""
    import jax

    pool = two if mesh_kw.get("frames", 1) == 1 else four
    jm, params, sds = jax_odd
    ucfg = ODD_UNET
    images = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    noise = _noise_of(rng, 2)
    pool.submit("generate", mesh_kw, ucfg, sds, torch.float32, torch.from_numpy(images),
                GEN_KW, noise)
    want = _jax_video(jm, params, images, rng,
                      _jax_mesh(1, mesh_kw["model"], mesh_kw.get("frames", 1)), GEN_KW)
    got = pool.collect("generate")
    for rank in range(pool.size):
        np.testing.assert_allclose(got[rank].numpy(), want, atol=2e-3, rtol=2e-3)


# ------------------------------------------------- against one rank --

MODES = {"exact": dict(), "boxes": dict(), "int8": dict(unet_quant="int8", vae_quant="int8")}


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_over_data_and_model_is_the_one_rank_video(four, mode):
    """(d): float64, where a row-parallel product's other summation order
    is below the bound (0 measured)."""
    cfg_kw = {**GEN_KW, **MODES[mode]}
    g = torch.Generator().manual_seed(1)
    images = (torch.rand(2, 32, 32, 3, generator=g) * 2 - 1).double()
    noise = (torch.randn(2, 32, 32, 3, generator=g).double(),
             torch.randn(2, F, 16, 16, 4, generator=g).double())
    tracklet = mode == "boxes"
    boxes = None
    if tracklet:
        boxes = (torch.rand(2, F, 3, 4, generator=g).double(),
                 (torch.rand(2, F, 3, generator=g) > 0.3).double())
    four.submit("generate", dict(data=2, model=2), ODD_UNET, None, torch.float64, images,
                cfg_kw, noise, tracklet, boxes)
    models = _models(ODD_UNET, None, torch.float64, tracklet)
    kw = dict(image_noise=noise[0], latent_noise=noise[1])
    if boxes is not None:
        kw.update(boxes=boxes[0], box_mask=boxes[1])
    whole = generate(models, images, PipelineConfig(**cfg_kw), **kw)
    got = four.collect("generate")
    for rank in range(4):
        row = rank // 2
        assert got[rank].shape == (1, F, 32, 32, 3)
        assert _rel([got[rank]], [whole[row:row + 1]]) <= 1e-12


SCOPES = [(dict(data=2, model=2), dict()),
          (dict(data=2, model=2), dict(train_mode="full", use_ema=True)),
          (dict(data=2, model=2), dict(train_mode="tracklet", tracklet_dim=16)),
          (dict(data=1, model=2, frames=2), dict()),
          (dict(data=2, model=2), dict(train_mode="lora")),
          (dict(data=2, model=2), dict(use_8bit_adam=True)),
          (dict(data=2, model=2), dict(use_8bit_adam=True, zero1=True,
                                       host_offload="masters+moments")),
          (dict(data=1, model=2, frames=2), dict(train_mode="lora", host_offload="masters"))]


@pytest.mark.parametrize("mesh_kw,scope_kw", SCOPES,
                         ids=["temporal", "full-ema", "tracklet", "model2-frames2", "lora",
                              "8bit", "8bit-zero1-offload", "lora-frames2-offload"])
def test_model_steps_as_one_rank(four, mesh_kw, scope_kw):
    """(e): the global batch of two videos."""
    four.submit("steps", mesh_kw, scope_kw)
    tracklet = "tracklet_dim" in scope_kw
    before = _masters(create_train_state(_cfg(scope_kw), _models(tracklet=tracklet)))
    _, single, metrics = _run(scope_kw, parallel.SINGLE, 2)
    got = four.collect("steps")
    want = [x - y for x, y in zip(_masters(single), before)]
    for rank in range(4):
        m, _ = got[rank]
        for a, b in zip(m, metrics):
            assert a["lr"] == b["lr"]
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
        assert m == got[0][0]
    assert _rel([x - y for x, y in zip(got[0][1], before)], want) <= DP_REL


def test_zero1_under_model_is_exact(four):
    """(f): over (2, 2) ZeRO-1 partitions each model index's tensors over
    its two data ranks (the EMA too)."""
    scope_kw = dict(train_mode="full", use_ema=True)
    got = four("zero1", dict(data=2, model=2), scope_kw)
    for m in range(2):
        a, b = got[m], got[2 + m]          # the data ranks of model index m
        assert sorted(a[2] + b[2]) == list(range(len(a[0])))
        assert a[3] + b[3] == len(a[0])
    for rank in range(4):
        _same(got[rank][0], got[rank][1])


def test_checkpoint_from_model_resumes_on_one_rank(four, tmp_path):
    """(g): four ZeRO-1 ranks in (2, 2) save after 2 steps and go on to 3;
    the file holds the one-rank tensors (names and shapes); one rank
    restores it bit for bit and goes on as they did."""
    scope_kw = dict(train_mode="full", use_ema=True, zero1=True)
    out = str(tmp_path / "four")
    four.submit("save", dict(data=2, model=2), scope_kw, out, 2)
    one_kw = dict(train_mode="full", use_ema=True)
    models = _models()
    one = create_train_state(_cfg(one_kw), models)
    cast_frozen_to_compute(models, torch.float32)
    ref = one.state_dict()
    after = four.collect("save")
    path = os.path.join(out, "checkpoint-2")
    sd = torch.load(os.path.join(path, "state", ckpt_lib.STATE_FILE), weights_only=True)
    assert sd["step"] == 2
    for key in ("params", "ema_params"):
        assert {k: v.shape for k, v in sd[key].items()} == {k: v.shape
                                                            for k, v in ref[key].items()}
    moments = sd["optimizer"]["adamw"]["state"]
    assert sorted(moments) == list(range(len(sd["params"])))
    for i, v in enumerate(sd["params"].values()):
        assert moments[i]["exp_avg"].shape == v.shape

    one, _, _ = ckpt_lib.CheckpointManager(out, 3).restore(path, one)
    write_back(models, _cfg(one_kw), one)
    _same([t for t in one.state_dict()["params"].values()], list(sd["params"].values()))
    _, one, _ = _run(one_kw, parallel.SINGLE, 1, state=one, models=models, start=2)
    start = list(sd["params"].values())
    assert _rel([a - b for a, b in zip(_masters(one), start)],
                [a - b for a, b in zip(after[0], start)]) <= DP_REL
    assert all(after[r] is None for r in range(1, 4))


def _whole_grads(scope_kw):
    """Seeded whole gradients of the scope's trainable tensors (one-rank
    shapes), of scales 1e-1 to 1e-4 so that the blocks' absmaxes differ."""
    state = create_train_state(_cfg(scope_kw), _models())
    g = torch.Generator().manual_seed(7)
    return [torch.randn(p.shape, generator=g) * 10.0 ** -(1 + i % 4)
            for i, p in enumerate(state.params)]


@pytest.mark.parametrize("scope_kw", [dict(use_8bit_adam=True),
                                      dict(use_8bit_adam=True, zero1=True)],
                         ids=["8bit", "8bit-zero1"])
def test_8bit_codes_over_model_are_the_one_rank_codes(four, scope_kw):
    """(k): two 8-bit updates at (2, 2) on the same whole gradients as one
    rank (no clip, whose global norm sums in another order): each rank's
    codes are its values' one-rank codes and its scales the whole blocks'
    one-rank scales, bit for bit (the whole tensor's blocks, cut in JAX's
    order, as GSPMD computes them), its f32 moments its parts of the
    one-rank ones; rank 0's gathered state is the one-rank state."""
    grads = _whole_grads(scope_kw)
    four.submit("codes", dict(data=2, model=2), scope_kw, grads)
    one = create_train_state(_cfg(scope_kw, max_grad_norm=0.0), _models())
    for _ in range(2):
        one.optimizer.step([g.clone() for g in grads])
    whole = one.state_dict()["optimizer"]["adamw8"]
    got = four.collect("codes")
    split = 0
    for rank in range(4):
        entries, parts, axes, _ = got[rank]
        for i, moments in entries.items():
            for mine, ref in zip(moments, (whole["mu"][i], whole["nu"][i])):
                if parts[i] is None:
                    want = ref
                elif isinstance(ref, dict):
                    want, split = q8.part_of(ref, parts[i], axes[i]), split + 1
                else:
                    want = parts[i].layout.shard(ref, parts[i].index)
                if isinstance(ref, dict):
                    assert torch.equal(mine["q"], want["q"]), (rank, i)
                    assert torch.equal(mine["scale"], want["scale"]), (rank, i)
                else:
                    assert torch.equal(mine, want), (rank, i)
    assert split > 0
    gathered = got[0][3]["adamw8"]
    assert gathered["count"] == whole["count"] and gathered["block_order"] == q8.BLOCK_ORDER
    for key in ("mu", "nu"):
        for a, b in zip(gathered[key], whole[key]):
            if isinstance(b, dict):
                assert torch.equal(a["q"], b["q"]) and torch.equal(a["scale"], b["scale"])
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("scope_kw", [dict(), dict(use_8bit_adam=True)], ids=["fp32", "8bit"])
def test_host_offload_under_model_is_exact(four, scope_kw):
    """(k): host offload of the masters and moments at (2, 2) gives the
    masters without offload bit for bit; it works per local tensor (8-bit:
    the scales' all-reduce reads the offloaded moments through the
    device)."""
    got = four("variant", dict(data=2, model=2), scope_kw,
               dict(host_offload="masters+moments"))
    for rank in range(4):
        _same(got[rank][0], got[rank][1])


def test_head_mixing_processor_over_model_is_one_rank(two):
    """(k): an attention processor that mixes heads sees every head under a
    model axis: the ODD_UNET (a rank without a head at level 0, 2 / 1 at
    level 1) in float64 is the one-rank output to 1e-12, and two temporal
    steps through the gathers' backward give the one-rank metrics within
    1e-5 relative."""
    g = torch.Generator().manual_seed(3)
    ucfg = ODD_UNET
    inputs = (torch.randn(2, F, 8, 8, ucfg.in_channels, generator=g).double(),
              torch.tensor([1.5, 0.5], dtype=torch.float64),
              torch.randn(2, 1, ucfg.cross_attention_dim, generator=g).double(),
              torch.rand(2, 3, generator=g).double() * 10)
    two.submit("processor", dict(model=2), inputs)
    unet = _models(ODD_UNET, dtype=torch.float64).unet
    with attn_processor.processors(mix_heads):
        with torch.no_grad():
            want = unet(*inputs)
        _, _, metrics = _run(dict(), parallel.SINGLE, 2)
    with torch.no_grad():
        assert _rel([unet(*inputs)], [want]) > 1e-3      # the processor changes the output
    got = two.collect("processor")
    for rank in range(2):
        out, m = got[rank]
        assert _rel([out], [want]) <= 1e-12
        for a, b in zip(m, metrics):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("scope_kw", [dict(use_8bit_adam=True, zero1=True),
                                      dict(train_mode="lora")], ids=["8bit-zero1", "lora"])
def test_8bit_and_lora_checkpoints_from_model_resume_on_one_rank(four, tmp_path, scope_kw):
    """(k): as (g) for an 8-bit ZeRO-1 state (the file holds the one-rank
    moments: whole codes and scales in JAX's block order) and the 'lora'
    scope (the whole adapter; rank 0's adapter file holds the one-rank
    file's keys and shapes, and its values are the ranks' adapter)."""
    from svd_xtend_tpu_torch.io import safetensors_io as st_io
    from svd_xtend_tpu_torch.io.convert import lora_state_dict

    out = str(tmp_path / "four")
    four.submit("save_lora", dict(data=2, model=2), scope_kw, out, 2)
    one_kw = {k: v for k, v in scope_kw.items() if k != "zero1"}
    models = _models()
    one = create_train_state(_cfg(one_kw), models)
    cast_frozen_to_compute(models, torch.float32)
    ref = one.state_dict()
    after = four.collect("save_lora")
    path = os.path.join(out, "checkpoint-2")
    sd = torch.load(os.path.join(path, "state", ckpt_lib.STATE_FILE), weights_only=True)
    assert sd["step"] == 2
    assert {k: v.shape for k, v in sd["params"].items()} == {k: v.shape
                                                            for k, v in ref["params"].items()}
    key = "adamw8" if scope_kw.get("use_8bit_adam") else "adamw"
    shapes = lambda o: [{k: v.shape for k, v in m.items()} if isinstance(m, dict) else m.shape
                        for m in o[key]["mu"] + o[key]["nu"]]
    if key == "adamw8":
        assert shapes(sd["optimizer"]) == shapes(ref["optimizer"])
    one, _, _ = ckpt_lib.CheckpointManager(out, 3).restore(path, one)
    write_back(models, _cfg(one_kw), one)
    _same([t for t in one.state_dict()["params"].values()], list(sd["params"].values()))
    if one.lora is not None:
        adapter = st_io.load_file(os.path.join(out, "pytorch_lora_weights.safetensors"))
        mine = lora_state_dict(one.lora)
        assert {k: v.shape for k, v in adapter.items()} == {k: v.shape for k, v in mine.items()}
        _same([adapter[k] for k in mine], list(sd["params"].values()))
    _, one, _ = _run(one_kw, parallel.SINGLE, 1, state=one, models=models, start=2)
    start = list(sd["params"].values())
    assert _rel([a - b for a, b in zip(_masters(one), start)],
                [a - b for a, b in zip(after[0], start)]) <= DP_REL


def test_cli_over_a_model_axis(two, tmp_path):
    """(h): ``--mesh_model 2`` over two ranks: 2 steps, a checkpoint at 2,
    validation at the first and last step on both ranks, the export on
    rank 0, which loads into a one-rank UNet."""
    from PIL import Image

    from svd_xtend_tpu_torch.io import safetensors_io as st
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel

    frames = tmp_path / "frames"
    rs = np.random.RandomState(0)
    for v in range(2):
        d = frames / f"video{v}"
        d.mkdir(parents=True)
        for f in range(3):
            arr = rs.randint(0, 255, (40, 48, 3)).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{f:04d}.jpg")
    out = str(tmp_path / "out")
    argv = ["--base_folder", str(frames), "--tiny_model", "--device", "cpu", "--width", "32",
            "--height", "32", "--num_frames", "3", "--learning_rate", "1e-3",
            "--lr_warmup_steps", "0", "--output_dir", out, "--checkpointing_steps", "2",
            "--validation_steps", "2", "--num_inference_steps", "2", "--num_workers", "1",
            "--max_train_steps", "2", "--mesh_model", "2", "--train_mode", "full",
            "--use_ema"]
    got = two("cli", argv)
    assert got[0] == got[1] == (2, 2, 2)
    assert os.path.isdir(os.path.join(out, "checkpoint-2", "state"))
    assert os.path.exists(os.path.join(out, "validation_images", "val_img_2.gif"))
    sd = st.load_file(os.path.join(out, "unet", "diffusion_pytorch_model.safetensors"))
    UNetSpatioTemporalConditionModel(TINY_UNET).load_state_dict(sd, strict=True)


# ------------------------------------------------------ (i), (j) no pool --

@pytest.mark.parametrize("n", [2, 4])
def test_geglu_partial_sums_to_the_whole(n):
    """(i): at 4 ranks over an inner width of 128 (two blocks of 64) two
    ranks hold none and add zero parts. float64: the sum is the whole
    product to rounding."""
    rng = np.random.default_rng(n)
    t, c = 37, 32
    rn = lambda *s, sc=1.0: torch.from_numpy(rng.standard_normal(s) * sc)
    x, ls, lb = rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c)
    w1, b1 = rn(8 * c, c, sc=c ** -0.5), 0.1 * rn(8 * c)
    w2, b2 = rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.ff"
    lay1 = tpl.layout(key + ".net.0.proj.weight", TINY_UNET, n)
    lay_b1 = tpl.layout(key + ".net.0.proj.bias", TINY_UNET, n)
    lay2 = tpl.layout(key + ".net.2.weight", TINY_UNET, n)
    assert lay1.sizes == lay2.sizes == tuple(tpl.ff_split(4 * c, n))
    total = sum(gg.ln_geglu_partial_reference(x, ls, lb, lay1.shard(w1, r), lay_b1.shard(b1, r),
                                              lay2.shard(w2, r)) for r in range(n))
    want = gg.ln_geglu_residual_reference(x, ls, lb, w1, b1, w2, b2)
    assert torch.allclose(x + (total + b2), want, rtol=0, atol=1e-12)
    assert torch.equal(lay1.unshard([lay1.shard(w1, r) for r in range(n)]), w1)


def test_shard_rules_match_jax_param_pspec(jax_odd):
    """(j): every UNet leaf of the JAX weights: the weights JAX shards over
    'model' are the ones the port splits, on the same axis (JAX's (in,
    out) kernel column-parallel on out is the port's rows); the biases of
    column-parallel products, replicated in JAX, follow their rows here."""
    from jax.sharding import PartitionSpec as P

    from svd_xtend_tpu.core.mesh import MODEL_AXIS, param_pspec
    from svd_xtend_tpu.io import convert as jconv
    from svd_xtend_tpu_torch.io.convert import diffusers_state_dict

    _, params, _ = jax_odd
    flat = jconv.flatten({"unet": params["unet"]})
    sharded = 0
    for path, v in flat.items():
        rest = path.split("/", 1)[1]
        (key,) = diffusers_state_dict({rest: v})
        lay = tpl.layout(key, ODD_UNET, 2)
        if v.ndim >= 2:
            spec = param_pspec(rest, v, tp=True)
            want = {P(): None, P(None, MODEL_AXIS): 0, P(MODEL_AXIS, None): 1}[spec]
            assert (None if lay is None else lay.dim) == want, (key, spec)
            sharded += want is not None
        else:
            col = tpl.COLUMN_PARALLEL.search(key.rsplit(".", 1)[0])
            assert (lay is not None) == bool(col) and (lay is None or lay.dim == 0), key
    # 24 weights in each of the UNet's 4 transformer models (TINY_UNET's
    # layout): attn1, attn2 and ff of both blocks, ff_in, proj_in and proj_out
    assert sharded == 96


def test_model_layout_and_splits():
    """(j): data outer, model in the middle, frames inner; whole heads as
    evenly as they go, the lower ranks one more; the feed-forward in blocks
    of 64; a layout that the world does not hold raises."""
    world = parallel.World(5, 8, frames=2, model=2)     # (data 1, model 0, frames 1)
    assert (world.data, world.data_index, world.model_index, world.frames_index) == (2, 1, 0, 1)
    assert world.tensor_shard().ranks == (5, 7) and world.tensor_shard().index == 0
    assert world.frame_shard(4).ranks == (4, 5)
    assert world.replicas == [0, 1, 4, 5] and world.replica_index == 3
    assert parallel.rows(1, world) == slice(1, 2)
    assert tpl.split(5, 2) == [3, 2] and tpl.split(1, 2) == [1, 0]
    assert tpl.ff_split(1280, 8) == [192] * 4 + [128] * 4
    lay = tpl.layout("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
                     dataclasses.replace(TINY_UNET, block_out_channels=(320, 640),
                                         num_attention_heads=(5, 10)), 2)
    assert lay.sizes == (192, 128) and lay.dim == 0
    assert tpl.layout("down_blocks.0.attentions.0.proj_out.bias", TINY_UNET, 2) is None
    assert tpl.layout("down_blocks.0.resnets.0.conv1.weight", TINY_UNET, 2) is None
    with pytest.raises(ValueError):
        parallel.mesh_world(parallel.World(0, 4), MeshConfig(model=3))
    with pytest.raises(ValueError):
        parallel.mesh_world(parallel.World(0, 4), MeshConfig(data=4, model=2))
