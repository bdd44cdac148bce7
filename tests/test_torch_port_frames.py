"""The port's sequence parallelism over the 'frames' mesh axis
(``parallel/frames.py``, ``parallel.mesh_world``) on the CPU: pools of two
and of four gloo ranks, spawned once for the module, run the jobs the tests
send them; each test waits for its answer under its own time limit, and the
JAX references and one-rank runs are computed while the ranks work.

  - (a) a train step over a frames axis of 2 against JAX's
    ``make_sharded_train_step`` over its (1, 1, 2) mesh, with JAX's draws:
    loss rtol 2e-4, grad_norm rtol 2e-3 (JAX's own bounds,
    test_sharding.py:89-92, 135);
  - (b) (data 2, frames 2) against the one-rank port over 2 steps in each
    scope: loss and grad_norm within 1e-5 relative, the masters' change
    within ``DP_REL``;
  - (c) ZeRO-1 under frames equals no ZeRO-1 bit for bit;
  - (d) a checkpoint saved under (2, 2) restores on one rank, which goes on
    as the four ranks do;
  - (e) ``generate_rows`` over frames 2 and over (2, 2) against
    ``make_sharded_generate``'s video within 2e-3 (test_sharding.py:185),
    and in every mode (exact, n3+k3, boxes, int8) against the one-rank
    port. That comparison runs in float64: there the sharded video is the
    one-rank video to 1e-12 (0 measured); in f32 the spatial layers' other
    batch sizes round otherwise, and two 700-sigma Euler steps carry it to
    a rel-L2 of about 1e-5;
  - (f) a frames axis of 4 over a latent whose second level holds 81
    tokens, split 21 / 20 / 20 / 20 (the counterpart of JAX's frames-7
    test): generate and a train step against one rank;
  - (g) ``check_ported`` takes a frames axis (and a 'model' axis beside
    it) and refuses an uneven split, as the JAX package's ``shard_batch``
    refuses to place such a batch;
  - (h) ``generate_rows`` over an uneven split (6 frames over 4, 5 over 2:
    2 / 2 / 1 / 1 and 3 / 2) against the one-rank video (float64, 1e-12)
    and ``make_sharded_generate`` over the same mesh (2e-3), whose GSPMD
    pads the frame axis.
"""

import multiprocessing as mp
import os
import shutil
import traceback

import numpy as np
import pytest
import torch

from svd_xtend_tpu_torch import parallel
from svd_xtend_tpu_torch.core.config import (TINY_CLIP, TINY_UNET, TINY_VAE, MeshConfig,
                                             PipelineConfig, TrainConfig)
from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
from svd_xtend_tpu_torch.train import checkpoint as ckpt_lib
from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                             make_train_step, write_back)

from test_torch_port_parallel import DP_REL, _rel, _same, answers, rendezvous, start_group

torch.set_num_threads(1)

ROWS = 2                    # the global batch of the train jobs
F = 4


# ------------------------------------------------------------ the jobs --

def _models(sds=None, dtype=torch.float32, tracklet=False):
    models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    if sds is not None:
        for name in ("unet", "vae", "clip"):
            getattr(models, name).load_state_dict(sds[name], strict=True)
    if tracklet:
        models = models.with_tracklet(16, heads=2, gate_init=0.5)
    for net in (models.unet, models.vae, models.clip):
        net.to(dtype)
    return models


def _cfg(scope_kw, frames=1, **kw):
    return TrainConfig(**{**dict(train_mode="temporal", learning_rate=1e-3, height=32,
                                 width=32, num_frames=F, lr_warmup_steps=0,
                                 mesh=MeshConfig(frames=frames)), **scope_kw, **kw})


def _batch(step, rows=ROWS, size=32, tracklet=False):
    g = torch.Generator().manual_seed(100 + step)
    pixels = torch.rand(rows, F, size, size, 3, generator=g) * 2 - 1
    if not tracklet:
        return pixels
    return {"pixel_values": pixels, "boxes": torch.rand(rows, F, 3, 4, generator=g),
            "box_mask": (torch.rand(rows, F, 3, generator=g) > 0.3).float()}


def _rows_of(batch, world):
    mine = parallel.rows(ROWS // world.data, world)
    if isinstance(batch, dict):
        return {k: v[mine] for k, v in batch.items()}
    return batch[mine]


def _run(scope_kw, world, steps, state=None, models=None, start=0, size=32):
    """(models, state, metrics) after `steps` steps of this rank's rows."""
    cfg = _cfg(scope_kw, world.frames, height=size, width=size)
    tracklet = cfg.train_mode == "tracklet"
    if models is None:
        models = _models(tracklet=tracklet)
        state = create_train_state(cfg, models, world=world)
        cast_frozen_to_compute(models, torch.float32)
    step_fn = make_train_step(models, cfg, world)
    metrics = []
    for s in range(start, start + steps):
        batch = _rows_of(_batch(s, size=size, tracklet=tracklet), world)
        state, m = step_fn(state, batch, generator=torch.Generator().manual_seed(s))
        metrics.append(m)
    return models, state, metrics


def _masters(state):
    return [p.detach().clone() for p in state.params]


def job_jax_step(base, frames, sds, kw, batches, draws):
    """Steps from the JAX weights with JAX's draws (the global batch's; each
    rank keeps its rows and frames)."""
    world = parallel.mesh_world(base, MeshConfig(frames=frames))
    models = _models(sds)
    cfg = TrainConfig(**kw, mesh=MeshConfig(frames=frames))
    state = create_train_state(cfg, models, world=world)
    cast_frozen_to_compute(models, torch.float32)
    step = make_train_step(models, cfg, world)
    out = []
    b = batches[0].shape[0] // world.data
    for batch, d in zip(batches, draws):
        state, m = step(state, batch[parallel.rows(b, world)],
                        draws=parallel.local_draws(d, world, b))
        out.append(m)
    return out


def job_steps(base, frames, scope_kw, steps, size=32):
    world = parallel.mesh_world(base, MeshConfig(frames=frames))
    _, state, metrics = _run(scope_kw, world, steps, size=size)
    return _masters(state), metrics


def job_zero1(base, frames, scope_kw):
    world = parallel.mesh_world(base, MeshConfig(frames=frames))
    _, plain, _ = _run(scope_kw, world, 2)
    _, zero, _ = _run({**scope_kw, "zero1": True}, world, 2)
    return _masters(plain), _masters(zero), zero.optimizer.local


def job_save(base, frames, scope_kw, out, steps):
    """`steps` steps, a save by every rank (rank 0 writes), one step more;
    the masters then."""
    world = parallel.mesh_world(base, MeshConfig(frames=frames))
    models, state, _ = _run(scope_kw, world, steps)
    manager = ckpt_lib.CheckpointManager(out, 3, world=world)
    manager.save(steps, state, _cfg(scope_kw, frames), {"step": steps}, blocking=True)
    manager.wait()
    _, state, _ = _run(scope_kw, world, 1, state, models, start=steps)
    return _masters(state)


def job_generate(base, frames, sds, dtype, images, cfg_kw, tracklet=False, noise=None,
                 boxes=None):
    world = parallel.mesh_world(base, MeshConfig(frames=frames))
    models = _models(sds, dtype, tracklet)
    kw = dict(generator=torch.Generator().manual_seed(2))
    if noise is not None:
        kw = dict(image_noise=noise[0], latent_noise=noise[1])
    if boxes is not None:
        kw.update(boxes=boxes[0], box_mask=boxes[1])
    return parallel.generate_rows(models, images.to(dtype), PipelineConfig(**cfg_kw), world,
                                  **kw)


JOBS = {"jax_step": job_jax_step, "steps": job_steps, "zero1": job_zero1, "save": job_save,
        "generate": job_generate}


def _worker(rank, size, store, jobs, results, table):
    world = start_group(rank, size, store)
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, name, True, table[name](world, *args)))
            except BaseException:
                results.put((rank, name, False, traceback.format_exc()))
    finally:
        parallel.close_world(world)


# -------------------------------------------------------------- the pools --

class Pool:
    """`size` gloo ranks running the jobs of `table` (this module's JOBS by
    default; module-level functions, which the spawned ranks import);
    ``submit(name, *args)`` sends a job to every rank, ``collect(name)``
    returns their answers by rank (``answers``: within its time limit,
    failing at once where a rank has died)."""

    def __init__(self, size, table=None):
        ctx = mp.get_context("spawn")
        self.tmp, store = rendezvous()
        self.size = size
        self.jobs = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, args=(r, size, store, self.jobs[r],
                                                        self.results, table or JOBS),
                                  daemon=True)
                      for r in range(size)]
        for p in self.procs:
            p.start()

    def submit(self, name, *args):
        for q in self.jobs:
            q.put((name, args))

    def collect(self, name):
        return answers(self.results, self.procs, name)

    def __call__(self, name, *args):
        self.submit(name, *args)
        return self.collect(name)

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def two():
    pool = Pool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def four():
    pool = Pool(4)
    yield pool
    pool.close()


# --------------------------------------------------------- JAX references --

@pytest.fixture(scope="module")
def jax_pair():
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.diffusion import pipeline as jpipe
    from svd_xtend_tpu.io import convert as jconv
    from svd_xtend_tpu_torch.io.convert import state_dict_from_jax

    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    return jm, params, state_dict_from_jax(jconv.flatten(params))


def _jax_mesh(data, frames):
    import jax

    from svd_xtend_tpu.core.config import MeshConfig as JMesh
    from svd_xtend_tpu.core.mesh import create_mesh
    return create_mesh(JMesh(data=data, model=1, frames=frames),
                       jax.devices()[:data * frames])


def test_train_step_over_frames_matches_jax(two, jax_pair):
    """(a): two steps of one video of 4 frames over a frames axis of 2."""
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.parallel import make_sharded_train_step
    from svd_xtend_tpu.train import optim as joptim
    from svd_xtend_tpu.train import state as jstate
    from test_torch_port_train import jax_draws

    jm, params, sds = jax_pair
    kw = dict(train_mode="temporal", learning_rate=1e-3, lr_scheduler="constant",
              height=32, width=32, num_frames=F)
    jc = jcfg.TrainConfig(**kw)
    rng = jax.random.PRNGKey(3)
    batches = [np.random.RandomState(40 + i).uniform(-1, 1, (1, F, 32, 32, 3))
               .astype(np.float32) for i in range(2)]
    draws = [jax_draws(jax.random.fold_in(rng, i), batches[i].shape, jc) for i in range(2)]
    two.submit("jax_step", 2, sds, kw, [torch.from_numpy(b) for b in batches], draws)

    opt = joptim.make_optimizer(jc)
    mesh = _jax_mesh(1, 2)
    state = jstate.create_train_state(jc, jax.tree.map(lambda x: x.copy(), params["unet"]),
                                      opt)
    step, place_state, place_batch = make_sharded_train_step(
        jm, jc, opt, {"vae": params["vae"], "clip": params["clip"]}, mesh)
    want = []
    with mesh:
        state = place_state(state)
        for b in batches:
            state, m = step(state, place_batch(jnp.asarray(b)), rng)
            want.append(m)
    got = two.collect("jax_step")
    for rank in range(2):
        for g, w in zip(got[rank], want):
            np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=2e-4)
            np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]), rtol=2e-3)
    assert got[0] == got[1]


SCOPES = [dict(), dict(train_mode="full", use_ema=True), dict(train_mode="lora"),
          dict(train_mode="tracklet", tracklet_dim=16)]


@pytest.mark.parametrize("scope_kw", SCOPES, ids=["temporal", "full-ema", "lora", "tracklet"])
def test_data_and_frames_step_as_one_rank(four, scope_kw):
    """(b): (data 2, frames 2) over a global batch of two videos."""
    four.submit("steps", 2, scope_kw, 2)
    before = _masters(create_train_state(_cfg(scope_kw),
                                         _models(tracklet="tracklet_dim" in scope_kw)))
    _, single, metrics = _run(scope_kw, parallel.SINGLE, 2)
    got = four.collect("steps")
    want = [x - y for x, y in zip(_masters(single), before)]
    for rank in range(4):
        masters, m = got[rank]
        for a, b in zip(m, metrics):
            assert a["lr"] == b["lr"]
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
        assert _rel([x - y for x, y in zip(masters, before)], want) <= DP_REL
        _same(masters, got[0][0])                  # the masters stay replicated


@pytest.mark.parametrize("scope_kw", [dict(), dict(train_mode="full", use_ema=True)],
                         ids=["temporal", "full-ema"])
def test_zero1_under_frames_is_exact(two, scope_kw):
    """(c): over a frames axis of 2, ZeRO-1 partitions over both ranks."""
    got = two("zero1", 2, scope_kw)
    assert sorted(got[0][2] + got[1][2]) == list(range(len(got[0][0])))
    for rank in range(2):
        _same(got[rank][0], got[rank][1])
    _same(got[0][1], got[1][1])


def test_checkpoint_from_data_and_frames_resumes_on_one_rank(four, tmp_path):
    """(d): four ZeRO-1 ranks in (2, 2) save after 2 steps and go on to 3;
    one rank restores the file bit for bit and goes on as they did."""
    scope_kw = dict(train_mode="full", use_ema=True, zero1=True)
    out = str(tmp_path / "four")
    after = four("save", 2, scope_kw, out, 2)
    path = os.path.join(out, "checkpoint-2")
    sd = torch.load(os.path.join(path, "state", ckpt_lib.STATE_FILE), weights_only=True)
    assert sd["step"] == 2 and all(e is not None for e in sd["ema_params"].values())
    assert len(sd["optimizer"]["adamw"]["state"]) == len(sd["params"])

    one_kw = dict(train_mode="full", use_ema=True)
    models = _models()
    one = create_train_state(_cfg(one_kw), models)
    cast_frozen_to_compute(models, torch.float32)
    one, _, _ = ckpt_lib.CheckpointManager(out, 3).restore(path, one)
    write_back(models, _cfg(one_kw), one)
    _same([t for t in one.state_dict()["params"].values()], list(sd["params"].values()))
    _, one, _ = _run(one_kw, parallel.SINGLE, 1, one, models, start=2)
    start = list(sd["params"].values())
    assert _rel([a - b for a, b in zip(_masters(one), start)],
                [a - b for a, b in zip(after[0], start)]) <= DP_REL
    for rank in range(1, 4):
        _same(after[rank], after[0])


GEN_KW = dict(height=32, width=32, num_frames=F, num_inference_steps=2, decode_chunk_size=3)


def test_generate_over_frames_matches_jax(two, four, jax_pair):
    """(e): two images over frames 2 (each rank both rows) and (2, 2) (each
    rank one row) against JAX's (data 2, frames 2) mesh; chunks of 3 over 4
    frames, so a decode chunk crosses the frames shards."""
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.parallel.sharding import make_sharded_generate
    from test_torch_port_pipeline import _jax_noise

    jm, params, sds = jax_pair
    images = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    h8 = 32 // jcfg.TINY_VAE.downsample_factor
    noise = tuple(map(torch.from_numpy, _jax_noise(rng, images.shape, (2, F, h8, h8, 4))))
    args = (sds, torch.float32, torch.from_numpy(images), GEN_KW, False, noise)
    two.submit("generate", 2, *args)
    four.submit("generate", 2, *args)
    gen, place_params, place_images = make_sharded_generate(jm, _jax_mesh(2, 2))
    want = np.asarray(gen(place_params(params), place_images(jnp.asarray(images)), rng,
                          jcfg.PipelineConfig(**GEN_KW)))
    got2, got4 = two.collect("generate"), four.collect("generate")
    for rank in range(2):
        np.testing.assert_allclose(got2[rank].numpy(), want, atol=2e-3, rtol=2e-3)
    for rank in range(4):
        row = rank // 2
        np.testing.assert_allclose(got4[rank].numpy(), want[row:row + 1], atol=2e-3,
                                   rtol=2e-3)


MODES = {"exact": dict(), "n3k3": dict(num_inference_steps=6, deep_cache_interval=3,
                                       uncond_reuse_interval=3),
         "boxes": dict(), "int8": dict(unet_quant="int8", vae_quant="int8")}


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_over_data_and_frames_is_the_one_rank_video(four, mode):
    """(e): every mode over (2, 2) in float64, where the spatial layers'
    batch sizes do not round the video otherwise: each rank's row is its
    row of the one-rank video of the whole batch to rel-L2 1e-12 (a wrong
    frame offset, token split, decode chunk or int8 amax would be of order
    1). Under int8 every amax spans the data axis too (the global batch's,
    as GSPMD's in the JAX package)."""
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
    four.submit("generate", 2, None, torch.float64, images, cfg_kw, tracklet, noise, boxes)
    models = _models(None, torch.float64, tracklet)
    kw = dict(image_noise=noise[0], latent_noise=noise[1])
    if boxes is not None:
        kw.update(boxes=boxes[0], box_mask=boxes[1])
    whole = generate(models, images, PipelineConfig(**cfg_kw), **kw)
    got = four.collect("generate")
    for rank in range(4):
        assert got[rank].shape == (1, F, 32, 32, 3)
        row = rank // 2
        assert _rel([got[rank]], [whole[row:row + 1]]) <= 1e-12


def test_frames_four_over_an_uneven_token_split(four):
    """(f): 36x36 pixels give 18x18 and 9x9 latents: 81 tokens at the second
    level over four ranks. A video (float64) and two temporal-scope steps
    (f32) against one rank."""
    cfg_kw = {**GEN_KW, "height": 36, "width": 36, "decode_chunk_size": 4}
    images = torch.rand(1, 36, 36, 3, generator=torch.Generator().manual_seed(6)) * 2 - 1
    four.submit("generate", 4, None, torch.float64, images, cfg_kw)
    whole = parallel.generate_rows(_models(None, torch.float64), images.double(),
                                   PipelineConfig(**cfg_kw), parallel.SINGLE,
                                   generator=torch.Generator().manual_seed(2))
    got = four.collect("generate")
    shard = parallel.World(0, 4, frames=4).frame_shard(F)
    assert shard.token_splits(81) == [21, 20, 20, 20]
    for rank in range(4):
        assert _rel([got[rank]], [whole]) <= 1e-12

    four.submit("steps", 4, dict(), 2, 36)
    # the one-rank run sees both rows of the batch; the four ranks' world has
    # a data axis of one, so they take both rows too
    _, single, metrics = _run(dict(), parallel.SINGLE, 2, size=36)
    got = four.collect("steps")
    for rank in range(4):
        for a, b in zip(got[rank][1], metrics):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)


UNEVEN = [(4, 6), (2, 5)]


@pytest.mark.parametrize("frames,num_frames", UNEVEN, ids=["6-over-4", "5-over-2"])
def test_generate_over_an_uneven_frames_split(two, four, jax_pair, frames, num_frames):
    """(h): one image; decode chunks of 4 over the uneven shards."""
    import jax
    import jax.numpy as jnp

    from svd_xtend_tpu.core import config as jcfg
    from svd_xtend_tpu.parallel.sharding import make_sharded_generate
    from test_torch_port_pipeline import _jax_noise

    pool = four if frames == 4 else two
    cfg_kw = {**GEN_KW, "num_frames": num_frames, "decode_chunk_size": 4}
    g = torch.Generator().manual_seed(8)
    images = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    noise = (torch.randn(1, 32, 32, 3, generator=g).double(),
             torch.randn(1, num_frames, 16, 16, 4, generator=g).double())
    pool.submit("generate", frames, None, torch.float64, images, cfg_kw, False, noise)
    whole = generate(_models(None, torch.float64), images.double(), PipelineConfig(**cfg_kw),
                     image_noise=noise[0], latent_noise=noise[1])
    got = pool.collect("generate")
    for rank in range(frames):
        assert got[rank].shape == (1, num_frames, 32, 32, 3)
        assert _rel([got[rank]], [whole]) <= 1e-12

    jm, params, sds = jax_pair
    rng = jax.random.PRNGKey(4)
    jnoise = tuple(map(torch.from_numpy, _jax_noise(rng, images.shape,
                                                    (1, num_frames, 16, 16, 4))))
    pool.submit("generate", frames, sds, torch.float32, images, cfg_kw, False, jnoise)
    gen, place_params, place_images = make_sharded_generate(jm, _jax_mesh(1, frames))
    want = np.asarray(gen(place_params(params), place_images(jnp.asarray(images.numpy())), rng,
                          jcfg.PipelineConfig(**cfg_kw)))
    got = pool.collect("generate")
    for rank in range(frames):
        np.testing.assert_allclose(got[rank].numpy(), want, atol=2e-3, rtol=2e-3)


def test_an_uneven_train_batch_is_refused_in_both_packages():
    """(g): JAX's shard_batch cannot place 6 frames over a frames axis of
    4; the port's config and train step refuse that split too."""
    import jax

    from svd_xtend_tpu.parallel.sharding import shard_batch

    with pytest.raises(Exception):
        jax.block_until_ready(shard_batch(np.zeros((1, 6, 8, 8, 3), np.float32),
                                          _jax_mesh(1, 4)))
    with pytest.raises(ValueError, match="even split"):
        _cfg(dict(), 4, num_frames=6).check_ported()


@pytest.mark.parametrize("kw,ok", [
    (dict(mesh=MeshConfig(frames=2)), True),
    (dict(mesh=MeshConfig(data=2, frames=7), num_frames=14), True),
    (dict(mesh=MeshConfig(frames=2), num_frames=3), False),
    (dict(mesh=MeshConfig(frames=4), num_frames=14), False),
    (dict(mesh=MeshConfig(model=2)), True),
    (dict(mesh=MeshConfig(model=2, frames=2)), True)],
    ids=["frames2", "data2-frames7", "uneven3", "uneven14", "model2", "model2-frames2"])
def test_check_ported_takes_frames_and_refuses_the_rest(kw, ok):
    """(g): a 'model' axis is taken too, alone and beside frames."""
    cfg = TrainConfig(**kw)
    if ok:
        cfg.check_ported()
        return
    with pytest.raises(ValueError):
        cfg.check_ported()


def test_frame_shard_layout():
    """Data outer, frames inner (JAX's create_mesh): rank 5 of (2, 4) is
    frames index 1 of data row 1; its rows and frames; a frames axis that
    does not divide F splits them as evenly as they go, the first ranks one
    more; fewer frames than ranks raises."""
    world = parallel.World(5, 8, frames=4)
    assert (world.data, world.data_index, world.frames_index) == (2, 1, 1)
    shard = world.frame_shard(8)
    assert shard.ranks == (4, 5, 6, 7) and shard.frames == slice(2, 4)
    assert parallel.rows(3, world) == slice(3, 6)
    uneven = world.frame_shard(6)
    assert uneven.counts == [2, 2, 1, 1] and uneven.frames == slice(2, 4)
    assert parallel.World(7, 8, frames=4).frame_shard(14).frames == slice(11, 14)
    with pytest.raises(ValueError):
        world.frame_shard(3)
    with pytest.raises(ValueError):
        shard.token_splits(3)
    assert parallel.World(1, 2).frame_shard(8) is None
    with pytest.raises(ValueError):
        parallel.mesh_world(parallel.World(0, 4), MeshConfig(frames=3))
    with pytest.raises(ValueError):
        parallel.mesh_world(parallel.World(0, 4), MeshConfig(data=4, frames=2))


def test_local_draws_keep_rows_and_frames():
    """The per-frame draws keep this rank's frames of its rows, the per-sample
    draws its rows."""
    from svd_xtend_tpu_torch.diffusion.training import sample_train_draws
    models = _models()
    draws = sample_train_draws(models, (4, F, 32, 32, 3), _cfg(dict()),
                               torch.Generator().manual_seed(0))
    world = parallel.World(3, 4, frames=2)                 # data row 1, frames 2-3
    mine = parallel.local_draws(draws, world, 2)
    lat = draws.latent_noise.reshape((4, F) + draws.latent_noise.shape[1:])
    assert torch.equal(mine.latent_noise, lat[2:4, 2:4].reshape((4,) + lat.shape[2:]))
    assert torch.equal(mine.noise, draws.noise[2:4, 2:4])
    for name in ("cond_sigma", "cond_pixel_noise", "cond_latent_noise", "dropout_u", "sigma",
                 "box_dropout_u"):
        assert torch.equal(getattr(mine, name), getattr(draws, name)[2:4])
