"""The port's data parallelism, ZeRO-1 and host offload (``parallel/``,
``train/optim.py``, ``train/state.py``, ``train/checkpoint.py``) on the CPU:
two gloo ranks, spawned once for the module, run the jobs the tests send
them; each test waits for its answer under its own time limit.

  - a two-rank TINY step (each rank its row of a global batch of two) equals
    the one-rank step over the whole batch: the loss and the gradient norm
    within 1e-5 relative, the masters' change within rel-L2 ``DP_REL`` (the
    gradient is averaged over the ranks, so it is summed in another order);
  - ZeRO-1 equals no ZeRO-1 bit for bit, with f32 and with 8-bit moments,
    and each rank holds the moments (and the EMA) of its own tensors only;
  - host offload (one rank; here the compute device is the CPU, so what it
    places is checked by kind, the pinning on the card in
    test_torch_port_cuda.py) steps to the same masters, moments and EMA bit
    for bit, in several chunks;
  - a checkpoint saved by two ZeRO-1 ranks holds the whole state, restores
    bit for bit into one rank and from one rank into two, and the runs go
    on as a straight run does;
  - ``generate_rows`` gives each rank its rows of the one-rank video.

No JAX here: the JAX package's ``test_dp_matches_single_device`` and
``test_zero1_*`` state the same properties of its GSPMD layout.
"""

import dataclasses
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from svd_xtend_tpu_torch import parallel
from svd_xtend_tpu_torch.core.config import (TINY_CLIP, TINY_UNET, TINY_VAE, PipelineConfig,
                                             TrainConfig)
from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
from svd_xtend_tpu_torch.train import checkpoint as ckpt_lib
from svd_xtend_tpu_torch.train.optim import ClippedAdamW
from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                             make_train_step)

torch.set_num_threads(1)

RANKS = 2
# the masters' change of a two-rank step against the one-rank step: the
# gradients agree to f32 rounding, but Adam's first updates are about
# lr·sign(g), and a gradient near zero can come out of the other summation
# order with the other sign (1.3e-3 measured in the TINY full scope)
DP_REL = 5e-3
JOB_SECONDS = 240
POLL_SECONDS = 1.0          # how often a wait for answers checks that the ranks live


# ------------------------------------------------------------ the jobs --

def _models(scope_kw):
    cfg = TrainConfig(**{**dict(train_mode="temporal", learning_rate=1e-3, height=32,
                                width=32, num_frames=3, lr_warmup_steps=0), **scope_kw})
    models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    return models, cfg


def _batch(step):
    g = torch.Generator().manual_seed(100 + step)
    return torch.rand(RANKS, 3, 32, 32, 3, generator=g) * 2 - 1


def _run(scope_kw, world, steps, state=None, models=None, start=0):
    """(models, state, metrics) after `steps` steps of this rank's rows."""
    if models is None:
        models, cfg = _models(scope_kw)
        state = create_train_state(cfg, models, world=world)
        cast_frozen_to_compute(models, torch.float32)
    else:
        cfg = _models(scope_kw)[1]
    step_fn = make_train_step(models, cfg, world)
    metrics = []
    for s in range(start, start + steps):
        batch = _batch(s)[parallel.rows(RANKS // world.size, world)]
        state, m = step_fn(state, batch, generator=torch.Generator().manual_seed(s))
        metrics.append(m)
    return models, state, metrics


def _masters(state):
    return [p.detach().clone() for p in state.params]


def job_dp_step(world, scope_kw):
    _, state, metrics = _run(scope_kw, world, 2)
    return _masters(state), metrics


def job_zero1(world, scope_kw):
    """The masters after 2 steps with and without ZeRO-1, and what each rank
    holds under it."""
    _, plain, _ = _run(scope_kw, world, 2)
    _, zero, _ = _run({**scope_kw, "zero1": True}, world, 2)
    opt = zero.optimizer
    held = (len(opt.adamw8.params) if opt.adamw8 is not None else len(opt.adamw.state))
    ema = (None if zero.ema_params is None
           else [i for i, e in enumerate(zero.ema_params) if e is not None])
    return (_masters(plain), _masters(zero), opt.local, held, ema,
            plain.optimizer.moment_bytes(), opt.moment_bytes())


def job_save(world, scope_kw, out, steps):
    """`steps` steps, a save by every rank (rank 0 writes), one step more;
    the masters then."""
    models, state, _ = _run(scope_kw, world, steps)
    cfg = _models(scope_kw)[1]
    manager = ckpt_lib.CheckpointManager(out, 3, world=world)
    manager.save(steps, state, cfg, {"step": steps}, blocking=True)
    manager.wait()
    _, state, _ = _run(scope_kw, world, 1, state, models, start=steps)
    return _masters(state)


def job_resume(world, scope_kw, path, steps):
    """Restore `path` on every rank, gather the state back, one step more."""
    models, cfg = _models(scope_kw)
    state = create_train_state(cfg, models, world=world)
    cast_frozen_to_compute(models, torch.float32)
    manager = ckpt_lib.CheckpointManager(os.path.dirname(path), 3, world=world)
    state, _, _ = manager.restore(path, state)
    from svd_xtend_tpu_torch.train.state import write_back
    write_back(models, cfg, state)
    sd = state.state_dict()
    _, state, _ = _run(scope_kw, world, 1, state, models, start=steps)
    return sd, _masters(state)


def job_generate(world):
    models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    images = torch.rand(RANKS, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    cfg = PipelineConfig(height=32, width=32, num_frames=2, num_inference_steps=2,
                         decode_chunk_size=2)
    return parallel.generate_rows(models, images, cfg, world,
                                  generator=torch.Generator().manual_seed(2))


def job_cli(world, argv):
    from svd_xtend_tpu_torch.train import cli
    stats = cli.main(argv)
    return stats["world_size"], stats["export_seconds"], len(stats["step_seconds"])


JOBS = {"dp_step": job_dp_step, "zero1": job_zero1, "save": job_save, "resume": job_resume,
        "generate": job_generate, "cli": job_cli}


def start_group(rank, size, store):
    """Join the ranks' gloo group, which meets on the file `store` (a
    FileStore: no other pool can take it, as one could take a TCP port
    found free and released before the ranks bind it); the world."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size)
    return parallel.init_world("cpu")


def rendezvous():
    """(a directory of its own, the FileStore file in it) for one pool."""
    d = tempfile.mkdtemp(prefix="gloo_ranks_")
    return d, os.path.join(d, "store")


def answers(results, procs, name):
    """Every rank's answer to job `name`, by rank: fails at once where a
    rank's process has died, and after JOB_SECONDS without an answer."""
    out = {}
    deadline = time.monotonic() + JOB_SECONDS
    while len(out) < len(procs):
        try:
            rank, got, ok, value = results.get(timeout=POLL_SECONDS)
        except queue.Empty:
            dead = {r: p.exitcode for r, p in enumerate(procs) if not p.is_alive()}
            if dead:
                pytest.fail(f"job {name}: rank process(es) ended without an answer, exit "
                            f"codes {dead}")
            if time.monotonic() > deadline:
                pytest.fail(f"job {name}: no answer within {JOB_SECONDS} s")
            continue
        assert got == name
        if not ok:
            pytest.fail(f"job {name} on rank {rank}:\n{value}")
        out[rank] = value
    return out


def _worker(rank, store, jobs, results):
    world = start_group(rank, RANKS, store)
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, name, True, JOBS[name](world, *args)))
            except BaseException:
                results.put((rank, name, False, traceback.format_exc()))
    finally:
        parallel.close_world(world)


# -------------------------------------------------------------- the pool --

@pytest.fixture(scope="module")
def ranks():
    """Two gloo ranks; `ranks(name, *args)` runs a job on both and returns
    their answers by rank, within JOB_SECONDS."""
    ctx = mp.get_context("spawn")
    tmp, store = rendezvous()
    jobs = [ctx.Queue() for _ in range(RANKS)]
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, store, jobs[r], results), daemon=True)
             for r in range(RANKS)]
    for p in procs:
        p.start()

    def run(name, *args):
        for q in jobs:
            q.put((name, args))
        return answers(results, procs, name)

    yield run
    for q in jobs:
        q.put(None)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    shutil.rmtree(tmp, ignore_errors=True)


def test_answers_fail_at_once_when_a_rank_has_died():
    """A rank whose process ended (here at once, exit code 3) fails the job
    within a few polls, not after JOB_SECONDS."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=sys.exit, args=(3,), daemon=True)
    proc.start()
    proc.join(timeout=60)
    assert not proc.is_alive()
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"exit codes \{0: 3\}"):
        answers(results, [proc], "job")
    assert time.monotonic() - t0 < 10 * POLL_SECONDS


def _rel(a, b):
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------ the tests --

@pytest.mark.parametrize("scope_kw", [dict(), dict(train_mode="full", use_ema=True)],
                         ids=["temporal", "full-ema"])
def test_two_ranks_step_as_one_rank(ranks, scope_kw):
    got = ranks("dp_step", scope_kw)
    _, single, metrics = _run(scope_kw, parallel.SINGLE, 2)
    before = _masters(create_train_state(_models(scope_kw)[1], _models(scope_kw)[0]))
    for rank in range(RANKS):
        masters, m = got[rank]
        for a, b in zip(m, metrics):
            assert a["lr"] == b["lr"]
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
        change = [x - y for x, y in zip(masters, before)]
        want = [x - y for x, y in zip(_masters(single), before)]
        assert _rel(change, want) <= DP_REL
    _same(got[0][0], got[1][0])           # the masters stay replicated


@pytest.mark.parametrize("scope_kw", [dict(), dict(use_8bit_adam=True),
                                      dict(train_mode="full", use_ema=True)],
                         ids=["f32", "8bit", "full-ema"])
def test_zero1_is_exact_and_partitions_the_state(ranks, scope_kw):
    got = ranks("zero1", scope_kw)
    locals_ = [got[r][2] for r in range(RANKS)]
    n = len(got[0][0])
    assert sorted(locals_[0] + locals_[1]) == list(range(n))     # a partition
    assert locals_[0] and locals_[1]
    for r in range(RANKS):
        plain, zero, local, held, ema, plain_bytes, zero_bytes = got[r]
        _same(plain, zero)                                         # bit for bit
        assert held == len(local)                                  # its tensors' moments alone
        assert zero_bytes < plain_bytes
        if ema is not None:
            assert ema == local                                    # and their EMA
    _same(got[0][1], got[1][1])


@pytest.mark.parametrize("mode", ["masters", "masters+moments"])
@pytest.mark.parametrize("scope_kw", [dict(train_mode="full", use_ema=True),
                                      dict(use_8bit_adam=True), dict(train_mode="lora")],
                         ids=["full-ema", "8bit", "lora"])
def test_host_offload_is_exact(monkeypatch, mode, scope_kw):
    chunk = 2_000 if scope_kw.get("train_mode") == "lora" else 50_000
    monkeypatch.setattr(ClippedAdamW, "OFFLOAD_CHUNK_VALUES", chunk)   # several chunks
    _, plain, m_plain = _run(scope_kw, parallel.SINGLE, 2)
    _, off, m_off = _run({**scope_kw, "host_offload": mode}, parallel.SINGLE, 2)
    assert m_plain == m_off
    _same(_masters(plain), _masters(off))
    if off.lora is not None:
        # the adapter is the compute copy of the offloaded masters, which
        # are tensors of their own
        from svd_xtend_tpu_torch.io.convert import lora_state_dict
        adapter = list(lora_state_dict(off.lora).values())
        assert not any(a is p for a, p in zip(adapter, off.params))
        _same(adapter, _masters(off))
    sd_plain, sd_off = plain.state_dict(), off.state_dict()
    assert torch.equal(torch.tensor(sd_plain["step"]), torch.tensor(sd_off["step"]))
    flat = lambda o: [t for t in _leaves(o)]
    _same(flat(sd_plain["optimizer"]), flat(sd_off["optimizer"]))
    if plain.ema_params is not None:
        _same(plain.ema_params, off.ema_params)
    opt = off.optimizer
    assert len(list(opt._chunks())) > 1
    assert all(p.device.type == "cpu" for p in off.params)
    moments = [t for i in opt.local for t in opt._moments(i)]
    assert moments and all(t.device.type == "cpu" for t in moments)
    values = sum(p.numel() for p in off.params)
    # each master in and out as f32; with the moments, theirs too
    moment_bytes = opt.moment_bytes() if mode == "masters+moments" else 0
    assert opt.streamed_bytes == 2 * (4 * values + moment_bytes)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)


def test_checkpoints_resume_across_world_sizes(ranks, tmp_path):
    """Two ZeRO-1 ranks save after 2 steps and go on to 3; the file holds
    the whole state, which one rank restores bit for bit and goes on from as
    the two did (to DP_REL); two ZeRO-1 ranks restore a one-rank file."""
    scope_kw = dict(train_mode="full", use_ema=True, zero1=True)
    out = str(tmp_path / "two")
    after = ranks("save", scope_kw, out, 2)
    path = os.path.join(out, "checkpoint-2")
    sd = torch.load(os.path.join(path, "state", ckpt_lib.STATE_FILE), weights_only=True)
    assert sd["step"] == 2 and all(e is not None for e in sd["ema_params"].values())
    n = len(sd["params"])
    assert len(sd["optimizer"]["adamw"]["state"]) == n          # every tensor's moments

    models, cfg = _models(scope_kw)
    one = create_train_state(dataclasses.replace(cfg, zero1=False), models)
    cast_frozen_to_compute(models, torch.float32)
    manager = ckpt_lib.CheckpointManager(out, 3)
    one, _, _ = manager.restore(path, one)
    from svd_xtend_tpu_torch.train.state import write_back
    write_back(models, cfg, one)
    again = one.state_dict()
    _same(list(_leaves(again)), list(_leaves(sd)))               # bit for bit
    _, one, _ = _run(dict(train_mode="full", use_ema=True), parallel.SINGLE, 1, one, models,
                     start=2)
    assert _rel([a - b for a, b in zip(_masters(one), sd["params"].values())],
                [a - b for a, b in zip(after[0], sd["params"].values())]) <= DP_REL

    # from one rank to two
    out1 = str(tmp_path / "one")
    models, cfg = _models(dict(train_mode="full", use_ema=True))
    st = create_train_state(cfg, models)
    cast_frozen_to_compute(models, torch.float32)
    _, st, _ = _run(dict(train_mode="full", use_ema=True), parallel.SINGLE, 2, st, models)
    ckpt_lib.CheckpointManager(out1, 3).save(2, st, cfg, {"step": 2}, blocking=True)
    got = ranks("resume", scope_kw, os.path.join(out1, "checkpoint-2"), 2)
    _same(list(_leaves(got[0][0])), list(_leaves(st.state_dict())))
    assert got[1][0] is None                                      # gathered to rank 0
    _same(got[0][1], got[1][1])


def test_generate_rows_are_the_one_rank_rows(ranks):
    got = ranks("generate")
    models = SVDModels.create(TINY_UNET, TINY_VAE, TINY_CLIP, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    images = torch.rand(RANKS, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    cfg = PipelineConfig(height=32, width=32, num_frames=2, num_inference_steps=2,
                         decode_chunk_size=2)
    whole = parallel.generate_rows(models, images, cfg, parallel.SINGLE,
                                   generator=torch.Generator().manual_seed(2))
    # a batch of one and of two take other CPU matrix-product blockings,
    # which two 700-sigma Euler steps carry into the video: 4.5e-5 measured
    # in a video in [-1, 1]
    for r in range(RANKS):
        assert got[r].shape == (1,) + whole.shape[1:]
        torch.testing.assert_close(got[r], whole[r:r + 1], rtol=0, atol=2e-4)


def test_owners_balance_whole_tensors():
    world = parallel.World(0, 3)
    sizes = [10, 7, 7, 3, 3, 1, 100]
    owner = parallel.owners(sizes, world)
    assert owner == parallel.owners(sizes, parallel.World(2, 3))   # the same on every rank
    load = [sum(s for s, o in zip(sizes, owner) if o == r) for r in range(3)]
    assert owner[6] == 0 and sorted(load) == [15, 16, 100]


FRAMES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "svd_xtend_tpu_torch", "data", "fixtures", "frames")


def _cli_argv(out, steps, *extra):
    return ["--base_folder", FRAMES, "--tiny_model", "--device", "cpu", "--width", "32",
            "--height", "32", "--num_frames", "3", "--train_mode", "full", "--use_ema",
            "--mixed_precision", "no", "--remat", "none", "--learning_rate", "1e-3",
            "--lr_warmup_steps", "0", "--output_dir", out, "--checkpointing_steps", "2",
            "--validation_steps", "100", "--num_inference_steps", "2", "--num_workers", "1",
            "--seed", "7", "--max_train_steps", str(steps), *extra]


def test_cli_over_two_ranks_resumes_on_one(ranks, tmp_path):
    """train.cli under two gloo ranks (as torchrun starts them) with ZeRO-1:
    rank 0 alone validates, writes the checkpoints and the export; the
    checkpoint, resumed by one rank, holds what the two had (its
    train_state.pt gathered whole) and the one-rank run goes on to the end."""
    from svd_xtend_tpu_torch.train import cli
    two = str(tmp_path / "two")
    got = ranks("cli", _cli_argv(two, 2, "--zero1", "--mesh_data", "2"))
    assert got[0][0] == got[1][0] == 2 and got[0][2] == got[1][2] == 2
    assert got[0][1] is not None and got[1][1] is None          # rank 0 exported
    names = sorted(os.listdir(two))
    assert "checkpoint-2" in names and "unet" in names and "logs" in names
    sd = torch.load(os.path.join(two, "checkpoint-2", "state", ckpt_lib.STATE_FILE),
                    weights_only=True)
    n = len(sd["params"])
    assert len(sd["optimizer"]["adamw"]["state"]) == n and len(sd["ema_params"]) == n
    one = str(tmp_path / "one")
    os.makedirs(one)
    import shutil
    shutil.copytree(os.path.join(two, "checkpoint-2"), os.path.join(one, "checkpoint-2"))
    stats = cli.main(_cli_argv(one, 3, "--resume_from_checkpoint", "latest"))
    assert stats["world_size"] == 1 and len(stats["step_seconds"]) == 1
    assert os.path.isdir(os.path.join(one, "unet"))
