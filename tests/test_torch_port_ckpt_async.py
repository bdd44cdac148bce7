"""The asynchronous CheckpointManager (train/checkpoint.py) on the CPU: the
JAX package's contract (svd_xtend_tpu/train/checkpoint.py:64-98): ``save``
returns while its writer still runs, a second ``save`` fences the first,
``blocking=True`` and ``wait()`` make the checkpoint complete, a writer's
error is raised again by the next ``save`` or ``wait``, an interrupted
write leaves no ``state/`` directory, and a resume after ``wait()`` is bit
for bit. The card's pinned, side-stream snapshot is held by
tests/test_torch_port_cuda.py and chip_smoke.py's cli phase."""

import os
import threading

import pytest
import torch

from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.train import checkpoint as tckpt
from svd_xtend_tpu_torch.train import cli as tcli
from svd_xtend_tpu_torch.train import state as tstate

torch.set_num_threads(1)

# how long a test waits for a writer thread before it fails
TIMEOUT = 30.0


class _State:
    """Stands in for a TrainState: a step and one tensor."""

    def __init__(self, step):
        self.step = step
        self.w = torch.full((4,), float(step))

    def state_dict(self, copy=None):
        return {"step": self.step, "w": self.w.clone() if copy is None else copy(self.w)}

    def load_state_dict(self, sd):
        self.step, self.w = sd["step"], sd["w"]


@pytest.fixture
def gate(monkeypatch):
    """The writer's torch.save waits until the test opens the gate."""
    opened, entered = threading.Event(), threading.Event()
    write = tckpt._write_state

    def gated(sd, path):
        entered.set()
        if not opened.wait(TIMEOUT):
            raise TimeoutError("the test never opened the gate")
        write(sd, path)

    monkeypatch.setattr(tckpt, "_write_state", gated)
    return opened, entered


def _complete(out, step):
    return os.path.isdir(os.path.join(out, f"checkpoint-{step}", "state"))


def test_save_returns_before_the_writer_finishes(tmp_path, gate):
    opened, entered = gate
    out = str(tmp_path)
    m = tckpt.CheckpointManager(out)
    m.save(1, _State(1), tcfg.TrainConfig(output_dir=out), {"step": 1})
    assert entered.wait(TIMEOUT)
    assert not _complete(out, 1) and tckpt.latest_checkpoint(out) is None
    opened.set()
    m.wait()
    assert _complete(out, 1) and tckpt.latest_checkpoint(out).endswith("checkpoint-1")
    rec = m.saves[-1]
    assert rec["step"] == 1 and rec["bytes"] > 0 and rec["snapshot_bytes"] == 16
    assert rec["hold_seconds"] >= rec["copy_seconds"] >= 0 and rec["write_seconds"] >= 0


def test_a_second_save_fences_the_first(tmp_path, gate):
    opened, entered = gate
    out = str(tmp_path)
    cfg = tcfg.TrainConfig(output_dir=out)
    m = tckpt.CheckpointManager(out, total_limit=5)
    m.save(1, _State(1), cfg)
    assert entered.wait(TIMEOUT)
    second = threading.Thread(target=m.save, args=(2, _State(2), cfg))
    second.start()
    second.join(0.3)
    assert second.is_alive() and not _complete(out, 1)   # held at the fence
    opened.set()
    second.join(TIMEOUT)
    assert not second.is_alive() and _complete(out, 1)
    m.wait()
    assert _complete(out, 2)


def test_blocking_save_and_wait_complete_the_checkpoint(tmp_path):
    out = str(tmp_path)
    cfg = tcfg.TrainConfig(output_dir=out)
    m = tckpt.CheckpointManager(out, total_limit=1)
    path = m.save(3, _State(3), cfg, {"step": 3}, blocking=True)
    assert _complete(out, 3)
    assert sorted(os.listdir(path)) == ["config.json", "data_state.json", "state"]
    m.save(5, _State(5), cfg)
    m.wait()
    # the limit counts complete checkpoints: 3 went once 5 landed
    assert tckpt._ckpt_steps(out) == [5]
    st, got_cfg, data = m.restore("latest", _State(0))
    assert st.step == 5 and torch.equal(st.w, torch.full((4,), 5.0)) and got_cfg == cfg
    # the same step again is skipped, the file untouched
    f = os.path.join(out, "checkpoint-5", "state", tckpt.STATE_FILE)
    before = os.stat(f).st_mtime_ns
    m.save(5, _State(99), cfg)
    m.wait()
    assert os.stat(f).st_mtime_ns == before


@pytest.mark.parametrize("fence", ["save", "wait"])
def test_a_writer_error_is_raised_at_the_next_fence(tmp_path, monkeypatch, fence):
    """An interrupted write leaves no state/ (only state.tmp/), so neither
    'latest' nor the rotation counts it; its error is raised by the next
    save or wait, once."""
    out = str(tmp_path)
    cfg = tcfg.TrainConfig(output_dir=out)
    m = tckpt.CheckpointManager(out)

    def broken(sd, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write_state", broken)
    m.save(1, _State(1), cfg)
    with pytest.raises(RuntimeError, match="checkpoint write failed") as err:
        if fence == "save":
            m.save(2, _State(2), cfg)
        else:
            m.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert not _complete(out, 1) and os.path.isdir(os.path.join(out, "checkpoint-1", "state.tmp"))
    assert tckpt.latest_checkpoint(out) is None
    monkeypatch.undo()
    m.save(2, _State(2), cfg)     # the error was raised once; the manager goes on
    m.wait()
    assert tckpt.latest_checkpoint(out).endswith("checkpoint-2")


def test_resume_after_wait_is_bit_equal(tmp_path):
    """A TINY temporal-scope state after a step, saved asynchronously, its
    live tensors then changed by a second step before the writer is
    awaited: the file holds the first step's state, and a fresh state
    restored from it equals that state bit for bit."""
    cfg = tcfg.TrainConfig(train_mode="temporal", learning_rate=1e-3, lr_warmup_steps=0,
                           height=32, width=32, num_frames=2, mixed_precision="no",
                           remat_policy="none", output_dir=str(tmp_path))
    batch = torch.rand(1, 2, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1

    def build():
        g = torch.Generator().manual_seed(0)
        models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                        device="cpu", generator=g)
        return tstate.create_train_state(cfg, models), tstate.make_train_step(models, cfg)

    state, step = build()
    state, _ = step(state, batch, generator=tcli.step_generator(0, 0, "cpu"))
    want = state.state_dict()
    m = tckpt.CheckpointManager(cfg.output_dir)
    m.save(1, state, cfg, {"step": 1})
    state, _ = step(state, batch, generator=tcli.step_generator(0, 1, "cpu"))
    m.wait()
    fresh, _ = build()
    fresh, _, data = m.restore("latest", fresh)
    got = fresh.state_dict()
    assert data == {"step": 1} and got["step"] == want["step"] == 1
    pairs = list(zip(_tensors(got), _tensors(want)))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
