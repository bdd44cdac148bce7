"""The port's spans (utils/profiling.py) on a TINY temporal train step, on
the CPU: nothing kept with recording off, the step's results bit for bit
the same with it on, the tree of spans one step records, and each span
inside its own profiler range on the profiler's clock."""

from __future__ import annotations

import contextlib
import copy
from collections import Counter

import pytest
import torch

from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.train import state as tstate
from svd_xtend_tpu_torch.utils import profiling as tp

STAGES = ["train.encode", "train.unet_loss", "train.backward", "train.optimizer"]
CLOCK_SLACK_NS = 50_000


@pytest.fixture(scope="module")
def base_models():
    g = torch.Generator().manual_seed(0)
    return tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                  device="cpu", generator=g)


def _config(max_grad_norm=1.0):
    return tcfg.TrainConfig(train_mode="temporal", learning_rate=1e-3, lr_warmup_steps=0,
                            height=32, width=32, num_frames=2, remat_policy="block",
                            max_grad_norm=max_grad_norm)


def _steps(base_models, cfg, n, record):
    """`n` steps from a fresh copy of the TINY networks; (metrics, masters,
    recording or None)."""
    models = copy.deepcopy(base_models)
    state = tstate.create_train_state(cfg, models)
    step = tstate.make_train_step(models, cfg)
    g = torch.Generator().manual_seed(1)
    batch = torch.rand(1, 2, 32, 32, 3, generator=g) * 2 - 1
    metrics = []
    with tp.recording() if record else contextlib.nullcontext() as rec:
        for _ in range(n):
            state, m = step(state, batch, generator=g)
            metrics.append(m)
    return metrics, [p.detach().clone() for p in state.params], rec


def test_recording_off_keeps_nothing(base_models):
    assert tp._RECORDING is None
    assert not isinstance(tp.span("x"), tp._Recorded)
    _steps(base_models, _config(), 1, record=False)
    with tp.recording() as rec:
        assert isinstance(tp.span("x"), tp._Recorded)
        with pytest.raises(RuntimeError):
            with tp.recording():
                pass
    assert rec.spans == [] and rec.steps == 0 and tp._RECORDING is None
    assert tp.read("sync.loss", torch.tensor([2.5])) == 2.5
    with tp.span("x"):
        pass
    assert rec.spans == []


def test_recording_changes_no_result(base_models):
    cfg = _config()
    off, masters_off, _ = _steps(base_models, cfg, 2, record=False)
    on, masters_on, rec = _steps(base_models, cfg, 2, record=True)
    assert rec.spans
    for a, b in zip(off, on):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert all(torch.equal(a, b) for a, b in zip(masters_off, masters_on))


@pytest.mark.parametrize("max_grad_norm, syncs", [
    (1.0, {"sync.clip": "train.optimizer", "sync.loss": "train.step",
           "sync.grad_norm": "train.step"}),
    (0.0, {"sync.loss": "train.step", "sync.grad_norm": "train.step"}),
])
def test_one_step_records_its_tree(base_models, max_grad_norm, syncs):
    _, _, rec = _steps(base_models, _config(max_grad_norm), 2, record=True)
    spans = rec.spans
    assert rec.steps == 2
    assert all(s.end_ns >= s.start_ns >= 0 for s in spans)
    roots = [i for i, s in enumerate(spans) if s.name == tp.STEP]
    assert [spans[i].step for i in roots] == [0, 1]
    for k, root in enumerate(roots):
        assert spans[root].parent == -1
        mine = [s for s in spans if s.step == k]
        children = [s.name for s in mine if s.parent == root]
        assert children == STAGES + ["sync.loss", "sync.grad_norm"]
        names = Counter(s.name for s in mine)
        assert names[tp.STEP] == 1 and all(names[n] == 1 for n in STAGES)
        sync = {s.name: spans[s.parent].name for s in mine if s.name.startswith("sync.")}
        assert sync == syncs
        assert names["unet.checkpointed_block"] > 0
        for s in mine:
            if s.parent >= 0:
                p = spans[s.parent]
                assert p.thread == s.thread and p.step == k
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_spans_lie_inside_their_profiler_ranges(base_models):
    """Under a CPU torch.profiler, the n-th recorded span of a name lies in the
    n-th range of that name, on the profiler's clock, within CLOCK_SLACK_NS."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, rec = _steps(base_models, _config(), 2, record=True)
    names = {s.name for s in rec.spans}
    ranges = {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.name() in names:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    seen = Counter()
    for s in rec.spans:
        a, b = rec.on_profiler_clock(s)
        r0, r1 = ranges[s.name][seen[s.name]]
        seen[s.name] += 1
        assert r0 - CLOCK_SLACK_NS <= a and b <= r1 + CLOCK_SLACK_NS, (s.name, r0 - a, b - r1)
    assert seen == Counter({n: len(r) for n, r in ranges.items()})
