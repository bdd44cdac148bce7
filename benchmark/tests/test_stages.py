"""The stage pass's reduction (benchmark/stages.py) on synthetic events: idle
time split where a span starts or ends, charged to the innermost train.*
stage of the step's thread, the parts adding up to the pass's idle time, the
host times by step, and the readings' None without a pass."""

from __future__ import annotations

import random

import pytest

from benchmark import stages
from benchmark.harness import Record

MS = 1_000_000
MAIN, AUTOGRAD = 1, 2


def _rows(spans):
    """(name, thread, parent name or None, step, start ms, end ms) -> rows, the
    parent by name among the spans listed before on the same thread."""
    rows = []
    for name, thread, parent, step, a, b in spans:
        i = -1
        if parent is not None:
            i = max(k for k, r in enumerate(rows) if r[0] == parent and r[1] == thread)
        rows.append((name, thread, i, step, a * MS, b * MS))
    return rows


def _kernels(*intervals):
    return [(a * MS, b * MS, "gemm", "kernel") for a, b in intervals]


def test_idle_across_a_span_boundary_is_split():
    rows = _rows([("train.step", MAIN, None, 0, 0, 100),
                  ("train.unet_loss", MAIN, "train.step", 0, 5, 20),
                  ("train.backward", MAIN, "train.step", 0, 20, 90)])
    out = stages.reduce_stages(_kernels((0, 10), (30, 40)), rows)
    assert out["idle_ms_by"] == {"train.unet_loss": pytest.approx(10),
                                 "train.backward": pytest.approx(10)}
    assert out["window_ms"] == pytest.approx(40) and out["busy_ms"] == pytest.approx(20)


def test_nested_spans_charge_the_innermost_stage():
    """sync.* spans are not stages (their train.optimizer is charged); time in
    train.step outside its stages is the step's own; other threads' spans
    and time outside every step charge nothing of theirs."""
    rows = _rows([("train.step", MAIN, None, 0, 0, 50),
                  ("train.backward", MAIN, "train.step", 0, 0, 30),
                  ("unet.checkpointed_block", AUTOGRAD, None, 0, 5, 25),
                  ("train.encode", AUTOGRAD, None, 0, 5, 25),
                  ("train.optimizer", MAIN, "train.step", 0, 30, 45),
                  ("sync.clip", MAIN, "train.optimizer", 0, 32, 44),
                  ("sync.loss", MAIN, "train.step", 0, 45, 48),
                  ("train.step", MAIN, None, 1, 60, 80)])
    out = stages.reduce_stages(_kernels((0, 10), (20, 35), (40, 46), (49, 65), (70, 80)), rows)
    assert out["idle_ms_by"] == {"train.backward": pytest.approx(10),
                                 "train.optimizer": pytest.approx(5),
                                 "train.step": pytest.approx(3 + 5)}
    assert out["steps"] == 2
    assert out["host_ms"][0]["sync.clip"] == pytest.approx(12)
    assert out["sync_ms"] == [pytest.approx(15), 0]
    assert out["opt_less_sync_ms"] == [pytest.approx(3), 0]


def test_between_steps_is_its_own_part():
    rows = _rows([("train.step", MAIN, None, 0, 0, 30), ("train.step", MAIN, None, 1, 50, 80)])
    out = stages.reduce_stages(_kernels((0, 20), (40, 60), (70, 90), (95, 99)), rows)
    assert out["idle_ms_by"] == {"train.step": pytest.approx(10 + 10),
                                 stages.BETWEEN: pytest.approx(10 + 5)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parts_add_up_to_the_idle_time(seed):
    """Random steps, stages and kernels: the charged parts and the rest sum
    to the window less the union of the device's work."""
    rnd = random.Random(seed)
    spans, t = [], 3.0
    for k in range(5):
        t0 = t
        inner = []
        for name in ("train.encode", "train.unet_loss", "train.backward", "train.optimizer"):
            d = rnd.uniform(1, 20)
            inner.append((name, MAIN, "train.step", k, t, t + d))
            t += d
        t += rnd.uniform(0, 5)
        spans += [("train.step", MAIN, None, k, t0, t)] + inner
        t += rnd.uniform(0, 5)
    kernels, c = [], 0.0
    while c < t + 10:
        d = rnd.uniform(0.01, 3)
        kernels.append((c, c + d))
        c += d + rnd.choice([0, 0, rnd.uniform(0, 4)])
    kernels += [(a + 0.5, b + 0.2) for a, b in kernels[::7]]       # overlaps
    out = stages.reduce_stages(_kernels(*kernels), _rows(spans))
    assert sum(out["idle_ms_by"].values()) == pytest.approx(out["idle_ms"], rel=1e-9)
    assert out["idle_ms"] == pytest.approx(out["window_ms"] - out["busy_ms"], rel=1e-9)
    assert out["idle_ms"] > 0 and out["steps"] == 5
    charged = {n for n in out["idle_ms_by"] if n != stages.BETWEEN}
    assert charged <= {"train.step", "train.encode", "train.unet_loss", "train.backward",
                       "train.optimizer"}


def test_no_device_work_or_no_step_reduces_to_nothing():
    rows = _rows([("train.step", MAIN, None, 0, 0, 10)])
    assert stages.reduce_stages([(0, MS, "train.step", "gpu_user_annotation")], rows) == {}
    assert stages.reduce_stages(_kernels((0, 1)), []) == {}


@pytest.mark.parametrize("metric", sorted(stages.READINGS))
def test_reading_without_the_pass_is_none(metric):
    assert stages.reading(metric, Record("train")) is None
    rec = Record("train")
    rec.stages = {}
    assert stages.reading(metric, rec) is None
    rows = _rows([("train.step", MAIN, None, 0, 0, 50),
                  ("train.encode", MAIN, "train.step", 0, 0, 10),
                  ("train.backward", MAIN, "train.step", 0, 10, 30),
                  ("train.optimizer", MAIN, "train.step", 0, 30, 45),
                  ("sync.clip", MAIN, "train.optimizer", 0, 32, 34)])
    rec.stages = stages.reduce_stages(_kernels((0, 5), (8, 12), (20, 31), (40, 50)), rows)
    value = stages.reading(metric, rec)
    assert isinstance(value, float) and value >= 0
    other = Record("generate")
    other.stages = rec.stages
    assert stages.reading(metric, other) is None



def test_device_side_span_ranges_are_no_work():
    """A span's range on the device, of whatever kind the trace gave it, is
    not busy time."""
    rows = _rows([("train.step", MAIN, None, 0, 0, 50),
                  ("sync.loss", MAIN, "train.step", 0, 40, 45)])
    raw = _kernels((1, 10), (30, 41)) + [
        (2 * MS, 41 * MS, "train.step", "gpu_user_annotation"),
        (41 * MS, 44 * MS, "sync.loss", "kernel")]
    out = stages.reduce_stages(raw, rows)
    assert out["window_ms"] == pytest.approx(40) and out["busy_ms"] == pytest.approx(20)
