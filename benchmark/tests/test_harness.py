"""The harness on the CPU at TINY sizes: the last line's schema, a cell
added by data alone, the faults the check has to catch, the trace's
reduction, and the command's refusals."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests.tiny import REPO, tiny_data

SEED = 98765432109876


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tiny_data(tmp_path_factory.mktemp("bench"))


def _run(data, cell, trace=False, seconds=0.3):
    spec, d = data
    return harness.run_cell(spec, cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                            data_dir=d)


@pytest.mark.parametrize("cell", ["tiny-gen", "tiny-train"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(data, cell, trace):
    line = _run(data, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    spec = data[0]
    group = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in harness.cell_metrics(spec, cell, group)}
    assert set(line["metrics"]) <= set(allowed)
    if not trace:
        assert set(line["metrics"]) == set(allowed)
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name] and isinstance(m["value"], float)
    limits = json.loads((data[1] / "limits" / f"{cell}.json").read_text())
    assert set(line["checks"]) == set(limits)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_added_by_data_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new file,
    with their entries in BENCHMARK.json: no file that is there is edited."""
    spec, d = tiny_data(tmp_path)
    cfg = json.loads((d / "configs" / "tiny.json").read_text())
    cfg["unet"]["num_attention_heads"] = [1, 2]
    (d / "configs" / "tiny-narrow.json").write_text(json.dumps(cfg))
    traffic = json.loads((d / "traffic" / "tiny-gen.json").read_text())
    traffic["pipeline"].update(num_frames=2, min_guidance_scale=2.0)
    (d / "traffic" / "tiny-two-frames.json").write_text(json.dumps(traffic))
    (d / "metrics" / "videos_done.throwaway.py").write_text(
        "def read(rec):\n    return float(rec.units) if rec.kind == 'generate' else None\n")
    (d / "limits" / "tiny-added.json").write_text((d / "limits" / "tiny-gen.json").read_text())
    spec["configs"].append({"name": "tiny-narrow", "source": "TINY",
                            "file": "benchmark/configs/tiny-narrow.json", "reduced": [],
                            "why": "fewer heads"})
    spec["workloads"].append({"name": "tiny-added", "config": "tiny-narrow",
                              "traffic": "tiny-two-frames", "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "videos_done.throwaway", "unit": "videos",
                              "better": "higher", "source": "program_counter", "layer": "test",
                              "moves": "video_s", "workloads": ["tiny-added"]})
    for m in spec["end_to_end"]:
        if "tiny-gen" in m.get("workloads", []):
            m["workloads"].append("tiny-added")
    line = harness.run_cell(spec, "tiny-added", SEED, 0.2, True, "cpu", time.perf_counter(),
                            data_dir=d)
    assert line["metrics"]["videos_done.throwaway"]["value"] >= 1
    line = harness.run_cell(spec, "tiny-added", SEED, 0.2, False, "cpu", time.perf_counter(),
                            data_dir=d)
    assert set(line["metrics"]) == {"video_s", "peak_mem_gib", "setup_s"}


def test_unchanged_state_fails(data, monkeypatch):
    """A step that returns its state unchanged is caught."""
    from svd_xtend_tpu_torch.train import state as port_state
    real = port_state.make_train_step

    def lazy(models, cfg, *a, **kw):
        step = real(models, cfg, *a, **kw)

        def frozen(state, batch, **kw2):
            return state, {"loss": 0.5, "grad_norm": 0.0, "lr": 0.0}
        return frozen

    monkeypatch.setattr(port_state, "make_train_step", lazy)
    line = _run(data, "tiny-train")
    assert line["correct"] is False
    assert line["checks"]["update_gap"]["value"] > line["checks"]["update_gap"]["limit"]


def test_altered_loss_fails(data, monkeypatch):
    """A loss altered where it is produced is caught."""
    from svd_xtend_tpu_torch.diffusion import training as port_training
    real = port_training.edm_denoising_loss
    monkeypatch.setattr(port_training, "edm_denoising_loss",
                        lambda *a, **kw: real(*a, **kw) * 1.5)
    assert _run(data, "tiny-train")["correct"] is False


def test_altered_video_fails(data, monkeypatch):
    """A video altered where it is produced (one frame's pixels shifted in
    the decode) is caught."""
    from svd_xtend_tpu_torch.diffusion import pipeline as port_pipeline
    real = port_pipeline.decode_latents_chunked

    def altered(*a, **kw):
        video = real(*a, **kw)
        video[:, 0] = video[:, 0] + 0.25
        return video

    monkeypatch.setattr(port_pipeline, "decode_latents_chunked", altered)
    line = _run(data, "tiny-gen")
    assert line["correct"] is False
    assert line["checks"]["decode_rel_l2"]["value"] > line["checks"]["decode_rel_l2"]["limit"]


def test_altered_prediction_fails(data, monkeypatch):
    """A UNet prediction altered where it is produced (scaled by 1.1) is
    caught."""
    from svd_xtend_tpu_torch.models import unet as port_unet
    cls = port_unet.UNetSpatioTemporalConditionModel
    real = cls.forward
    monkeypatch.setattr(cls, "forward", lambda self, *a, **kw: real(self, *a, **kw) * 1.1)
    line = _run(data, "tiny-gen")
    assert line["correct"] is False
    assert line["checks"]["pass_rel_l2"]["value"] > line["checks"]["pass_rel_l2"]["limit"]


def test_skipped_denoising_step_fails(data, monkeypatch):
    """A sampler step that returns its state unchanged is caught."""
    from svd_xtend_tpu_torch.diffusion import scheduler as port_scheduler
    monkeypatch.setattr(port_scheduler.EulerDiscreteScheduler, "step",
                        staticmethod(lambda sample, denoised, sigma, sigma_next: sample.float()))
    line = _run(data, "tiny-gen")
    assert line["correct"] is False
    assert line["checks"]["sampler_rel_l2"]["value"] > line["checks"]["sampler_rel_l2"]["limit"]


def test_reduce_trace():
    """Busy time is the union of kernels and copies (device-side ranges of
    the labels are not work); idle gaps are named by the host's innermost
    operation under its innermost label."""
    ms = 1_000_000
    raw = [(0, 100 * ms, "bench.profiled", "user_annotation"),
           (0, 100 * ms, "bench.profiled", "gpu_user_annotation"),
           (1 * ms, 50 * ms, "unet.pass", "user_annotation"),
           (2 * ms, 3 * ms, "aten::mm", "cpu_op"),
           (60 * ms, 70 * ms, "aten::item", "cpu_op"),
           (5 * ms, 40 * ms, "gemm", "kernel"), (40 * ms + 5000, 60 * ms, "gemm", "kernel"),
           (75 * ms, 100 * ms, "copy", "gpu_memcpy")]
    out = spans.reduce_trace(raw, "bench.profiled")
    assert out["busy_s"] == pytest.approx(0.079995)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["device_ops"][0] == ["gemm", pytest.approx(0.054995)]
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(0.015)
    assert gaps["unet.pass > aten::mm"] == pytest.approx(0.005)
    assert spans.reduce_trace(raw[:5], "bench.profiled") == {}


def test_reduce_trace_device_only():
    """A trace of the device alone: the window runs from its first operation
    to its last, labelled device ranges are not work, and no gap is named."""
    ms = 1_000_000
    raw = [(0, 100 * ms, "train.optimizer", "gpu_user_annotation"),
           (10 * ms, 40 * ms, "gemm", "kernel"), (50 * ms, 60 * ms, "copy", "gpu_memcpy")]
    out = spans.reduce_trace(raw, "bench.profiled", host=False)
    assert out["window_s"] == pytest.approx(0.05)
    assert out["busy_s"] == pytest.approx(0.04)
    assert out["idle_gaps"] == []
    assert spans.reduce_trace(raw[:1], "bench.profiled", host=False) == {}


def _command(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "img2vid-320p-train",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    """Without a CUDA card the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without a card")
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and not re.search(r"^\{", out.stdout, re.M)
