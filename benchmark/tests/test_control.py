"""The correctness checks' controls, on the card at each cell's own size.

Each control has to come out as not correct: the float32 reference, or the
program's own lower-precision path, put in the program's place.
  - xt-576p-gen: the program's int8 W8A8 path (``unet_quant`` and
    ``vae_quant`` "int8"), the nearest precision below the configuration's
    bf16 that the program has; at the stages that path leaves exact (CLIP,
    the VAE encode, the f32 sampler), the reference in fp8 e4m3;
  - img2vid-320p-train: the reference computed with every matmul and conv
    operand in fp8 e4m3 (the program has no lower-precision train step);
    and the program with its loss scaled by 1.5 where it is produced, which
    the loss alone can catch at this size.

Run on the card (each seed builds the cell's networks; ≈ 1.5 min a seed for
the video, ≈ 30 s for the step; the nine tests take ≈ 6 min):

  python -m pytest benchmark/tests/test_control.py -m cuda

or, to print every candidate number of the program and of the control per
seed, as the limits were set from them:

  python -m benchmark.tests.test_control gen|train|train-fault SEED [SEED ...]
"""

from __future__ import annotations

import json
import random
import sys

import pytest
import torch

from benchmark import harness, program, weights
from benchmark.kinds import generate as gen_kind
from benchmark.kinds import train as train_kind
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import svd
from benchmark.tests.tiny import full_spec

SEEDS = (3001002003004, 4002003004005, 5003004005006)
GEN, TRAIN = "xt-576p-gen", "img2vid-320p-train"


def _cell(name: str):
    cell = next(c for c in full_spec()["workloads"] if c["name"] == name)
    cfg = harness.load_json(harness.DATA_DIR / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.DATA_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = harness.load_json(harness.DATA_DIR / "limits" / f"{name}.json")
    return cfg, traffic, limits


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def gen_readings(seed: int, device="cuda") -> dict:
    """The check's numbers (``kinds/generate.py::check``) for one video of the
    program in bf16 and of its int8 path, and what the float32 reference in
    fp8 reads at the stages the int8 path leaves in bf16 or f32: the start
    (CLIP, the VAE encode), the sampler (``sampler_gaps(fp8=True)``) and, beside
    the int8 decode, the decode."""
    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.diffusion import pipeline as port_pipeline

    cfg, traffic, _ = _cell(GEN)
    pipe = dict(traffic["pipeline"])
    models = program.build_models(cfg, device, getattr(torch, cfg["dtype"]), seed)
    req = gen_kind.requests(seed, pipe, cfg, 1, device)[0]
    cap = gen_kind.Capture(models)
    videos, kept = {}, []
    try:
        for mode, extra in (("program", {}), ("control", {"unet_quant": "int8",
                                                          "vae_quant": "int8"})):
            kept.append(cap.start())
            videos[mode] = port_pipeline.generate(
                models, req["image"], PipelineConfig(**pipe, **extra),
                image_noise=req["image_noise"], latent_noise=req["latent_noise"])
            cap.stop()
    finally:
        cap.remove()
    del models
    torch.cuda.empty_cache()
    nets = gen_kind.reference_nets(cfg, seed, device)
    low = gen_kind.reference_nets(cfg, seed, device, fp8=True)
    out = {}
    with svd.f32_context(), torch.no_grad():
        for (mode, video), held in zip(videos.items(), kept):
            out[mode] = gen_kind.check(nets, cfg, pipe, req, held, video,
                                       random.Random(seed))
        prog = kept[0]
        aug = pipe["noise_aug_strength"]
        noisy = req["image"] + aug * req["image_noise"]
        clip = lambda n: ref_pipeline.clip_embeds(n, cfg, req["image"])
        out["fp8_reference"] = {
            "start_rel_l2": max(_rel(clip(low), clip(nets)),
                                _rel(low["vae"].encode(noisy)[0], nets["vae"].encode(noisy)[0])),
            "sampler_rel_l2": max(gen_kind.sampler_gaps(cfg, pipe, prog["passes"],
                                                        req["latent_noise"], prog["latents"],
                                                        fp8=True)),
            "decode_rel_l2": _rel(ref_pipeline.decode(low, cfg, pipe, prog["latents"].float()),
                                  ref_pipeline.decode(nets, cfg, pipe, prog["latents"].float()))}
    return out


def train_readings(seed: int, device="cuda", fault: bool = False) -> dict:
    """The check's numbers for the program's first steps and for the fp8
    reference's, each against the float32 reference; with `fault`, the
    program's with its loss scaled by 1.5 where it is produced (the fault a
    check of the loss has to catch) in place of the fp8 reference's."""
    from svd_xtend_tpu_torch.core.config import TrainConfig
    from svd_xtend_tpu_torch.diffusion import training as port_training

    cfg, traffic, _ = _cell(TRAIN)
    tc = TrainConfig(**traffic["train"])
    real_loss = port_training.edm_denoising_loss
    if fault:
        port_training.edm_denoising_loss = lambda *a, **kw: real_loss(*a, **kw) * 1.5
    try:
        models, state, step = train_kind.program(cfg, tc, seed, device)
        pool = train_kind.batches(seed, tc, cfg, train_kind.CHECKED, device)
        box = {"state": state}

        def one(i):
            pixels, draws = pool[i]
            box["state"], metrics = step(box["state"], pixels,
                                         draws=port_training.TrainDraws(**draws))
            return metrics["loss"]

        prog = train_kind.checked_steps(one, state, tc)
    finally:
        port_training.edm_denoising_loss = real_loss
    del models, state, step, box
    torch.cuda.empty_cache()
    ref = train_kind.reference(cfg, traffic["train"], seed, pool, device)
    if fault:
        return {"fault_loss_x1.5": train_kind.compare(prog, ref)}
    torch.cuda.empty_cache()
    ctrl = train_kind.reference(cfg, traffic["train"], seed, pool, device, fp8=True)
    return {"program": train_kind.compare(prog, ref), "control": train_kind.compare(ctrl, ref)}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_gen_control_fails(seed):
    _needs_card()
    limits = _cell(GEN)[2]
    readings = gen_readings(seed)
    control = readings["control"]
    assert any(control[k] > v for k, v in limits.items()), control
    low = readings["fp8_reference"]
    assert low["start_rel_l2"] > limits["start_rel_l2"]
    assert low["sampler_rel_l2"] > limits["sampler_rel_l2"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_fails(seed):
    _needs_card()
    limits = _cell(TRAIN)[2]
    control = train_readings(seed)["control"]
    assert any(control[k] > v for k, v in limits.items()), control
    assert control["grad_gap"] > limits["grad_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_train_altered_loss_fails(seed):
    """At the cell's own size the first gradient is clipped and AdamW does not
    see its scale, so a loss scaled by 1.5 shows in the loss alone."""
    _needs_card()
    limits = _cell(TRAIN)[2]
    fault = train_readings(seed, fault=True)["fault_loss_x1.5"]
    assert fault["loss_gap"] > limits["loss_gap"], fault


if __name__ == "__main__":
    what, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    readings = {"gen": gen_readings, "train": train_readings,
                "train-fault": lambda s: train_readings(s, fault=True)}[what]
    for s in seeds:
        print(json.dumps({"cell": what, "seed": s, **readings(s)}), flush=True)
