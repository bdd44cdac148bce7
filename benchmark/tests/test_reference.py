"""The float32 reference against the program at TINY sizes in f32: the
whole video and the first train steps through the harness's own check, and
each network alone on the same weights."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness, program, weights
from benchmark.reference import svd
from benchmark.tests.tiny import DATA, tiny_config, tiny_data


@pytest.fixture(scope="module")
def f32_data(tmp_path_factory):
    return tiny_data(tmp_path_factory.mktemp("bench32"), dtype="float32")


@pytest.mark.parametrize("cell,tol", [("tiny-gen", 1e-4), ("tiny-train", 1e-4)])
def test_check_in_f32(f32_data, cell, tol):
    spec, d = f32_data
    line = harness.run_cell(spec, cell, 424242, 0.2, False, "cpu", time.perf_counter(),
                            data_dir=d)
    assert line["correct"] and all(c["value"] < tol for c in line["checks"].values()), line


@pytest.fixture(scope="module")
def both_sides():
    """The program's networks and the reference's, in f32, on the same weights."""
    cfg = tiny_config(json.loads((DATA / "configs" / "svd-img2vid.json").read_text()), "float32")
    models = program.build_models(cfg, "cpu", torch.float32, 77)
    nets = svd.networks(cfg)
    weights.fill_(weights.named_leaves(nets), 77)
    return cfg, models, nets


def test_same_leaves(both_sides):
    _, models, nets = both_sides
    ours = weights.named_leaves({"unet": models.unet, "vae": models.vae, "clip": models.clip})
    theirs = weights.named_leaves(nets)
    assert {n: tuple(p.shape) for n, p in ours.items()} == {
        n: tuple(p.shape) for n, p in theirs.items()}


@pytest.mark.parametrize("network", ["unet", "vae_encode", "vae_decode", "clip"])
def test_networks_alone(both_sides, network):
    cfg, models, nets = both_sides
    g = torch.Generator().manual_seed(0)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    img = torch.rand(3, 32, 32, 3, generator=g) * 2 - 1
    with torch.no_grad():
        if network == "unet":
            x = torch.randn(2, 3, 16, 16, 8, generator=g)
            t, ehs = torch.tensor([0.3, -1.0]), torch.randn(2, 1, 32, generator=g)
            ids = torch.rand(2, 3, generator=g)
            got, want = models.unet(x, t, ehs, ids), nets["unet"](x, t, ehs, ids)
        elif network == "vae_encode":
            got, want = models.vae.encode(img).mean, nets["vae"].encode(img)[0]
        elif network == "vae_decode":
            z = torch.randn(1, 3, 16, 16, 4, generator=g)
            got, want = models.vae.decode(z), nets["vae"].decoder(z)
        else:
            fx = cfg["feature_extractor"]
            from svd_xtend_tpu_torch.models.clip import preprocess_for_clip
            got = models.clip(preprocess_for_clip(img, models.clip.config))
            want = nets["clip"](svd.clip_pixels(img, cfg["image_encoder"], fx["image_mean"],
                                                fx["image_std"]))
    assert rel(got, want) < 1e-5


def test_fp8_control_rounds():
    """The control's rounding is fp8 e4m3 with a per-tensor scale: 3 mantissa
    bits, so a relative error up to 2^-4, and the backward straight through."""
    num = svd.Num(fp8=True)
    x = torch.linspace(-3.0, 3.0, 1001, requires_grad=True)
    y = num(x)
    err = (y - x).abs().max().item()
    assert 0 < err <= 3.0 * 2 ** -4
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert svd.EXACT(x) is x
