"""The operation counts of benchmark/flops.py against
torch.utils.flop_counter.FlopCounterMode on the reference at TINY sizes."""

from __future__ import annotations

import json

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, weights
from benchmark.kinds import train as train_kind
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import svd
from benchmark.tests.tiny import DATA, tiny_config


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config(json.loads((DATA / "configs" / "svd-img2vid-xt.json").read_text()),
                      "float32")
    nets = svd.networks(cfg)
    weights.fill_(weights.named_leaves(nets), 5)
    return cfg, nets


def _counted(fn) -> int:
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("b,f,h,w", [(2, 3, 16, 16), (1, 5, 8, 12)])
def test_unet(tiny, b, f, h, w):
    cfg, nets = tiny
    x = torch.randn(b, f, h, w, cfg["unet"]["in_channels"])
    run = lambda: nets["unet"](x, torch.ones(b), torch.randn(b, 1, 32), torch.ones(b, 3))
    assert _counted(run) == flops.unet_flops(cfg["unet"], b, f, h, w)


def test_vae_and_clip(tiny):
    cfg, nets = tiny
    images = torch.rand(3, 32, 48, 3) * 2 - 1
    assert _counted(lambda: nets["vae"].encode(images)) == flops.vae_encode_flops(
        cfg["vae"], 3, 32, 48)
    z = torch.randn(1, 3, 16, 24, 4)
    assert _counted(lambda: nets["vae"].decoder(z)) == flops.vae_decode_flops(cfg["vae"], 3, 16,
                                                                             24)
    fx = cfg["feature_extractor"]
    run = lambda: nets["clip"](svd.clip_pixels(images, cfg["image_encoder"], fx["image_mean"],
                                               fx["image_std"]))
    run()     # the resize operators are made once per size, outside the count
    assert _counted(run) == flops.clip_flops(cfg["image_encoder"], 3, 32, 48)


def test_video(tiny):
    cfg, nets = tiny
    pipe = {"height": 32, "width": 32, "num_frames": 3, "num_inference_steps": 2,
            "min_guidance_scale": 1.0, "max_guidance_scale": 3.0, "fps": 7,
            "motion_bucket_id": 127, "noise_aug_strength": 0.02, "decode_chunk_size": 2}
    image = torch.rand(1, 32, 32, 3) * 2 - 1
    run = lambda: ref_pipeline.generate(nets, cfg, pipe, image, torch.randn_like(image),
                                        torch.randn(1, 3, 16, 16, 4))
    run()
    assert _counted(run) == flops.video_flops(cfg, pipe)


def test_train_step(tiny):
    """The step's count against what autograd computes for the same step
    (no remat): the forward, the activation gradients the trainable leaves
    need, their weight gradients."""
    cfg, nets = tiny
    from svd_xtend_tpu_torch.core.config import TrainConfig
    train = json.loads((DATA / "traffic" / "train-temporal-320p.json").read_text())["train"]
    train.update(height=32, width=32, num_frames=3)
    tc = TrainConfig(**train)
    pool = train_kind.batches(1, tc, cfg, 1, torch.device("cpu"))
    names = [n for n, _ in nets["unet"].named_parameters() if "temporal_transformer_block" in n]

    def step():
        for net in nets.values():
            net.requires_grad_(False)
        named = dict(nets["unet"].named_parameters())
        params = [named[n].requires_grad_(True) for n in names]
        loss = ref_pipeline.train_loss(nets, cfg, train, *pool[0], remat=False)
        torch.autograd.grad(loss, params, materialize_grads=True)

    step()
    counted = _counted(step)
    ours = flops.train_step_flops(cfg, train)
    assert ours == counted


def test_rooflines_per_call():
    f, b = flops.attn1_cost(50, 9216, 320, 5)
    assert f == 8 * 50 * 9216 * 320 ** 2 + 4 * 50 * 9216 ** 2 * 320
    assert b == 2 * (2 * 50 * 9216 * 320 + 4 * 320 ** 2 + 320)
    f, b = flops.ff_cost(1000, 320)
    assert f == 2 * 1000 * 320 * 2560 + 2 * 1000 * 1280 * 320
