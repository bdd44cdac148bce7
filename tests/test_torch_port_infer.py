"""The port's inference entry (``svd_xtend_tpu_torch/scripts/infer_svd.py``)
against the JAX package's ``examples/infer_svd.py`` on the CPU: the same
flags and defaults, the image and boxes handed to ``generate`` equal to the
JAX script's, and at TINY widths through ``main(argv, models)``: the LoRA
and tracklet files loaded and merged, the mp4 and GIF written. Without a
card, the default ``--device cuda`` raises."""

import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import media as jmedia
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.data import make_fixtures as fx
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io import convert
from svd_xtend_tpu_torch.models import lora
from svd_xtend_tpu_torch.scripts import infer_svd
from svd_xtend_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

JAX_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "examples", "infer_svd.py")
BOXES = [[0.1, 0.2, 0.5, 0.6], [0.3, 0.1, 0.9, 0.7], [0.0, 0.0, 1.0, 1.0]]


def _jax_script_inputs(monkeypatch, argv):
    """Run the JAX script's main() with its models, parameters, generate and
    writers stubbed (it builds the full-size SVD otherwise): what it hands
    generate (image, config, boxes, mask) and the files it names."""
    seen = {}

    def fake_generate(models, params, image, rng, cfg, boxes, mask):
        seen.update(image=np.asarray(image), cfg=cfg, boxes=boxes, mask=mask,
                    tracklet_dim=models.unet_config.tracklet_dim)
        return jax.numpy.zeros((1, cfg.num_frames, cfg.height, cfg.width, 3))

    monkeypatch.setattr(jpipe, "generate", fake_generate)
    monkeypatch.setattr(jpipe, "init_pipeline_params", lambda *a, **k: {})
    monkeypatch.setattr(jmedia, "export_to_video", lambda f, p, fps: seen.update(mp4=p, fps=fps))
    monkeypatch.setattr(jmedia, "export_to_gif", lambda f, p: seen.update(gif=p))
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, *argv])
    runpy.run_path(JAX_SCRIPT, run_name="__main__")
    return seen


def test_flags_and_defaults_are_the_jax_scripts():
    """Every flag of the JAX script with its default, plus --device."""
    import argparse
    import ast
    tree = ast.parse(open(JAX_SCRIPT).read())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            name = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            want[name] = ast.literal_eval(kw["default"]) if "default" in kw else None
    got = vars(infer_svd.parse_args(["--image", "x.jpg"]))
    assert got.pop("device") == "cuda"
    got["image"] = None
    assert got == want
    with pytest.raises(SystemExit):
        infer_svd.parse_args([])
    assert isinstance(infer_svd.parse_args(["--image", "a"]), argparse.Namespace)


@pytest.mark.parametrize("boxes", [False, True])
def test_image_boxes_and_config_equal_the_jax_scripts(monkeypatch, tmp_path, boxes):
    """The committed 1280x720 frame read, resized (bicubic) and scaled as
    the JAX script does, bit for bit; the static boxes broadcast to every
    frame with an all-ones mask; the same PipelineConfig; the same files."""
    out = str(tmp_path / "v.mp4")
    argv = ["--image", fx.reference_paths()[0], "--width", "64", "--height", "32",
            "--num_frames", "3", "--steps", "2", "--out", out]
    if boxes:
        argv += ["--boxes", json.dumps(BOXES), "--tracklet_dim", "8"]
    seen = _jax_script_inputs(monkeypatch, argv)
    args = infer_svd.parse_args(argv)
    image = infer_svd.load_image(args.image, args.width, args.height)
    np.testing.assert_array_equal(image.numpy(), seen["image"])
    assert seen["mp4"] == out and seen["gif"] == out.replace(".mp4", ".gif")
    assert seen["fps"] == 7
    assert seen["tracklet_dim"] == (8 if boxes else 0)
    j = seen["cfg"]
    for f in ("height", "width", "num_frames", "num_inference_steps", "fps",
              "motion_bucket_id", "noise_aug_strength", "decode_chunk_size", "fps_offset"):
        assert getattr(j, f) == getattr(tcfg.PipelineConfig(
            height=args.height, width=args.width, num_frames=args.num_frames,
            num_inference_steps=args.steps, fps=args.fps, motion_bucket_id=args.motion_bucket_id,
            noise_aug_strength=args.noise_aug_strength,
            decode_chunk_size=args.decode_chunk_size), f), f
    if boxes:
        b, m = infer_svd.static_boxes(args.boxes, args.num_frames)
        np.testing.assert_array_equal(b.numpy(), np.asarray(seen["boxes"]))
        np.testing.assert_array_equal(m.numpy(), np.asarray(seen["mask"]))
        assert b.shape == (1, 3, 3, 4)
    else:
        assert seen["boxes"] is None and seen["mask"] is None


def _tiny_models(seed=0):
    return tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu",
                                  generator=torch.Generator().manual_seed(seed))


def test_main_at_tiny_loads_the_files_and_writes_the_video(tmp_path):
    """main(argv, models) at TINY with --boxes, a tracklet file and a LoRA
    file (both written with the port's exporters over a tracklet UNet): the
    branch holds the file's weights, every LoRA target the merged weight,
    and the mp4 and the GIF hold the frames."""
    src = _tiny_models(1).with_tracklet(8, heads=2, gate_init=0.5,
                                        generator=torch.Generator().manual_seed(2))
    ckpt.export_tracklet(src.unet, str(tmp_path / "trk"))
    g = torch.Generator().manual_seed(3)
    adapter = lora.init(src.unet, generator=g)
    for ab in adapter.values():
        ab["b"].normal_(0.0, 0.05, generator=g)
    ckpt.export_lora_diffusers(adapter, str(tmp_path / "lora"))

    models = _tiny_models(4)
    out = str(tmp_path / "v.mp4")
    argv = ["--image", fx.reference_paths()[0], "--width", "32", "--height", "32",
            "--num_frames", "3", "--steps", "2", "--decode_chunk_size", "2",
            "--boxes", json.dumps(BOXES), "--tracklet_path", str(tmp_path / "trk"),
            "--tracklet_dim", "8", "--lora_path", str(tmp_path / "lora"), "--out", out,
            "--device", "cpu"]
    args = infer_svd.parse_args(argv)
    loaded = infer_svd.load_models(args, models)
    assert loaded.unet.tracklet_conditioner is not None
    expect = tpipe.SVDModels(models.unet, models.vae, models.clip).with_tracklet(8)
    convert.tracklet_branch_into_unet(convert.tracklet_branch_to_flat(src.unet), expect.unet)
    merged = lora.merge(expect.unet, adapter)
    modules = dict(loaded.unet.named_modules())
    for name, w in merged.items():
        assert torch.equal(modules[name].weight, w), name
    for k, v in src.unet.state_dict().items():
        if convert.is_branch_key(k) and not any(k.startswith(n + ".") for n in merged):
            assert torch.equal(loaded.unet.state_dict()[k], v), k

    result = infer_svd.main(argv, models=_tiny_models(4))
    video = result["video"]
    assert video.shape == (1, 3, 32, 32, 3) and bool(torch.isfinite(video).all())
    assert result["mp4"] == out and os.path.getsize(out) > 0
    from PIL import Image
    with Image.open(result["gif"]) as gif:
        assert gif.n_frames == 3 and gif.size == (32, 32)
    import cv2
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_default_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_svd.main(["--image", fx.reference_paths()[0], "--out", str(tmp_path / "v.mp4")])
