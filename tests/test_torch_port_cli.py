"""The port's training CLI (svd_xtend_tpu_torch/train/cli.py) on the CPU
against the JAX package's: the flags and their defaults, the TrainConfig it
builds, what it refuses, and the slice as a whole: TINY runs of
``main(["--device", "cpu", "--tiny_model", ...])`` over a seeded JPEG frame
folder, where 4 straight steps and 2 steps plus a resume to 4 leave the same
masters, moments, EMA and data step bit for bit, and the files a run writes
load back (the exported UNet through the JAX package's diffusers_to_flax,
the 'lora' adapter through its lora_diffusers_to_flax)."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import lora as jlora
from svd_xtend_tpu.train import cli as jcli
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.io import safetensors_io as st
from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
from svd_xtend_tpu_torch.train import cli as tcli
from svd_xtend_tpu_torch.train.checkpoint import STATE_FILE

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """2 videos x 5 seeded 40x48 JPEG frames that change from frame to frame."""
    root = tmp_path_factory.mktemp("frames")
    rs = np.random.RandomState(0)
    for v in range(2):
        d = root / f"video{v}"
        d.mkdir()
        base = rs.randint(0, 255, (40, 48, 3))
        for f in range(5):
            arr = np.clip(base + 12 * f + rs.randint(-10, 10, base.shape), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"{f:04d}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def jax_params():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    return jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))


# ------------------------------------------------------------------ flags --

def test_flags_and_defaults_match_jax():
    """Every JAX flag with its default, and --device (default cuda) besides."""
    got = vars(tcli.parse_args(["--base_folder", "f"]))
    want = vars(jcli.parse_args(["--base_folder", "f"]))
    assert got.pop("device") == "cuda"
    assert got == want
    with pytest.raises(SystemExit):
        tcli.parse_args([])          # --base_folder is required, as in JAX


@pytest.mark.parametrize("argv", [
    [],
    ["--train_mode", "lora", "--rank", "8", "--learning_rate", "3e-5", "--scale_lr",
     "--gradient_accumulation_steps", "2", "--mixed_precision", "no", "--remat", "outer",
     "--mesh_data", "1", "--report_to", "all", "--use_ema"],
    ["--train_mode", "full", "--tracklet_dim_full", "--tracklet_dim", "64", "--use_8bit_adam",
     "--zero1", "--host_offload", "masters", "--grad_dtype", "bf16", "--width", "256",
     "--height", "128", "--num_frames", "8", "--checkpointing_steps", "7",
     "--resume_from_checkpoint", "latest", "--seed", "3", "--lr_scheduler", "cosine"],
])
def test_build_train_config_matches_jax(argv):
    argv = ["--base_folder", "frames"] + argv
    got = dataclasses.asdict(tcli.build_train_config(tcli.parse_args(argv)))
    want = dataclasses.asdict(jcli.build_train_config(jcli.parse_args(argv)))
    assert got == want


@pytest.mark.parametrize("extra,match", [
    (["--mesh_data", "2"], "world has 1"), (["--mesh_data", "3", "--zero1"], "world has 1"),
    (["--train_mode", "lora", "--host_offload", "masters", "--mesh_data", "2"], "world has 1"),
    (["--train_mode", "lora", "--host_offload", "masters+moments", "--mesh_model", "2",
      "--use_8bit_adam"], "world has 1"),
    (["--host_offload", "masters", "--mesh_data", "2"], "world has 1"),
    (["--zero1", "--mesh_model", "4"], "world has 1"),
    (["--mesh_model", "2"], "world has 1"), (["--attn_impl", "flash"], "--attn_impl flash"),
    (["--attn_impl", "xla"], "--attn_impl xla")])
def test_refused_options_raise_before_any_work(tmp_path, extra, match):
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=match):
        tcli.main(["--base_folder", str(tmp_path), "--device", "cpu", "--output_dir",
                   str(out)] + extra)
    assert not out.exists()


# -------------------------------------------------------- the slice whole --

def _argv(frames, out, scope, steps, **kw):
    argv = ["--base_folder", frames, "--tiny_model", "--device", "cpu",
            "--width", "32", "--height", "32", "--num_frames", "3",
            "--train_mode", scope, "--learning_rate", "1e-3", "--lr_warmup_steps", "0",
            "--output_dir", out, "--checkpointing_steps", "2", "--checkpoints_total_limit", "2",
            "--validation_steps", "4", "--num_inference_steps", "2", "--num_workers", "2",
            "--seed", "7", "--max_train_steps", str(steps)]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return argv


def _same(a, b, path="state"):
    """Equal nested dicts / lists of tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


SCOPES = {"temporal": dict(mixed_precision="bf16", remat="block"),
          "full-ema": dict(mixed_precision="no", remat="none", use_ema=True),
          "lora": dict(mixed_precision="bf16", remat="block", rank=2)}


@pytest.mark.parametrize("name", list(SCOPES))
def test_resume_from_checkpoint_2_equals_a_straight_run(frames, tmp_path, jax_params, name):
    """4 straight steps (checkpoints at 2 and 4, validation at 1 and 4),
    against checkpoint-2 copied into a fresh directory and resumed from
    'latest' to 4: the same state file contents (step, masters or adapter,
    EMA, moments, count) and data state. Then the run's files."""
    scope, kw = name.split("-")[0], SCOPES[name]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    stats = tcli.main(_argv(frames, a, scope, 4, **kw))
    assert [c["step"] for c in stats["checkpoints"]] == [2, 4]
    assert len(stats["step_seconds"]) == 4 and len(stats["validation_seconds"]) == 2
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "checkpoint-2"), os.path.join(b, "checkpoint-2"))
    resumed = tcli.main(_argv(frames, b, scope, 4, resume_from_checkpoint="latest", **kw))
    assert resumed["restore_seconds"] is not None and len(resumed["step_seconds"]) == 2
    load = lambda d: torch.load(os.path.join(d, "checkpoint-4", "state", STATE_FILE),
                                weights_only=True)
    sa, sb = load(a), load(b)
    assert sa["step"] == 4 and sa["optimizer"]["count"] == 4
    assert (sa["ema_params"] is not None) == (scope == "full")
    _same(sa, sb)
    for d in (a, b):
        with open(os.path.join(d, "checkpoint-4", "data_state.json")) as f:
            assert json.load(f) == {"step": 4, "seed": 7}
    assert sorted(n for n in os.listdir(b) if n.startswith("checkpoint-")) == [
        "checkpoint-2", "checkpoint-4"]
    with open(os.path.join(b, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records[0]["step"] == 3 and "train_loss" in records[0]

    _check_files(a, scope, jax_params)


def _check_files(out, scope, jax_params):
    names = sorted(os.listdir(out))
    for f in ("logs", "unet", "validation_images", "checkpoint-2", "checkpoint-4"):
        assert f in names
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in train] == [1]
    assert set(train[0]) == {"step", "ts", "train_loss", "grad_norm", "lr", "steps_per_sec"}
    assert all(np.isfinite(r["train_loss"]) for r in train)
    val = [r for r in records if "val/clip_frame_score" in r]
    assert [r["step"] for r in val] == [1, 4]
    assert set(val[0]) == {"step", "ts", "val/clip_frame_score",
                           "val/clip_temporal_consistency", "val/pixel_dynamics"}
    gif = os.path.join(out, "validation_images", "val_img_4.gif")
    with open(gif, "rb") as f:
        assert f.read(6) == b"GIF89a"
    with Image.open(gif) as img:
        assert img.n_frames == 3 and img.size == (32, 32)
    if scope == "lora":
        assert "params_train.txt" not in names
        sd = jconv.load_safetensors(os.path.join(out, "pytorch_lora_weights.safetensors"))
        template = jlora.init(jax.random.PRNGKey(0), jax_params["unet"], rank=2)
        back = jconv.lora_diffusers_to_flax(sd, template)
        assert list(back) == list(template)
    else:
        with open(os.path.join(out, "params_train.txt")) as f:
            train_names = f.read().split("\n")
        with open(os.path.join(out, "params_freeze.txt")) as f:
            frozen_names = [n for n in f.read().split("\n") if n]
        every = [n for n, _ in UNetSpatioTemporalConditionModel(
            tcfg.TINY_UNET).named_parameters()]
        assert sorted(train_names + frozen_names) == sorted(every)
        if scope == "temporal":
            assert all("temporal_transformer_block" in n for n in train_names)
            assert not any("temporal_transformer_block" in n for n in frozen_names)
        else:
            assert frozen_names == []
    path = os.path.join(out, "unet", "diffusion_pytorch_model.safetensors")
    sd = st.load_file(path)
    assert all(v.dtype == torch.float32 for v in sd.values())
    UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).load_state_dict(sd, strict=True)
    with open(os.path.join(out, "unet", "config.json")) as f:
        assert tcfg.UNetConfig.from_json(f.read()) == tcfg.TINY_UNET
    template = jax_params["unet"]
    back = jconv.flatten(jconv.diffusers_to_flax(jconv.load_safetensors(path), template))
    assert set(back) == set(jconv.flatten(template))


def test_validation_image_is_read_with_pil(frames, tmp_path):
    """--validation_image: the video is conditioned on the image (resized
    bicubic to the training size) instead of the synthetic one."""
    out = str(tmp_path / "run")
    img = os.path.join(frames, "video0", "0000.jpg")
    tcli.main(_argv(frames, out, "temporal", 1, validation_image=img, mixed_precision="no",
                    remat="none"))
    with Image.open(os.path.join(out, "validation_images", "val_img_1.gif")) as gif:
        assert gif.n_frames == 3
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        assert any("val/pixel_dynamics" in json.loads(line) for line in f)


def test_sigterm_saves_at_the_next_step_and_stops(frames, tmp_path, monkeypatch):
    """SIGTERM during step 1: checkpoint-2 at the next step boundary (no
    checkpointing interval reached), the loop stops, the export follows,
    and main() puts the previous SIGTERM handler back."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    draw = tcli.step_generator

    def step_generator(seed, step, device):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)
        return draw(seed, step, device)

    monkeypatch.setattr(tcli, "step_generator", step_generator)
    out = str(tmp_path / "run")
    stats = tcli.main(_argv(frames, out, "temporal", 6, checkpointing_steps=100,
                            validation_steps=100, mixed_precision="no", remat="none"))
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(stats["step_seconds"]) == 2
    assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint-")) == ["checkpoint-2"]
    with open(os.path.join(out, "checkpoint-2", "data_state.json")) as f:
        assert json.load(f) == {"step": 2, "seed": 7}
    assert os.path.exists(os.path.join(out, "unet", "diffusion_pytorch_model.safetensors"))


def test_validation_image_without_pil_raises_naming_pil(frames, monkeypatch):
    """Where PIL does not import, a --validation_image raises ImportError
    naming PIL (the synthetic image is only for no image given)."""
    import sys
    import types
    monkeypatch.setitem(sys.modules, "PIL", None)
    args = tcli.parse_args(["--base_folder", frames, "--validation_image",
                            os.path.join(frames, "video0", "0000.jpg")])
    models = types.SimpleNamespace(unet=types.SimpleNamespace(
        conv_in=types.SimpleNamespace(weight=torch.zeros(1))))
    with pytest.raises(ImportError, match="PIL"):
        tcli.run_validation(models, None, args, tcli.build_train_config(args), 1, None)


def test_load_or_init_params_reads_pipeline_directories(frames, tmp_path, jax_params):
    """--pretrained_model_path (a diffusers pipeline directory written by
    the JAX package's exporters, its CLIP file with a key the tower lacks)
    and --pretrain_unet (a UNet directory): the networks hold the JAX
    params afterwards; without either, the seeded random init."""
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.io.convert import state_dict_from_jax
    root = tmp_path / "pipe"
    files = {"unet": jconv.flax_to_diffusers(jax_params["unet"]),
             "vae": jconv.flax_to_diffusers(jax_params["vae"]),
             "image_encoder": {**jconv.clip_flax_to_transformers(
                 jax_params["clip"], patch_size=jcfg.TINY_CLIP.patch_size),
                 "vision_model.embeddings.position_ids": np.arange(5)[None]}}
    for sub, sd in files.items():
        os.makedirs(root / sub)
        name = "model.safetensors" if sub == "image_encoder" else tcli.UNET_FILE
        jconv.save_safetensors(str(root / sub / name), sd)
    want = state_dict_from_jax(jconv.flatten(jax_params), jcfg.TINY_CLIP.patch_size)
    tiny = lambda: SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cpu")
    for flags, parts in ((["--pretrained_model_path", str(root)], ("unet", "vae", "clip")),
                         (["--pretrain_unet", str(root / "unet")], ("unet",))):
        models = tcli.load_or_init_params(tiny(), tcli.parse_args(["--base_folder", frames]
                                                                  + flags))
        for part in ("unet", "vae", "clip"):
            got = getattr(models, part).state_dict()
            same = all(torch.equal(got[k], v) for k, v in want[part].items())
            assert same == (part in parts), (flags, part)
    a, b = (tcli.load_or_init_params(tiny(), tcli.parse_args(["--base_folder", frames]))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.unet.state_dict().values(),
                                                 b.unet.state_dict().values()))
