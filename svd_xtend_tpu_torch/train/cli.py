"""Training CLI — the train_svd.py / train_svd_lora.py replacement.

Port of ``svd_xtend_tpu/train/cli.py``: the reference's flag surface
(train_svd.py:294-569; train_svd_lora.py adds --rank) with the JAX
package's defaults, and main()'s order (SURVEY.md §3.1): load models ->
select the trainable scope -> optimizer -> (resume) -> data -> hot loop
[encode, EDM loss, update, EMA] -> checkpoint/rotate -> validation
sampling -> final export.

Usage:
  python -m svd_xtend_tpu_torch.train.cli --base_folder ./frames --train_mode temporal
  python -m svd_xtend_tpu_torch.train.cli --base_folder ./frames --train_mode lora --rank 4
  python -m svd_xtend_tpu_torch.train.cli --base_folder ./frames --device cpu --tiny_model

One card (``--device``, ``cuda`` by default; ``cpu`` runs the kernels'
plain versions): the mesh flags take one card only, ``--attn_impl`` only
``auto``, and what ``TrainConfig.check_ported`` refuses stays refused.
Each step's draws come from a generator on the step's device seeded from
(seed, step) alone (the JAX step folds the step into one key), so a resumed
run draws what a straight run draws and the checkpoint holds no generator.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time

import numpy as np
import torch

from ..core.config import (TINY_CLIP, TINY_UNET, TINY_VAE, CLIPVisionConfig, MeshConfig,
                           PipelineConfig, TrainConfig, UNetConfig, VAEConfig)
from ..data.dataset import FrameFolderDataset, ShardedLoader
from ..diffusion.pipeline import SVDModels, generate, init_random_
from ..io.media import export_to_gif
from ..models import lora as lora_lib
from ..train import checkpoint as ckpt_lib
from ..train.optim import training_schedule
from ..train.state import (TrainState, cast_frozen_to_compute, create_train_state,
                           make_train_step, param_audit, trainable_mask)
from ..utils.logging import MetricWriter, get_logger

UNET_FILE = "diffusion_pytorch_model.safetensors"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="SVD finetuning on one CUDA card (PyTorch)")
    # data (reference --base_folder/--width/--height/--num_frames)
    p.add_argument("--base_folder", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--num_workers", type=int, default=8)
    # scope
    p.add_argument("--train_mode",
                   choices=["full", "temporal", "lora", "tracklet"],
                   default="temporal")
    p.add_argument("--rank", type=int, default=4, help="LoRA rank (=alpha)")
    # Tracklet2Video: parsed as in the JAX package, refused (ROADMAP A9)
    p.add_argument("--tracklet_dim", type=int, default=1024,
                   help="box-token width (--train_mode tracklet; not ported)")
    p.add_argument("--tracklet_dim_full", action="store_true",
                   help="with --train_mode full: also train the tracklet branch (not ported)")
    p.add_argument("--tracklet_gate_init", type=float, default=0.0,
                   help="GLIGEN gate init (not ported)")
    p.add_argument("--max_boxes", type=int, default=16,
                   help="per-frame box slots (not ported)")
    # optimization
    p.add_argument("--per_device_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=50000)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="blockwise-int8 Adam moments (not ported: ROADMAP A12.7)")
    p.add_argument("--host_offload",
                   choices=["none", "masters", "masters+moments"],
                   default="none",
                   help="optimizer state in host memory (not ported: ROADMAP A13)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 optimizer-state sharding (not ported: ROADMAP A13)")
    p.add_argument("--conditioning_dropout_prob", type=float, default=0.1)
    p.add_argument("--p_mean", type=float, default=0.7,
                   help="EDM sigma-sampling log-mean (train_svd.py:1014)")
    p.add_argument("--p_std", type=float, default=1.6,
                   help="EDM sigma-sampling log-std (train_svd.py:1014)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--mixed_precision", choices=["no", "bf16"], default="bf16")
    p.add_argument("--grad_dtype", choices=["fp32", "bf16"], default="fp32",
                   help="gradient storage dtype (bf16 not ported: ROADMAP A12.7)")
    p.add_argument("--seed", type=int, default=123)
    # checkpointing / validation / logging
    p.add_argument("--output_dir", default="./outputs/svd-finetune")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=2)
    p.add_argument("--resume_from_checkpoint", default="",
                   help="path or 'latest'")
    p.add_argument("--validation_steps", type=int, default=500)
    p.add_argument("--validation_image", default="",
                   help="conditioning image for validation videos (read with PIL)")
    p.add_argument("--num_validation_images", type=int, default=1)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--report_to", default="tensorboard",
                   help="tensorboard|wandb|comet_ml|all (train_svd.py:508-516; "
                        "each used when importable)")
    p.add_argument("--push_to_hub", action="store_true",
                   help="upload final model to the HF hub (needs network)")
    p.add_argument("--hub_model_id", default="")
    # model init
    p.add_argument("--pretrained_model_path", default="",
                   help="dir with diffusers-format unet/vae/image_encoder safetensors")
    p.add_argument("--pretrain_unet", default="",
                   help="alternative UNet init dir (reference --pretrain_unet)")
    p.add_argument("--tiny_model", action="store_true",
                   help="debug: use the tiny test configs")
    p.add_argument("--attn_impl", choices=["auto", "flash", "xla"], default="auto",
                   help="only 'auto' is ported (the flash kernels on the card)")
    # mesh: one card
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--remat", choices=["none", "block", "outer"],
                   default="block")
    p.add_argument("--device", default="cuda",
                   help="the card ('cuda', the default) or 'cpu' (the kernels' plain versions)")
    return p.parse_args(argv)


def build_train_config(args) -> TrainConfig:
    return TrainConfig(
        base_folder=args.base_folder, width=args.width, height=args.height,
        num_frames=args.num_frames, per_device_batch_size=args.per_device_batch_size,
        num_workers=args.num_workers, learning_rate=args.learning_rate,
        scale_lr=args.scale_lr, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps, max_train_steps=args.max_train_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, use_8bit_adam=args.use_8bit_adam,
        zero1=args.zero1, grad_dtype=args.grad_dtype,
        host_offload=args.host_offload,
        p_mean=args.p_mean, p_std=args.p_std,
        conditioning_dropout_prob=args.conditioning_dropout_prob,
        train_mode=args.train_mode, lora_rank=args.rank, lora_alpha=args.rank,
        tracklet_dim=(args.tracklet_dim
                      if args.train_mode == "tracklet"
                      else (args.tracklet_dim
                            if args.train_mode == "full"
                            and args.tracklet_dim_full else 0)),
        tracklet_gate_init=args.tracklet_gate_init,
        max_boxes=args.max_boxes,
        use_ema=args.use_ema, mixed_precision=args.mixed_precision,
        output_dir=args.output_dir, checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint,
        validation_steps=args.validation_steps, seed=args.seed,
        report_to=args.report_to, remat_policy=args.remat,
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
    )


def derived_seed(seed: int, *keys: int, spawn_key=()) -> int:
    """A 64-bit seed that is a pure function of (seed, keys, spawn_key)."""
    ss = np.random.SeedSequence([seed, *keys], spawn_key=spawn_key)
    return int(ss.generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step `step`'s draws, on `device` (a CPU
    generator cannot draw CUDA tensors), from (seed, step) alone."""
    return torch.Generator(device=device).manual_seed(derived_seed(seed, step))


def check_one_card(args) -> None:
    if args.mesh_data not in (-1, 1) or args.mesh_model != 1:
        raise ValueError(f"not ported yet: a mesh over more than one card (--mesh_data "
                         f"{args.mesh_data} --mesh_model {args.mesh_model}; ROADMAP A13); "
                         "the port trains on one card: --mesh_data -1 or 1, --mesh_model 1")
    if args.attn_impl != "auto":
        raise ValueError(f"--attn_impl {args.attn_impl} is not ported: the port's attention is "
                         "'auto' (the hand-written flash kernels on the card, their plain "
                         "versions on the CPU)")


def load_or_init_params(models: SVDModels, args) -> SVDModels:
    """Seeded random weights (init_random_ from --seed), then the pretrained
    diffusers-format pipeline directory and the --pretrain_unet UNet where
    given (reference train_svd.py:553-558, 643-656). In place."""
    device = models.unet.conv_in.weight.device
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for net in (models.unet, models.vae, models.clip):
        init_random_(net, gen)
    if args.pretrained_model_path:
        from ..io import convert
        convert.load_diffusers_checkpoint(args.pretrained_model_path, models)
    if args.pretrain_unet:
        from ..io import convert
        models.unet.load_state_dict(convert.load_component_state(args.pretrain_unet, UNET_FILE),
                                    strict=True)
    return models


def _synthetic_validation_image(height: int, width: int) -> torch.Tensor:
    """Deterministic (1, H, W, 3) conditioning image in [-1, 1]: a smooth
    two-axis gradient with a bright disc off-center — enough structure for
    CLIP conditioning and for eyeballing motion in the sampled video."""
    y = np.linspace(-1.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(-1.0, 1.0, width, dtype=np.float32)[None, :]
    r = np.sqrt((x - 0.3) ** 2 + (y + 0.2) ** 2)
    disc = np.clip(1.0 - r / 0.35, 0.0, 1.0)
    img = np.stack([0.5 * x + 0.9 * disc,
                    0.5 * y + 0.6 * disc,
                    0.25 * (x + y) + 0.3 * disc], axis=-1)
    return torch.from_numpy(np.clip(img, -1.0, 1.0))[None]


def _write_back(models: SVDModels, state: TrainState, tensors=None) -> None:
    """Copy the state's f32 masters (or `tensors`, aligned with them) into
    the UNet's compute copies, rounded to its dtype."""
    named = dict(models.unet.named_parameters())
    with torch.no_grad():
        for n, t in zip(state.names, state.params if tensors is None else tensors):
            named[n].copy_(t)


@contextlib.contextmanager
def trained_weights(models: SVDModels, state: TrainState, cfg: TrainConfig):
    """The UNet as the finetune leaves it, inside the block: the adapter
    merged ('lora'), or the EMA copies in place of the masters' (full scope
    with use_ema); the masters are written back after."""
    if state.lora is not None:
        with lora_lib.merged(models.unet, state.lora, cfg.lora_alpha):
            yield
    elif state.ema_params is not None:
        _write_back(models, state, state.ema_params)
        try:
            yield
        finally:
            _write_back(models, state)
    else:
        yield


def run_validation(models: SVDModels, state: TrainState, args, cfg: TrainConfig,
                   step: int, logger, writer=None) -> None:
    """Generate videos from the validation image and save GIFs (reference
    train_svd.py:1092-1157), plus the quantitative metrics of utils/eval.py
    (CLIP frame score, temporal consistency, pixel dynamics) of the first
    into the writer."""
    device = models.unet.conv_in.weight.device
    if args.validation_image and os.path.exists(args.validation_image):
        try:
            from PIL import Image
        except ImportError:
            raise ImportError("--validation_image needs PIL (Pillow) to read the image; "
                              "leave it out for the synthetic image") from None
        img = Image.open(args.validation_image).convert("RGB").resize(
            (cfg.width, cfg.height), Image.Resampling.BICUBIC)
        image = torch.from_numpy(np.asarray(img, np.float32) / 127.5 - 1.0)[None]
    else:
        # the reference always validates (its bundled demo.jpg,
        # train_svd.py:1131): with no image given, a deterministic one
        logger.info("no --validation_image; using synthetic fallback image")
        image = _synthetic_validation_image(cfg.height, cfg.width)
    image = image.to(device)
    pipe_cfg = PipelineConfig(height=cfg.height, width=cfg.width,
                              num_frames=cfg.num_frames,
                              num_inference_steps=args.num_inference_steps,
                              fps_offset=0)   # training convention: raw fps
    out_dir = os.path.join(cfg.output_dir, "validation_images")
    os.makedirs(out_dir, exist_ok=True)
    with trained_weights(models, state, cfg):
        for i in range(max(1, args.num_validation_images)):
            gen = torch.Generator(device=device).manual_seed(step * 1000 + i)
            video = generate(models, image, pipe_cfg, generator=gen)
            frames = [((video[0, j] + 1) / 2).cpu().numpy() for j in range(video.shape[1])]
            suffix = f"_{i}" if args.num_validation_images > 1 else ""
            export_to_gif(frames, os.path.join(out_dir, f"val_img_{step}{suffix}.gif"))
            if writer is not None and i == 0:
                from ..utils.eval import video_metrics
                m = video_metrics(models, video, image)
                writer.write(step, {f"val/{k}": float(v) for k, v in m.items()})
    logger.info("validation GIF(s) saved at step %d", step)


def final_unet_state(models: SVDModels, state: TrainState, cfg: TrainConfig) -> dict:
    """The UNet the finetune leaves, uniformly f32 (the frozen tensors are
    stored in the compute dtype; upcasting is exact): the EMA or the masters
    where the scope trains, the merged weights in the 'lora' scope."""
    sd = {k: v.detach().float() for k, v in models.unet.state_dict().items()}
    if state.lora is not None:
        with torch.no_grad():
            for name, w in lora_lib.merge(models.unet, state.lora, cfg.lora_alpha).items():
                sd[f"{name}.weight"] = w.float()
    else:
        src = state.ema_params if state.ema_params is not None else state.params
        sd.update({n: t.detach().float() for n, t in zip(state.names, src)})
    return sd


def main(argv=None) -> dict:
    """Train as the flags say; returns what the run measured (host seconds
    of each step, of each checkpoint save and its bytes, of the restore, of
    each validation and of the export; the loader's seconds per batch and
    the time each next() blocked)."""
    args = parse_args(argv)
    cfg = build_train_config(args)
    check_one_card(args)
    cfg.check_ported()
    logger = get_logger()

    # preemption (the reference has none): flag on SIGTERM, checkpoint at
    # the next step boundary; registered first, restored on the way out
    preempted = {"flag": False}
    previous = signal.signal(signal.SIGTERM, lambda *_: preempted.__setitem__("flag", True))
    try:
        return _train(args, cfg, logger, preempted)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _train(args, cfg: TrainConfig, logger, preempted) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA card; --device cpu trains on the CPU")
    configs = ((TINY_UNET, TINY_VAE, TINY_CLIP) if args.tiny_model
               else (UNetConfig(), VAEConfig(), CLIPVisionConfig()))
    models = load_or_init_params(SVDModels.create(*configs, device=device), args)
    lora_gen = torch.Generator(device=device).manual_seed(derived_seed(cfg.seed, spawn_key=(1,)))
    state = create_train_state(cfg, models, generator=lora_gen)
    logger.info("%s scope on %s: %d trainable tensors, %d values", cfg.train_mode, device,
                len(state.names), sum(p.numel() for p in state.params))

    # param audit (reference params_freeze.txt / params_train.txt)
    if cfg.train_mode in ("full", "temporal"):
        frozen_names, train_names = param_audit(trainable_mask(models.unet, cfg.train_mode))
        os.makedirs(cfg.output_dir, exist_ok=True)
        with open(os.path.join(cfg.output_dir, "params_freeze.txt"), "w") as f:
            f.write("\n".join(frozen_names))
        with open(os.path.join(cfg.output_dir, "params_train.txt"), "w") as f:
            f.write("\n".join(train_names))

    if cfg.mixed_precision == "bf16":
        # every network stored in the compute dtype before the restore; the
        # state keeps the f32 masters
        cast_frozen_to_compute(models, torch.bfloat16)

    stats = {"step_seconds": [], "checkpoints": [], "restore_seconds": None,
             "validation_seconds": [], "export_seconds": None}
    manager = ckpt_lib.CheckpointManager(cfg.output_dir, cfg.checkpoints_total_limit)
    data_step = 0
    if cfg.resume_from_checkpoint:
        t0 = time.perf_counter()
        state, _, data_state = manager.restore(cfg.resume_from_checkpoint, state)
        if state.lora is None:
            _write_back(models, state)
        stats["restore_seconds"] = time.perf_counter() - t0
        data_step = int(data_state.get("step", state.step))
        logger.info("resumed at step %d (data step %d)", state.step, data_step)

    step_fn = make_train_step(models, cfg)
    schedule = training_schedule(cfg)
    dataset = FrameFolderDataset(cfg.base_folder, cfg.width, cfg.height, cfg.num_frames)
    stats["decoder"] = dataset.decoder
    accum = cfg.gradient_accumulation_steps
    local_bs = cfg.per_device_batch_size * accum
    loader = ShardedLoader(dataset, local_bs, seed=cfg.seed, start_step=data_step,
                           num_workers=cfg.num_workers)
    writer = MetricWriter(os.path.join(cfg.output_dir, "logs"), report_to=cfg.report_to)
    try:
        start = state.step
        t_last = time.perf_counter()
        last_logged = start
        for step in range(start, cfg.max_train_steps):
            if preempted["flag"]:
                manager.save(step, state, cfg, loader.state())
                logger.warning("preemption signal: checkpoint saved at step %d", step)
                break
            t0 = time.perf_counter()
            batch = torch.from_numpy(next(loader)).to(device)
            if accum > 1:
                batch = batch.reshape(accum, local_bs // accum, *batch.shape[1:])
            state, metrics = step_fn(state, batch,
                                     generator=step_generator(cfg.seed, step, device))
            stats["step_seconds"].append(time.perf_counter() - t0)

            if (step + 1) % 10 == 0 or step == start:
                now = time.perf_counter()
                # steps since the last log (the first window after a resume
                # can be shorter than 10)
                sps = (step + 1 - last_logged) / (now - t_last)
                last_logged, t_last = step + 1, now
                writer.write(step + 1, {"train_loss": metrics["loss"],
                                        "grad_norm": metrics["grad_norm"],
                                        "lr": float(schedule(step)),
                                        "steps_per_sec": sps})
                logger.info("step %d loss %.4f (%.2f steps/s)", step + 1, metrics["loss"], sps)

            if (step + 1) % cfg.checkpointing_steps == 0:
                t0 = time.perf_counter()
                path = manager.save(step + 1, state, cfg, loader.state())
                secs = time.perf_counter() - t0
                nbytes = os.path.getsize(os.path.join(path, "state", ckpt_lib.STATE_FILE))
                stats["checkpoints"].append({"step": step + 1, "seconds": secs,
                                             "bytes": nbytes})
                logger.info("checkpoint saved at step %d (%d bytes, %.2f s)", step + 1,
                            nbytes, secs)

            if (step + 1) % cfg.validation_steps == 0 or step == start:
                t0 = time.perf_counter()
                run_validation(models, state, args, cfg, step + 1, logger, writer=writer)
                stats["validation_seconds"].append(time.perf_counter() - t0)
    finally:
        loader.close()
        writer.close()
        stats["loader_batch_seconds"] = list(loader.batch_seconds)
        stats["loader_wait_seconds"] = list(loader.wait_seconds)
    manager.wait()

    # final export (reference train_svd.py:1166-1189)
    t0 = time.perf_counter()
    ckpt_lib.export_unet_diffusers(final_unet_state(models, state, cfg),
                                   os.path.join(cfg.output_dir, "unet"),
                                   config_json=models.unet.config.to_json())
    if state.lora is not None:
        ckpt_lib.export_lora_diffusers(state.lora, cfg.output_dir)
    stats["export_seconds"] = time.perf_counter() - t0
    logger.info("final model exported to %s", cfg.output_dir)
    if args.push_to_hub:
        # the reference uploads through huggingface_hub (train_svd.py:1182-1188)
        try:
            from huggingface_hub import HfApi
            api = HfApi()
            repo_id = args.hub_model_id or os.path.basename(cfg.output_dir)
            api.create_repo(repo_id, exist_ok=True)
            api.upload_folder(repo_id=repo_id, folder_path=cfg.output_dir)
            logger.info("pushed to hub: %s", repo_id)
        except Exception as e:  # machines without network
            logger.warning("hub upload failed/skipped: %s", e)
    return stats


if __name__ == "__main__":
    main()
