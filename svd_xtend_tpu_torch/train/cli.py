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

One card per process (``--device``, ``cuda`` by default; ``cpu`` runs the
kernels' plain versions), and data parallelism over the processes
``torchrun`` starts (``parallel/``):

  torchrun --nproc_per_node 4 -m svd_xtend_tpu_torch.train.cli --base_folder ./frames

``--mesh_data`` is the size of the data axis (-1: the ranks the model axis
leaves), each data index taking its rows of the global batch of
per_device_batch_size x data; ``--mesh_model`` the size of the 'model'
axis (tensor parallelism, ``parallel/tensor.py``: each rank of a model
group holds its part of the UNet's transformers; the world must hold data
x model ranks, laid out data outer; every scope, ``--use_8bit_adam``,
``--zero1`` and ``--host_offload`` run over it), and ``--attn_impl``
takes only ``auto``. Under a model axis every rank runs the validation
videos (rank 0 writes them) and the export gathers the UNet whole to rank
0 (the adapter file, whole on every rank, is written once).
``--zero1`` partitions the optimizer moments and the EMA over the ranks
(of each model index), ``--host_offload masters`` keeps the f32
masters in host memory and ``masters+moments`` the moments too (in the
'lora' scope the adapter's masters, its f32 compute copy staying on the
card). Rank 0 alone logs, validates and writes; a checkpoint holds
the same files at any world size (the partitioned state gathered to rank 0),
so a run resumes at another. ``--train_mode tracklet`` (or ``full`` with
``--tracklet_dim_full``) builds the UNet with the Tracklet2Video branch,
reads ``<video>/boxes.npz`` with ``--max_boxes`` slots, and writes the
branch as ``tracklet_weights.safetensors`` beside the UNet export.
Each step's draws come from a generator on the step's device seeded from
(seed, step) alone (the JAX step folds the step into one key), so a resumed
run draws what a straight run draws and the checkpoint holds no generator.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import (TINY_CLIP, TINY_UNET, TINY_VAE, CLIPVisionConfig, MeshConfig,
                           PipelineConfig, TrainConfig, UNetConfig, VAEConfig)
from ..data.dataset import FrameFolderDataset, ShardedLoader
from ..diffusion.pipeline import SVDModels, generate, init_random_
from ..io.media import export_to_gif
from ..models import lora as lora_lib
from ..models.unet import UNetSpatioTemporalConditionModel
from ..parallel import (broadcast_from_owners_, close_world, comm_device, env_world,
                        gather_to_main, init_world)
from ..parallel.tensor import layout
from ..train import checkpoint as ckpt_lib
from ..train.optim import training_schedule
from ..train.state import (TrainState, cast_frozen_to_compute, create_train_state,
                           make_train_step, param_audit, trainable_mask, write_back)
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
    # Tracklet2Video: 'tracklet' mode trains only the box-conditioning branch
    # on videos with <video>/boxes.npz annotations (boxes (T,N,4) normalized
    # xyxy [+ mask])
    p.add_argument("--tracklet_dim", type=int, default=1024,
                   help="box-token width (used when --train_mode tracklet)")
    p.add_argument("--tracklet_dim_full", action="store_true",
                   help="with --train_mode full: also build + train the "
                        "tracklet branch at --tracklet_dim")
    p.add_argument("--tracklet_gate_init", type=float, default=0.0,
                   help="GLIGEN gate init (0 = exact no-op at init; warm "
                        ">0 for joint from-scratch training)")
    p.add_argument("--max_boxes", type=int, default=16,
                   help="per-frame box slots (padding/truncation)")
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
                   help="blockwise-int8 Adam moments (reference bitsandbytes "
                        "AdamW8bit, train_svd.py:746-756)")
    p.add_argument("--host_offload",
                   choices=["none", "masters", "masters+moments"],
                   default="none",
                   help="the f32 masters (and the moments) in host memory, streamed "
                        "through the card for the update")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: the optimizer moments and the EMA partitioned over the "
                        "data-parallel ranks")
    p.add_argument("--conditioning_dropout_prob", type=float, default=0.1)
    p.add_argument("--p_mean", type=float, default=0.7,
                   help="EDM sigma-sampling log-mean (train_svd.py:1014)")
    p.add_argument("--p_std", type=float, default=1.6,
                   help="EDM sigma-sampling log-std (train_svd.py:1014)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--mixed_precision", choices=["no", "bf16"], default="bf16")
    p.add_argument("--grad_dtype", choices=["fp32", "bf16"], default="fp32",
                   help="gradient storage dtype: bf16 differentiates bf16 copies of the "
                        "trained weights and applies bf16 gradients to the f32 masters")
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
    # mesh: the data-parallel ranks (-1: all of torchrun's); no model axis
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


def check_mesh(args) -> None:
    """Refuse a mesh the world torchrun started does not hold, before any
    work: data x model must be its ranks."""
    size = env_world().size
    if args.mesh_model < 1 or size % args.mesh_model:
        raise ValueError(f"--mesh_model {args.mesh_model}: the world has {size} rank(s) "
                         "(torchrun --nproc_per_node sets it)")
    if args.mesh_data not in (-1, size // args.mesh_model):
        raise ValueError(f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model}: the "
                         f"world has {size} rank(s) (torchrun --nproc_per_node sets it; -1 "
                         "takes the ranks the model axis leaves)")
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
    whole = models
    if models.tp is not None:
        # a model rank initialises and loads the whole UNet, then keeps its part
        with torch.device(device):
            unet = UNetSpatioTemporalConditionModel(models.unet.config)
        whole = dataclasses.replace(models, unet=unet.to(models.dtype))
    for net in (whole.unet, whole.vae, whole.clip):
        init_random_(net, gen)
    if args.pretrained_model_path:
        from ..io import convert
        convert.load_diffusers_checkpoint(args.pretrained_model_path, whole)
    if args.pretrain_unet:
        from ..io import convert
        convert.load_unet_state(whole.unet,
                                convert.load_component_state(args.pretrain_unet, UNET_FILE))
    if models.tp is not None:
        models.load_unet_whole(whole.unet.state_dict())
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


@contextlib.contextmanager
def trained_weights(models: SVDModels, state: TrainState, cfg: TrainConfig, ema=None):
    """The UNet as the finetune leaves it, inside the block: the adapter
    merged ('lora'), or the EMA copies (`ema`, else the state's) in place of
    the masters' (full scope with use_ema); the masters are written back
    after."""
    ema = state.ema_params if ema is None else ema
    if state.lora is not None:
        with lora_lib.merged(models.unet, state.lora, cfg.lora_alpha):
            yield
    elif ema is not None:
        write_back(models, cfg, state, ema)
        try:
            yield
        finally:
            write_back(models, cfg, state)
    else:
        yield


def run_validation(models: SVDModels, state: TrainState, args, cfg: TrainConfig,
                   step: int, logger, writer=None, ema=None, write: bool = True) -> None:
    """Generate videos from the validation image and save GIFs (reference
    train_svd.py:1092-1157), plus the quantitative metrics of utils/eval.py
    (CLIP frame score, temporal consistency, pixel dynamics) of the first
    into the writer. With `write` False (a model rank other than 0, which
    takes part in the videos) nothing is saved or logged."""
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
    if write:
        os.makedirs(out_dir, exist_ok=True)
    with trained_weights(models, state, cfg, ema):
        for i in range(max(1, args.num_validation_images)):
            gen = torch.Generator(device=device).manual_seed(step * 1000 + i)
            video = generate(models, image, pipe_cfg, generator=gen)
            if not write:
                continue
            frames = [((video[0, j] + 1) / 2).cpu().numpy() for j in range(video.shape[1])]
            suffix = f"_{i}" if args.num_validation_images > 1 else ""
            export_to_gif(frames, os.path.join(out_dir, f"val_img_{step}{suffix}.gif"))
            if writer is not None and i == 0:
                from ..utils.eval import video_metrics
                m = video_metrics(models, video, image)
                writer.write(step, {f"val/{k}": float(v) for k, v in m.items()})
    if write:
        logger.info("validation GIF(s) saved at step %d", step)


def final_unet_state(models: SVDModels, state: TrainState, cfg: TrainConfig,
                     ema=None) -> dict:
    """The UNet the finetune leaves, uniformly f32 (the frozen tensors are
    stored in the compute dtype; upcasting is exact): the EMA (`ema`, the
    whole EMA under ZeRO-1, else the state's) or the masters where the scope
    trains, the merged weights in the 'lora' scope."""
    sd = {k: v.detach().float() for k, v in models.unet.state_dict().items()}
    if state.lora is not None:
        with torch.no_grad():
            for name, w in lora_lib.merge(models.unet, state.lora, cfg.lora_alpha).items():
                sd[f"{name}.weight"] = w.float()
    else:
        ema = state.ema_params if ema is None else ema
        src = ema if ema is not None else state.params
        sd.update({n: t.detach().float() for n, t in zip(state.names, src)})
    return sd


def whole_final_unet_state(models: SVDModels, state: TrainState, cfg: TrainConfig,
                           world) -> Optional[dict]:
    """``final_unet_state`` on a model axis: every rank's parts of the UNet
    (in the 'lora' scope with its slice of the adapter merged) and of the
    state gathered to rank 0 and joined whole (every rank calls it; None on
    the other ranks)."""
    whole_state = state.state_dict()
    first = world.data_index == 0 and world.frames_index == 0
    mine = None
    if first:
        mine = {k: v.detach().cpu() for k, v in models.unet.state_dict().items()}
        if state.lora is not None:
            with torch.no_grad():
                for name, w in lora_lib.merge(models.unet, state.lora, cfg.lora_alpha).items():
                    mine[f"{name}.weight"] = w.cpu()
    parts = gather_to_main(mine, world)
    if parts is None:
        return None
    by_model = [parts[(m * world.frames)] for m in range(world.model)]
    sd = {}
    for k, v in by_model[0].items():
        lay = layout(k, models.unet.config, world.model)
        sd[k] = (v if lay is None else lay.unshard([p[k] for p in by_model])).float()
    if state.lora is None:
        src = whole_state["ema_params"] or whole_state["params"]
        sd.update({n: t.float() for n, t in src.items()})
    return sd


def to_device(batch, device, accum: int):
    """A loader batch (numpy pixels, or a dict of numpy arrays with boxes) as
    tensors on `device`, split into (accum, B / accum, ...) when
    accumulating."""
    def one(a):
        t = torch.from_numpy(a).to(device)
        return t.reshape(accum, t.shape[0] // accum, *t.shape[1:]) if accum > 1 else t
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def main(argv=None) -> dict:
    """Train as the flags say; returns what the run measured (host seconds
    of each step; of each checkpoint save, the seconds it held the loop,
    its snapshot's copies and its writer took, and its bytes
    (``CheckpointManager.saves``); of the restore, of
    each validation and of the export; the loader's seconds per batch and
    the time each next() blocked)."""
    args = parse_args(argv)
    cfg = build_train_config(args)
    cfg.check_ported()
    check_mesh(args)
    logger = get_logger()

    # preemption (the reference has none): flag on SIGTERM, checkpoint at
    # the next step boundary; registered first, restored on the way out
    preempted = {"flag": False}
    previous = signal.signal(signal.SIGTERM, lambda *_: preempted.__setitem__("flag", True))
    started = not (dist.is_available() and dist.is_initialized())
    world = init_world(torch.device(args.device).type, cfg.mesh)
    try:
        return _train(args, cfg, logger, preempted, world)
    finally:
        signal.signal(signal.SIGTERM, previous)
        if started:
            close_world(world)


def _agreed(flag: bool, world, device: torch.device) -> bool:
    """Whether any rank raised `flag` (every rank stops at the same step)."""
    if world.size == 1:
        return flag
    t = torch.tensor([float(flag)], device=comm_device(device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def full_ema(state: TrainState):
    """Every trainable tensor's EMA copy on the EMA's device, for rank 0's
    validation and export (``TrainState.whole_ema``: every rank must call
    it; None on the other ranks under ZeRO-1). On a model axis, where every
    rank validates, this rank's parts of every tensor's EMA, broadcast from
    their ZeRO-1 owners within its model index."""
    if state.layouts is not None and state.ema_params is not None and state.optimizer.gathers:
        ema = [e if e is not None else torch.zeros_like(p, device=state.optimizer.device)
               for e, p in zip(state.ema_params, state.params)]
        broadcast_from_owners_(ema, state.optimizer.owner, state.optimizer.world,
                               state.optimizer.device)
        return ema
    if state.layouts is not None:
        return state.ema_params
    ema = state.whole_ema()
    if ema is None or ema is state.ema_params:
        return ema
    return [t.to(state.optimizer.device) for t in ema]


def _train(args, cfg: TrainConfig, logger, preempted, world) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA card; --device cpu trains on the CPU")
    if device.type == "cuda" and world.collective:
        device = torch.device("cuda", world.local_rank)
    if not world.main:
        logger.setLevel("WARNING")
    unet_cfg, vae_cfg, clip_cfg = ((TINY_UNET, TINY_VAE, TINY_CLIP) if args.tiny_model
                                   else (UNetConfig(), VAEConfig(), CLIPVisionConfig()))
    if cfg.tracklet_dim > 0:
        # the branch of SVDModels.with_tracklet, initialised with the rest
        unet_cfg = dataclasses.replace(unet_cfg, tracklet_dim=cfg.tracklet_dim,
                                       tracklet_gate_init=cfg.tracklet_gate_init)
    models = load_or_init_params(SVDModels.create(unet_cfg, vae_cfg, clip_cfg, device=device,
                                                  tp=world.tensor_shard()), args)
    lora_gen = torch.Generator(device=device).manual_seed(derived_seed(cfg.seed, spawn_key=(1,)))
    state = create_train_state(cfg, models, generator=lora_gen, world=world)
    logger.info("%s scope on %s: %d trainable tensors, %d values", cfg.train_mode, device,
                len(state.names), sum(p.numel() for p in state.params))

    # param audit (reference params_freeze.txt / params_train.txt)
    if world.main and cfg.train_mode in ("full", "temporal", "tracklet"):
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
             "validation_seconds": [], "export_seconds": None, "world_size": world.size,
             "streamed_bytes": []}
    manager = ckpt_lib.CheckpointManager(cfg.output_dir, cfg.checkpoints_total_limit,
                                         world=world)
    data_step = 0
    if cfg.resume_from_checkpoint:
        t0 = time.perf_counter()
        state, _, data_state = manager.restore(cfg.resume_from_checkpoint, state)
        write_back(models, cfg, state)
        stats["restore_seconds"] = time.perf_counter() - t0
        data_step = int(data_state.get("step", state.step))
        logger.info("resumed at step %d (data step %d)", state.step, data_step)

    step_fn = make_train_step(models, cfg, world)
    schedule = training_schedule(cfg)
    dataset = FrameFolderDataset(cfg.base_folder, cfg.width, cfg.height, cfg.num_frames,
                                 max_boxes=cfg.max_boxes if cfg.tracklet_dim > 0 else 0)
    stats["decoder"] = dataset.decoder
    accum = cfg.gradient_accumulation_steps
    local_bs = cfg.per_device_batch_size * accum
    # every model rank of a data index takes the same rows
    loader = ShardedLoader(dataset, local_bs, seed=cfg.seed, start_step=data_step,
                           num_workers=cfg.num_workers, process_index=world.data_index,
                           process_count=world.data)
    writer = (MetricWriter(os.path.join(cfg.output_dir, "logs"), report_to=cfg.report_to)
              if world.main else None)
    try:
        start = state.step
        t_last = time.perf_counter()
        last_logged = start
        for step in range(start, cfg.max_train_steps):
            if _agreed(preempted["flag"], world, device):
                manager.save(step, state, cfg, loader.state(), blocking=True)
                logger.warning("preemption signal: checkpoint saved at step %d", step)
                break
            t0 = time.perf_counter()
            batch = to_device(next(loader), device, accum)
            state, metrics = step_fn(state, batch,
                                     generator=step_generator(cfg.seed, step, device))
            stats["step_seconds"].append(time.perf_counter() - t0)
            stats["streamed_bytes"].append(state.optimizer.streamed_bytes)

            if world.main and ((step + 1) % 10 == 0 or step == start):
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
                # asynchronous, but the last step's save is waited for
                manager.save(step + 1, state, cfg, loader.state(),
                             blocking=step + 1 == cfg.max_train_steps)
                logger.info("checkpoint saved at step %d", step + 1)

            if (step + 1) % cfg.validation_steps == 0 or step == start:
                ema = full_ema(state)
                if world.main or world.model > 1:
                    t0 = time.perf_counter()
                    run_validation(models, state, args, cfg, step + 1, logger, writer=writer,
                                   ema=ema, write=world.main)
                    stats["validation_seconds"].append(time.perf_counter() - t0)
    finally:
        loader.close()
        if writer is not None:
            writer.close()
        stats["loader_batch_seconds"] = list(loader.batch_seconds)
        stats["loader_wait_seconds"] = list(loader.wait_seconds)
    manager.wait()
    stats["checkpoints"] = [dict(c) for c in manager.saves]
    if world.model > 1:
        final = whole_final_unet_state(models, state, cfg, world)
    else:
        ema = full_ema(state)
        final = final_unet_state(models, state, cfg, ema) if world.main else None
    if not world.main:
        return stats

    # final export (reference train_svd.py:1166-1189)
    t0 = time.perf_counter()
    ckpt_lib.export_unet_diffusers(final, os.path.join(cfg.output_dir, "unet"),
                                   config_json=models.unet.config.to_json())
    if state.lora is not None:
        ckpt_lib.export_lora_diffusers(state.lora, cfg.output_dir)
    if cfg.tracklet_dim > 0:
        # the branch alone (the diffusers export above leaves it out), for
        # any scope that carries it
        ckpt_lib.export_tracklet(final, cfg.output_dir)
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
