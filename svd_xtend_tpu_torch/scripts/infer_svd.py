"""img2vid inference: the port of the JAX package's ``examples/infer_svd.py``
(the reference's infer_svd.ipynb cells 0-2).

    python -m svd_xtend_tpu_torch.scripts.infer_svd --image demo.jpg \\
        --model_path ./svd-checkpoint [--unet_path ./outputs/unet] \\
        [--width 1024 --height 576] [--num_frames 14 --steps 30] \\
        [--lora_path ./outputs] [--out generated.mp4] [--device cuda]

Load the pipeline (seeded random weights, then a diffusers pipeline
directory where given), a finetuned UNet, a Tracklet2Video branch and a
LoRA adapter (merged into the UNet), in that order; generate 14 frames at
1024x576 with 30 Euler steps, decode chunks of 8, motion bucket 127, fps 8;
write the mp4 at 7 fps and a GIF beside it. Every flag and default is the
JAX script's; ``--device`` (``cuda`` by default, without a card it raises;
``cpu`` runs the kernels' plain versions) is the port's.

Tracklet2Video: ``--boxes '[[x1,y1,x2,y2],...]'`` (boxes in [0, 1], the
same in every frame) and/or ``--tracklet_path`` (a directory holding the
``tracklet_weights.safetensors`` of ``train.cli --train_mode tracklet``,
JAX's or the port's) build the UNet with the branch at ``--tracklet_dim``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

UNET_FILE = "diffusion_pytorch_model.safetensors"
LORA_FILE = "pytorch_lora_weights.safetensors"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="SVD img2vid inference (PyTorch port)")
    p.add_argument("--image", required=True)
    p.add_argument("--model_path", default="",
                   help="diffusers-format pipeline dir (unet/vae/image_encoder)")
    p.add_argument("--unet_path", default="", help="override UNet weights dir")
    p.add_argument("--lora_path", default="", help="pytorch_lora_weights dir")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--motion_bucket_id", type=int, default=127)
    p.add_argument("--noise_aug_strength", type=float, default=0.02)
    p.add_argument("--decode_chunk_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--out", default="generated.mp4")
    p.add_argument("--boxes", default="", help="JSON [[x1,y1,x2,y2],...] in [0,1]")
    p.add_argument("--tracklet_path", default="",
                   help="dir with tracklet_weights.safetensors "
                        "(cli --train_mode tracklet output)")
    p.add_argument("--tracklet_dim", type=int, default=1024,
                   help="box-token width the branch was trained with")
    p.add_argument("--device", default="cuda",
                   help="the card ('cuda', the default) or 'cpu' (the kernels' plain versions)")
    return p.parse_args(argv)


def load_image(path: str, width: int, height: int) -> torch.Tensor:
    """(1, H, W, 3) f32 in [-1, 1]: PIL, RGB, bicubic resize, as the JAX
    script reads it."""
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((width, height), Image.Resampling.BICUBIC)
    return torch.from_numpy(np.asarray(img, np.float32) / 127.5 - 1.0)[None]


def static_boxes(spec: str, num_frames: int):
    """``--boxes`` JSON (N, 4) -> boxes (1, F, N, 4) and an all-ones mask
    (1, F, N), f32: the same boxes in every frame."""
    raw = torch.tensor(json.loads(spec), dtype=torch.float32)
    if raw.dim() != 2 or raw.shape[1] != 4:
        raise ValueError(f"--boxes must be a JSON list of [x1, y1, x2, y2]; got {spec!r}")
    boxes = raw[None, None].expand(1, num_frames, *raw.shape).contiguous()
    return boxes, torch.ones(boxes.shape[:3])


def load_models(args, models=None):
    """The pipeline as the flags ask: `models`, or bf16 networks on
    --device with seeded random weights (seed 0, the JAX script's key);
    then --model_path, --unet_path, the tracklet branch and the LoRA merge."""
    from ..core.config import UNetConfig
    from ..diffusion.pipeline import SVDModels
    from ..io import convert
    from ..io.safetensors_io import load_file
    from ..models import lora
    from ..train.checkpoint import TRACKLET_FILE

    tracklet = bool(args.tracklet_path or args.boxes)
    if models is None:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA card; --device cpu runs on the CPU")
        unet_cfg = UNetConfig(tracklet_dim=args.tracklet_dim if tracklet else 0)
        models = SVDModels.create(unet_cfg, device=device, dtype=torch.bfloat16,
                                  generator=torch.Generator(device).manual_seed(0))
    elif tracklet and models.unet.tracklet_conditioner is None:
        models = models.with_tracklet(args.tracklet_dim)
    if args.model_path:
        convert.load_diffusers_checkpoint(args.model_path, models)
    if args.unet_path:
        convert.load_unet_state(models.unet,
                                convert.load_component_state(args.unet_path, UNET_FILE))
    if args.tracklet_path:
        convert.tracklet_branch_into_unet(
            load_file(os.path.join(args.tracklet_path, TRACKLET_FILE)), models.unet)
    if args.lora_path:
        template = lora.init(models.unet)
        adapter = convert.lora_from_state_dict(
            load_file(os.path.join(args.lora_path, LORA_FILE)), template)
        lora.merge_(models.unet, adapter)
    return models


def main(argv=None, models=None) -> dict:
    """Generate and write the video as the flags say; `models` replaces the
    default networks (the tests pass TINY ones). Returns the video (1, F,
    H, W, 3) in [-1, 1] on the host and the files written."""
    from ..core.config import PipelineConfig
    from ..diffusion.pipeline import generate
    from ..io.media import export_to_gif, export_to_video

    args = parse_args(argv)
    models = load_models(args, models)
    device = models.unet.conv_in.weight.device
    image = load_image(args.image, args.width, args.height).to(device)
    cfg = PipelineConfig(height=args.height, width=args.width, num_frames=args.num_frames,
                         num_inference_steps=args.steps, fps=args.fps,
                         motion_bucket_id=args.motion_bucket_id,
                         noise_aug_strength=args.noise_aug_strength,
                         decode_chunk_size=args.decode_chunk_size)
    boxes = mask = None
    if args.boxes:
        boxes, mask = (t.to(device) for t in static_boxes(args.boxes, args.num_frames))
    video = generate(models, image, cfg, generator=torch.Generator(device).manual_seed(args.seed),
                     boxes=boxes, box_mask=mask).cpu()
    frames = [((video[0, i] + 1) / 2).numpy() for i in range(args.num_frames)]
    gif = args.out.replace(".mp4", ".gif")
    export_to_video(frames, args.out, fps=7)
    export_to_gif(frames, gif)
    print(f"wrote {args.out} ({args.num_frames} frames, {args.width}x{args.height})")
    return {"video": video, "mp4": args.out, "gif": gif}


if __name__ == "__main__":
    main()
